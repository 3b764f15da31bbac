"""Several disk planes in one trace (render_multi_disk, the recorder's
extra_disks) through the port's plain loop against the JAX package.

The same rays, made with numpy from a seed, go through both packages on
the CPU. Tolerances: float64, statuses and every plane's hit counts
equal, r, phi and xi within 1e-9 relative; the 16x16 render from
float64 traces within 1e-6 of JAX's (the image is float32, as in
tests/test_torch_disk.py). The port's own checks are the JAX tests': the
single-plane limit is render_disk bitwise, an empty second plane changes
nothing, an opaque near plane occludes a far one, and mixed spectra
raise ValueError.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import (RenderConfig as JRender,
                                                SceneConfig as JScene)
from light_path_tracer_tpu_torch import disk
from light_path_tracer_tpu_torch.convert import (render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr
from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                      SceneConfig)

R_OBS = 100.0
THETA = float(np.radians(80.0))
PAIRS = {
    "opaque": (dict(r_out=10.0), dict(r_in=12.0, r_out=20.0, tilt=0.44)),
    "translucent": (dict(opaque=False, max_hits=3),
                    dict(r_in=3.0, r_out=15.0, tilt=0.7, tilt_azimuth=0.3,
                         opaque=False)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("pair", ["opaque", "translucent"])
def test_multi_trace_matches_jax(pair):
    rng = np.random.default_rng(15)
    al, th = rng.uniform(0.01, 0.12, 48), rng.uniform(-np.pi, np.pi, 48)
    cfgs = PAIRS[pair]
    rj = jdisk.trace_disk_rays_multi(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al), jnp.asarray(th), THETA,
        5000.0, 3000, [jdisk.DiskConfig(**c) for c in cfgs])
    rt = disk.trace_disk_rays_multi(
        Kerr(M=1.0, a=0.9), R_OBS, torch.tensor(al), torch.tensor(th),
        THETA, 5000.0, 3000, [disk.DiskConfig(**c) for c in cfgs],
        two_pass=False)
    assert len(rt) == len(rj) == 2
    np.testing.assert_array_equal(rt[0].status.numpy(),
                                  np.asarray(rj[0].status))
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.n_hits.numpy(), np.asarray(b.n_hits))
        assert len(a.xi_hits) == len(b.xi_hits)
        for field in ("r_hits", "phi_hits", "xi_hits"):
            for x, y in zip(getattr(a, field), getattr(b, field)):
                y = np.asarray(y)
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-9,
                                           atol=1e-9 * np.abs(y).max())
    assert all(int((a.n_hits > 0).sum()) > 0 for a in rt)


def _scene():
    return SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA)


F64 = RenderConfig(dtype="float64")


def test_single_plane_limit_and_empty_second_plane():
    img1, st1 = disk.render_disk(_scene(), (12, 16), F64, disk.DiskConfig(),
                                 device="cpu")
    img_m, st_m = disk.render_multi_disk(_scene(), (12, 16), F64,
                                         [disk.DiskConfig()], device="cpu")
    assert torch.equal(img1, img_m)
    assert st_m["disk_pixels"] == st1["disk_pixels"] and st_m["n_disks"] == 1
    inner = disk.DiskConfig(r_out=10.0)
    empty = disk.DiskConfig(r_in=8.0, r_out=7.0, opaque=False)
    img_e, st_e = disk.render_multi_disk(_scene(), (12, 16), F64,
                                         [inner, empty], device="cpu")
    img_1, _ = disk.render_multi_disk(_scene(), (12, 16), F64, [inner],
                                      device="cpu")
    assert st_e["disk_pixels_per_plane"][1] == 0
    torch.testing.assert_close(img_e, img_1, rtol=0, atol=1e-12)


def test_opaque_plane_occludes_the_far_plane():
    near = disk.DiskConfig(r_out=15.0, opaque=True)
    far = disk.DiskConfig(r_in=3.0, r_out=15.0, tilt=np.radians(40.0),
                          opaque=False)
    _i, both = disk.render_multi_disk(_scene(), (12, 16), F64, [near, far],
                                      device="cpu")
    _i, alone = disk.render_multi_disk(_scene(), (12, 16), F64, [far],
                                       device="cpu")
    assert both["disk_pixels_per_plane"][1] < alone["disk_pixels_per_plane"][0]


def test_multi_disk_validates_mixed_spectra():
    with pytest.raises(ValueError, match="spectrum"):
        disk.render_multi_disk(_scene(), (4, 4), F64,
                               [disk.DiskConfig(),
                                disk.DiskConfig(spectrum="blackbody")],
                               device="cpu")
    with pytest.raises(ValueError, match="tone_map"):
        disk.render_multi_disk(_scene(), (4, 4), F64,
                               [disk.DiskConfig(),
                                disk.DiskConfig(tone_map="linear")],
                               device="cpu")


def test_two_plane_render_matches_jax():
    js = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA)
    jcfg = JRender(dtype="float64", backend="xla")
    cfgs = PAIRS["opaque"]
    ij, sj = jdisk.render_multi_disk(js, (16, 16), jcfg,
                                     [jdisk.DiskConfig(**c) for c in cfgs])
    it, st = disk.render_multi_disk(scene_from_jax(js), (16, 16),
                                    render_cfg_from_jax(jcfg),
                                    [disk.DiskConfig(**c) for c in cfgs],
                                    device="cpu")
    assert st["disk_pixels_per_plane"] == sj["disk_pixels_per_plane"]
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0,
                               atol=1e-6)
