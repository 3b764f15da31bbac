"""Tilted and warped disks through the port's plain loop against the JAX
package's XLA recorder.

The same rays, made with numpy from a seed, go through both packages'
disk traces on the CPU. Tolerances: float64, statuses and hit counts
equal and r, phi and xi (the angular momentum about the disk normal)
within 1e-9 relative (the packages' float64 sin, cos, atan2 and pow
round alike to a few ulp); float32, the tiers of
tests/test_torch_disk.py (hit counts agreeing on > 98 % of rays, the
median |d r| of rays hit in both < 1e-3 M). The bases are the same
numbers (disk_basis bitwise, the warp to 1e-14). The renders: a tilt of
0 is the equatorial render bitwise; Schwarzschild's tilted disk is the
equatorial one seen from the rotated inclination (the JAX package's
oracle at its 36x48 and its bounds); the warp's limits reproduce the flat tilted and the
equatorial planes (the JAX test's bounds); a 16x16 tilted render from
float64 traces equals JAX's within 1e-6 (the image is float32, as in
tests/test_torch_disk.py).
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
DISKS = {"tilt": dict(tilt=0.5, tilt_azimuth=0.7),
         "warp": dict(tilt=0.5, tilt_azimuth=-1.1, warp_radius=9.0,
                      opaque=False, max_hits=3)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n=64, seed=14):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.01, 0.12, n), rng.uniform(-np.pi, np.pi, n)


def _trace_both(dtype, cfg, n=64, **kw):
    al, th = _rays(n)
    rj = jdisk.trace_disk_rays(
        JKerr(M=1.0, a=0.9), R_OBS, jnp.asarray(al, dtype),
        jnp.asarray(th, dtype), THETA, 5000.0, 3000,
        jdisk.DiskConfig(**cfg), **kw)
    tdt = getattr(torch, dtype)
    rt = disk.trace_disk_rays(
        Kerr(M=1.0, a=0.9), R_OBS, torch.tensor(al, dtype=tdt),
        torch.tensor(th, dtype=tdt), THETA, 5000.0, 3000,
        disk.DiskConfig(**cfg), two_pass=False, **kw)
    return rj, rt


def _slots(res, field):
    return np.stack([np.asarray(x, np.float64) for x in getattr(res, field)])


@pytest.mark.parametrize("kind", ["tilt", "warp"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tilted_trace_matches_jax(kind, dtype):
    rj, rt = _trace_both(dtype, DISKS[kind], record_momentum=kind == "warp")
    nj, nt = np.asarray(rj.n_hits), rt.n_hits.numpy()
    assert len(rt.xi_hits) == len(rj.xi_hits) > 0
    if dtype == "float64":
        np.testing.assert_array_equal(rt.status.numpy(),
                                      np.asarray(rj.status))
        np.testing.assert_array_equal(nt, nj)
        fields = ("r_hits", "phi_hits", "xi_hits") + (
            ("pr_hits", "pth_hits") if kind == "warp" else ())
        for field in fields:
            a, b = _slots(rt, field), _slots(rj, field)
            np.testing.assert_allclose(a, b, rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max())
    else:
        assert (nt == nj).mean() > 0.98
        both = (nt > 0) & (nj > 0)
        dr = np.abs(_slots(rt, "r_hits")[0] - _slots(rj, "r_hits")[0])
        assert np.median(dr[both]) < 1e-3


def test_bases_match_jax():
    for tilt, lam in ((0.3, 0.0), (0.7, 2.1), (-0.4, -0.9)):
        assert disk.disk_basis(tilt, lam) == jdisk.disk_basis(tilt, lam)
    r = np.array([0.5, 3.0, 9.0, 40.0, 1e4])
    bj = jdisk.warped_basis(0.5, 0.7, 9.0)(jnp.asarray(r))
    bt = disk.warped_basis(0.5, 0.7, 9.0)(torch.tensor(r))
    for vj, vt in zip(bj, bt):
        for cj, ct in zip(vj, vt):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                       rtol=0, atol=1e-14)


def _scene(**kw):
    base = dict(M=1.0, a=0.9, r_obs_mult=R_OBS, vertical_fov_deg=30.0,
                theta_obs=THETA)
    base.update(kw)
    return SceneConfig(**base)


F64 = RenderConfig(dtype="float64")


def test_tilt_zero_is_the_equatorial_render():
    img_eq, _ = disk.render_disk(_scene(), (16, 24), F64, disk.DiskConfig(),
                                 device="cpu")
    img_0, _ = disk.render_disk(_scene(), (16, 24), F64,
                                disk.DiskConfig(tilt=0.0), device="cpu")
    img_t, st = disk.render_disk(_scene(), (16, 24), F64,
                                 disk.DiskConfig(tilt=np.radians(20.0)),
                                 device="cpu")
    assert torch.equal(img_eq, img_0)
    assert st["disk_pixels"] > 20 and bool(torch.isfinite(img_t).all())
    assert float((img_t - img_eq).abs().max()) > 0.05


def test_schwarzschild_rotation_equivalence():
    """a = 0: a disk tilted by iota about a line of nodes at pi/2 seen from
    theta_obs is the equatorial disk seen from theta_obs - iota (the JAX
    package's oracle at its size and bounds)."""
    iota, theta_obs = np.radians(12.0), np.radians(75.0)
    img_t, st = disk.render_disk(
        _scene(a=0.0, theta_obs=theta_obs), (36, 48), F64,
        disk.DiskConfig(tilt=iota, tilt_azimuth=np.pi / 2), device="cpu")
    img_r, _ = disk.render_disk(
        _scene(a=0.0, theta_obs=theta_obs - iota), (36, 48), F64,
        disk.DiskConfig(), device="cpu")
    assert st["disk_pixels"] > 50
    d = (img_t - img_r).abs().numpy()
    assert (d < 1e-3).mean() > 0.97 and np.median(d) < 1e-6
    assert d.max() < 0.05


def test_warp_limits():
    tilt = np.radians(25.0)
    flat, _ = disk.render_disk(_scene(), (16, 24), F64,
                               disk.DiskConfig(tilt=tilt), device="cpu")
    w0, _ = disk.render_disk(_scene(), (16, 24), F64,
                             disk.DiskConfig(tilt=tilt, warp_radius=1e-6),
                             device="cpu")
    assert ((w0 - flat).abs() < 1e-3).float().mean() > 0.99
    eq, _ = disk.render_disk(_scene(), (16, 24), F64, disk.DiskConfig(),
                             device="cpu")
    winf, _ = disk.render_disk(_scene(), (16, 24), F64,
                               disk.DiskConfig(tilt=tilt, warp_radius=1e5),
                               device="cpu")
    assert ((winf - eq).abs() < 1e-2).float().mean() > 0.95


def test_tilted_render_matches_jax():
    js = JScene(M=1.0, a=0.9, r_obs_mult=R_OBS, vertical_fov_deg=30.0,
                theta_obs=THETA)
    jcfg = JRender(dtype="float64", backend="xla")
    dj = jdisk.DiskConfig(tilt=0.35, tilt_azimuth=0.4, spectrum="blackbody")
    ij, sj = jdisk.render_disk(js, (16, 16), jcfg, dj)
    it, st = disk.render_disk(scene_from_jax(js), (16, 16),
                              render_cfg_from_jax(jcfg),
                              disk.DiskConfig(tilt=0.35, tilt_azimuth=0.4,
                                              spectrum="blackbody"),
                              device="cpu")
    assert st["disk_pixels"] == sj["disk_pixels"] > 0
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0,
                               atol=1e-6)
