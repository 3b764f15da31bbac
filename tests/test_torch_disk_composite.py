"""The port's composite of the lensed background with the accretion disk
against the JAX package: render_scene_with_disk (opaque and translucent,
RGB and gray backgrounds, power-law and blackbody disks),
composite_gamma_encode and render_scene_with_disk_aa, stacked and looped.

The same scenes and numpy-seeded backgrounds go through the JAX package's
XLA path and the port's plain loops on the CPU. Criteria: float64 images
max |d| < 1e-6 and equal disk masks and captured counts; float32 disk
masks agree on >= 99 % of pixels and the median |d| on disk pixels
< 1e-3; the stacked composite AA equal to its per-offset loop (the JAX
package's own test), and one ray's result independent of how the passes
are grouped into traces (bitwise).
"""

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import aa, disk
from light_path_tracer_tpu_torch.convert import (disk_config_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)

THETA = float(np.radians(80.0))
DIM = (16, 16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(**kw):
    return JScene(M=1.0, a=0.9, r_obs_mult=100.0, theta_obs=THETA,
                  vertical_fov_deg=30.0, **kw)


def _both(dtype):
    jcfg = JRender(dtype=dtype, backend="xla")
    return jcfg, render_cfg_from_jax(jcfg)


def _background(dim, seed=7):
    return np.random.default_rng(seed).integers(0, 256, dim + (3,),
                                                dtype=np.uint8)


@pytest.mark.parametrize("dtype,opaque,spectrum", [
    ("float64", True, "blackbody"), ("float64", False, "powerlaw"),
    ("float32", True, "powerlaw")])
def test_render_scene_with_disk_matches_jax(dtype, opaque, spectrum):
    jcfg, tcfg = _both(dtype)
    src = _background(DIM)
    jd = jdisk.DiskConfig(opaque=opaque, spectrum=spectrum)
    jc, jst = jdisk.render_scene_with_disk(_scene(), src, jcfg, jd,
                                           disk_gain=1.5)
    tc, tst = disk.render_scene_with_disk(
        scene_from_jax(_scene()), src, tcfg, disk_config_from_jax(jd),
        disk_gain=1.5, device="cpu")
    assert tc.dtype == torch.float32 and tuple(tc.shape) == DIM + (3,)
    assert float(tc.min()) >= 0.0 and float(tc.max()) <= 1.5
    mask_j, mask_t = jst["disk_mask"], tst["disk_mask"]
    assert isinstance(mask_t, np.ndarray) and mask_t.dtype == bool
    assert (mask_j == mask_t).mean() >= 0.99
    if dtype == "float64":
        assert np.array_equal(mask_j, mask_t)
        assert tst["captured"] == jst["captured"]
        assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-6
    else:
        both = mask_j & mask_t
        assert np.median(np.abs(tc.numpy() - np.asarray(jc))[both]) < 1e-3
    enc_j = jdisk.composite_gamma_encode(jc, mask_j)
    enc_t = disk.composite_gamma_encode(tc, mask_t)
    if dtype == "float64":
        assert np.abs(enc_t.numpy() - np.asarray(enc_j)).max() < 1e-6


def test_composite_gray_background_matches_jax():
    jcfg, tcfg = _both("float64")
    src = np.random.default_rng(2).random(DIM).astype(np.float32)
    jd = jdisk.DiskConfig(spectrum="blackbody")
    jc, _ = jdisk.render_scene_with_disk(_scene(), src, jcfg, jd)
    tc, _ = disk.render_scene_with_disk(scene_from_jax(_scene()), src, tcfg,
                                        disk_config_from_jax(jd),
                                        device="cpu")
    assert tuple(tc.shape) == DIM
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-6


def test_composite_aa_stacked_matches_loop_and_jax():
    jcfg, tcfg = _both("float64")
    src = _background(DIM)
    jd = jdisk.DiskConfig(r_out=15.0, spectrum="blackbody", opaque=False)
    td = disk_config_from_jax(jd)
    scene = scene_from_jax(_scene())
    ts, st_s = disk.render_scene_with_disk_aa(
        scene, src, tcfg, td, aa_samples=2, display_encode=True,
        device="cpu")
    tl, st_l = disk.render_scene_with_disk_aa(
        scene, src, tcfg, td, aa_samples=2, display_encode=True,
        stacked=False, device="cpu")
    assert np.abs(ts.numpy() - tl.numpy()).max() < 1e-6
    assert np.array_equal(st_s["disk_mask"], st_l["disk_mask"])
    assert st_s["captured"] == st_l["captured"]
    assert st_s["total_rays"] == st_l["total_rays"] == 2 * DIM[0] * DIM[1]
    assert st_s["display_encoded"] and st_l["display_encoded"]
    jc, jst = jdisk.render_scene_with_disk_aa(
        _scene(), src, jcfg, jd, aa_samples=2, display_encode=True)
    assert np.abs(ts.numpy() - np.asarray(jc)).max() < 1e-6
    assert np.array_equal(st_s["disk_mask"], jst["disk_mask"])


def test_composite_aa_grouping_does_not_change_rays(monkeypatch):
    """The stacked composite AA traces every pass in one batch up to
    aa._CHUNK_ABOVE rays and one pass a trace above; a ray's result does
    not depend on its batch, so both groupings give the same image and
    trace bitwise (256 rays a pass: the plain loop's vectorised body)."""
    tcfg = render_cfg_from_jax(JRender(dtype="float32"))
    scene = scene_from_jax(_scene())
    src = _background(DIM)
    calls = []
    real = disk.trace_disk_rays

    def counting(*args, **kw):
        calls.append(args[2].numel())
        return real(*args, **kw)

    monkeypatch.setattr(disk, "trace_disk_rays", counting)
    one, st1 = disk.render_scene_with_disk_aa(scene, src, tcfg,
                                              aa_samples=4, device="cpu")
    monkeypatch.setattr(aa, "_CHUNK_ABOVE", 4 * DIM[0] * DIM[1] - 1)
    per_pass, st4 = disk.render_scene_with_disk_aa(scene, src, tcfg,
                                                   aa_samples=4,
                                                   device="cpu")
    assert calls == [4 * 256] + [256] * 4
    assert torch.equal(one, per_pass)
    assert np.array_equal(st1["disk_mask"], st4["disk_mask"])
    assert st1["captured"] == st4["captured"]
