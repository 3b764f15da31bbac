"""The port's disk modes against the JAX package: the photon-ring
decomposition, hot-spot and texture frames and disk AA (the composites:
tests/test_torch_disk_composite.py).

The same scenes (and numpy-seeded textures and backgrounds) go through
the JAX package's XLA path and the port's plain loops on the CPU
(`device="cpu"`). Criteria:
  * float64: images and layers max |d| < 1e-6 (the images are float32);
    fluxes, ratios and mean radii to 1e-9 relative; equal pixel counts;
  * float32: tests/test_torch_disk.py's (disk masks agree on >= 99 % of
    pixels) and the median |d| on disk pixels < 1e-3;
  * the patterns themselves to 1e-12 in float64.
The n_orders = 5 decomposition runs the plain loop, which takes any
number of slots (the card's wide instances hold 5 to 8:
tests/test_torch_cuda.py and chip_smoke.py phase 24).
"""

import dataclasses

import numpy as np
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import disk
from light_path_tracer_tpu_torch.convert import (disk_config_from_jax,
                                                 hotspot_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)

THETA = float(np.radians(80.0))
DIM = (16, 16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(**kw):
    kw.setdefault("vertical_fov_deg", 30.0)
    return JScene(M=1.0, a=0.9, r_obs_mult=100.0, theta_obs=THETA, **kw)


def _both(dtype):
    jcfg = JRender(dtype=dtype, backend="xla")
    return jcfg, render_cfg_from_jax(jcfg)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _images_agree(dtype, jimg, timg, mask_j=None, mask_t=None):
    jimg, timg = _np(jimg), _np(timg)
    assert timg.shape == jimg.shape
    if dtype == "float64":
        assert np.abs(timg - jimg).max() < 1e-6
        return
    mask_j = jimg > 0 if mask_j is None else mask_j
    mask_t = timg > 0 if mask_t is None else mask_t
    assert (mask_j == mask_t).mean() >= 0.99
    both = mask_j & mask_t
    assert np.median(np.abs(timg - jimg)[both]) < 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_patterns_match_jax(dtype):
    rng = np.random.default_rng(5)
    r = rng.uniform(2.0, 20.0, 400).astype(dtype)
    phi = rng.uniform(-8.0, 14.0, 400).astype(dtype)
    spot = jdisk.HotSpot(r0=7.0, phi0=0.3, amplitude=5.0)
    tex = rng.random((6, 9)).astype(np.float32)
    tol = 1e-12 if dtype == "float64" else 2e-5
    for t in (0.0, 37.5, 1234.0):
        tj = np.asarray(t, dtype)
        jp = jdisk.hotspot_pattern(spot, 1.0, 0.9)(r, phi, jnp_(tj))
        tp = disk.hotspot_pattern(hotspot_from_jax(spot), 1.0, 0.9)(
            torch.from_numpy(r), torch.from_numpy(phi), torch.tensor(tj))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=tol,
                                   atol=tol)
        for shear in (True, False):
            jt = jdisk.texture_pattern(tex, 2.3, 20.0, 1.0, 0.9,
                                       shear=shear)(r, phi, jnp_(tj))
            tt = disk.texture_pattern(tex, 2.3, 20.0, 1.0, 0.9,
                                      shear=shear)(
                torch.from_numpy(r), torch.from_numpy(phi),
                torch.tensor(tj))
            assert tt.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt),
                                       rtol=tol, atol=tol)
    assert disk.HotSpot().period == pytest.approx(jdisk.HotSpot().period,
                                                  rel=1e-15)


def jnp_(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


@pytest.mark.parametrize("dtype,n_orders,spectrum", [
    ("float64", 3, "powerlaw"), ("float64", 5, "powerlaw"),
    ("float32", 3, "powerlaw"), ("float64", 3, "blackbody")])
def test_render_disk_decomposed_matches_jax(dtype, n_orders, spectrum):
    jcfg, tcfg = _both(dtype)
    jd = jdisk.DiskConfig(spectrum=spectrum)
    jl, jst = jdisk.render_disk_decomposed(_scene(), DIM, jcfg, jd,
                                           n_orders=n_orders)
    tl, tst = disk.render_disk_decomposed(
        scene_from_jax(_scene()), DIM, tcfg, disk_config_from_jax(jd),
        n_orders=n_orders, device="cpu")
    assert tl.dtype == torch.float32 and tl.shape[0] == n_orders
    assert set(tst["timings"]) == {"build_lookup", "precompute", "render",
                                   "total"}
    for key in ("r_isco", "total_rays", "traced_rays"):
        assert tst[key] == jst[key]
    assert tst["alpha_crit"] == pytest.approx(jst["alpha_crit"], rel=1e-12)
    lum = (lambda x: x.sum(-1)) if spectrum == "blackbody" else (
        lambda x: x)
    _images_agree(dtype, lum(_np(jl)).sum(0), lum(_np(tl)).sum(0))
    flux_j = np.asarray(jst["flux_per_order"])
    flux_t = np.asarray(tst["flux_per_order"])
    if dtype == "float64":
        _images_agree(dtype, jl, tl)
        for key in ("pixels_per_order", "captured", "disk_pixels"):
            assert tst[key] == jst[key], key
        for key in ("flux_per_order", "flux_ratios", "mean_radius_rad"):
            np.testing.assert_allclose(tst[key], jst[key], rtol=1e-9,
                                       atol=1e-300)
        g_j, g_t = (np.asarray(s["gamma_estimates"]) for s in (jst, tst))
        fin = np.isfinite(g_j) & (g_j < 600)
        np.testing.assert_allclose(g_t[fin], g_j[fin], rtol=1e-9)
    else:
        np.testing.assert_allclose(flux_t, flux_j, rtol=2e-3, atol=1e-6)
    assert flux_t[0] > flux_t[1] > 0.0


@pytest.mark.parametrize("dtype,kind", [("float64", "hotspot"),
                                        ("float32", "texture"),
                                        ("float64", "generator")])
def test_render_disk_frames_matches_jax(dtype, kind):
    jcfg, tcfg = _both(dtype)
    spot = jdisk.HotSpot(r0=6.0, amplitude=8.0)
    period = 2.0 * np.pi / jdisk.keplerian_omega(1.0, 0.9, 6.0)
    times = [0.0, period / 3.0, period]
    jp = tp = None
    jd = jdisk.DiskConfig(spectrum="blackbody" if kind == "texture"
                          else "powerlaw")
    if kind == "texture":
        tex = np.random.default_rng(3).random((8, 12)).astype(np.float32)
        r_in = jdisk.r_isco(1.0, 0.9)
        jp = jdisk.texture_pattern(tex, r_in, 20.0, 1.0, 0.9)
        tp = disk.texture_pattern(tex, r_in, 20.0, 1.0, 0.9)
    jt = (t for t in times) if kind == "generator" else times
    tt = (t for t in times) if kind == "generator" else times
    jf, jst = jdisk.render_disk_frames(_scene(), DIM, jt, jcfg, jd, spot,
                                       pattern=jp)
    tf, tst = disk.render_disk_frames(
        scene_from_jax(_scene()), DIM, tt, tcfg, disk_config_from_jax(jd),
        hotspot_from_jax(spot), pattern=tp, device="cpu")
    assert tst["n_frames"] == jst["n_frames"] == 3
    assert tst["orbit_period"] == pytest.approx(jst["orbit_period"],
                                                rel=1e-14)
    assert tuple(tst["emission"].shape) == (3,) + DIM
    assert tst["emission"].dtype == torch.float32
    lum = (lambda x: x.sum(-1)) if kind == "texture" else (lambda x: x)
    for k in range(3):
        _images_agree(dtype, lum(_np(jf[k])), lum(_np(tf[k])))
        _images_agree(dtype, _np(jst["emission"][k]),
                      _np(tst["emission"][k]))
    if dtype == "float64":
        assert tst["disk_pixels"] == jst["disk_pixels"]
        # A full orbit returns the hot spot's frame.
        assert np.abs(_np(tf[2]) - _np(tf[0])).max() < 1e-6
        assert np.abs(_np(tf[1]) - _np(tf[0])).max() > 0.01


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_disk_aa_matches_jax(dtype):
    jcfg, tcfg = _both(dtype)
    ji, jst = jdisk.render_disk_aa(_scene(), DIM, jcfg, jdisk.DiskConfig(),
                                   aa_samples=2)
    ti, tst = disk.render_disk_aa(scene_from_jax(_scene()), DIM, tcfg,
                                  disk.DiskConfig(), aa_samples=2,
                                  device="cpu")
    assert ti.dtype == torch.float32
    for key in ("aa_samples", "total_rays", "traced_rays"):
        assert tst[key] == jst[key]
    _images_agree(dtype, ji, ti)
    if dtype == "float64":
        assert tst["disk_pixels"] == jst["disk_pixels"]
        assert tst["captured"] == jst["captured"]


def test_disk_modes_reject_boost():
    # A boost is ported: a boost of 0 renders the static image bitwise and
    # a moving camera changes it (tests/test_torch_aberration.py holds the
    # boosted renders against JAX).
    static = scene_from_jax(_scene())
    for render in (disk.render_disk_decomposed, disk.render_disk_aa):
        ref, _ = render(static, (4, 4), device="cpu")
        zero, _ = render(dataclasses.replace(static, boost=(0.0, 0.0, 0.0)),
                         (4, 4), device="cpu")
        moving, _ = render(dataclasses.replace(static, boost=(0.1, 0.0, 0.0)),
                           (4, 4), device="cpu")
        assert torch.equal(zero, ref)
        assert bool(torch.isfinite(moving).all())
        assert not torch.equal(moving, ref)
