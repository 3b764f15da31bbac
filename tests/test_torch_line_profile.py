"""The port's disk spectroscopy (spectra.py) against the JAX package:
the emission-line profile and the hot-spot light curve.

The same scenes go through the JAX package's XLA path and the port's plain
loop on the CPU. Criteria:
  * the histogram: edges bitwise jnp.histogram's in float32 (XLA on the
    CPU fuses the last product and sum of linspace into one rounding; in
    float64 it contracts otherwise by vector width, and the edges agree
    to an ulp), and the weighted counts on the same edges equal
    (searchsorted side="right", the last edge inclusive, values outside
    the range dropped);
  * float64: energies, fluxes and light curves to 1e-9 of their largest
    value, g_lim to 1e-9;
  * float32: fluxes and light curves within 5e-3 of their largest value
    (one crossing's g moved across a bin edge by the float32 sin and cos
    of the two packages' traces);
  * the empty field of view raises JAX's ValueError, and the
    retarded-time light curve raises NotImplementedError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu import spectra as jspectra
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import disk, spectra
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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_histogram_matches_jnp_histogram(dtype):
    rng = np.random.default_rng(11)
    for lo, hi, bins in ((0.3, 1.4, 200), (0.461, 1.3301, 40),
                         (-0.02, 1.0, 7), (2.0, 2.0, 5)):
        a = rng.uniform(lo - 0.2, hi + 0.2, 3000).astype(dtype)
        a[:3] = (lo, hi, -1.0)
        w = rng.random(3000).astype(dtype)
        fj, ej = jnp.histogram(jnp.asarray(a), bins=bins, range=(lo, hi),
                               weights=jnp.asarray(w))
        et = spectra.histogram_edges(lo, hi, bins, getattr(torch, dtype))
        assert et.dtype == getattr(torch, dtype)
        ej = np.asarray(ej)
        if dtype == "float32":
            np.testing.assert_array_equal(et.numpy(), ej)
        else:
            assert (np.abs(et.numpy() - ej) <= np.abs(np.spacing(ej))).all()
        # The counts with JAX's own edges: the binning rule.
        ft = spectra.weighted_histogram(torch.from_numpy(a),
                                        torch.from_numpy(w),
                                        torch.from_numpy(ej))
        tol = 1e-12 if dtype == "float64" else 1e-5
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,g_lim,aa_samples", [
    ("float64", None, 1), ("float32", (0.25, 1.45), 1),
    ("float64", (0.25, 1.45), 2)])
def test_line_profile_matches_jax(dtype, g_lim, aa_samples):
    jcfg, tcfg = _both(dtype)
    jd = jdisk.DiskConfig(opaque=False)
    ej, fj, sj = jspectra.line_profile(_scene(), DIM, jcfg, jd, n_bins=24,
                                       g_lim=g_lim, rest_energy=6.4,
                                       aa_samples=aa_samples)
    et, ft, st = spectra.line_profile(
        scene_from_jax(_scene()), DIM, tcfg, disk_config_from_jax(jd),
        n_bins=24, g_lim=g_lim, rest_energy=6.4, aa_samples=aa_samples,
        device="cpu")
    assert et.dtype == ej.dtype and ft.dtype == np.float64
    assert et.shape == ft.shape == (24,)
    for key in ("r_isco", "rest_energy", "total_rays", "traced_rays"):
        assert st[key] == sj[key], key
    assert st["traced_rays"] == aa_samples * DIM[0] * DIM[1]
    if dtype == "float64":
        np.testing.assert_allclose(st["g_lim"], sj["g_lim"], rtol=1e-9)
        np.testing.assert_allclose(et, ej, rtol=1e-9)
        assert np.abs(ft - fj).max() <= 1e-9 * fj.max()
        for key in ("disk_pixels", "captured"):
            assert st[key] == sj[key], key
    else:
        np.testing.assert_array_equal(et, ej)
        assert np.abs(ft - fj).max() <= 5e-3 * fj.max()
    assert fj.sum() > 0


def test_line_profile_supersampling_keeps_edges():
    """aa_samples with the same g_lim keeps the energy grid; the traced
    rays and the flux weights scale by the samples."""
    _jcfg, tcfg = _both("float64")
    scene = scene_from_jax(_scene())
    flat = disk.DiskConfig(emissivity_index=0.0, g_power=0.0)
    e1, f1, s1 = spectra.line_profile(scene, DIM, tcfg, flat, n_bins=16,
                                      rest_energy=1.0, device="cpu")
    e2, f2, s2 = spectra.line_profile(scene, DIM, tcfg, flat, n_bins=16,
                                      rest_energy=1.0, aa_samples=2,
                                      g_lim=s1["g_lim"], device="cpu")
    np.testing.assert_array_equal(e2, e1)
    assert s2["traced_rays"] == 2 * s1["traced_rays"]
    np.testing.assert_allclose(f2.sum(), f1.sum(), rtol=0.2)


def test_line_profile_empty_fov_raises():
    jscene = JScene(M=1.0, a=0.0, r_obs_mult=100.0, theta_obs=THETA,
                    psi_y=float(np.radians(60.0)))
    jcfg, tcfg = _both("float64")
    with pytest.raises(ValueError, match="no disk crossings"):
        jspectra.line_profile(jscene, (8, 8), jcfg,
                              jdisk.DiskConfig(r_out=8.0), n_bins=16)
    with pytest.raises(ValueError, match="no disk crossings"):
        spectra.line_profile(scene_from_jax(jscene), (8, 8), tcfg,
                             disk.DiskConfig(r_out=8.0), n_bins=16,
                             device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hotspot_light_curve_matches_jax(dtype):
    jcfg, tcfg = _both(dtype)
    spot = jdisk.HotSpot(r0=6.5, amplitude=7.0)
    period = abs(2 * np.pi / jdisk.keplerian_omega(1.0, 0.9, 6.5))
    ts = np.linspace(0.0, period, 9)
    tj, fj, sj = jspectra.hotspot_light_curve(_scene(), DIM, ts, jcfg,
                                              jdisk.DiskConfig(), spot)
    tt, ft, st = spectra.hotspot_light_curve(
        scene_from_jax(_scene()), DIM, iter(ts), tcfg, disk.DiskConfig(),
        hotspot_from_jax(spot), device="cpu")
    np.testing.assert_array_equal(tt, tj)
    assert ft.dtype == np.float64 and st["n_samples"] == 9
    assert st["orbit_period"] == pytest.approx(sj["orbit_period"],
                                               rel=1e-14)
    assert st["delay_spread"] == sj["delay_spread"] == 0.0
    bar = 1e-9 if dtype == "float64" else 5e-3
    assert np.abs(ft - fj).max() <= bar * fj.max()
    assert ft.max() / ft.min() > 1.01
    assert abs(ft[-1] / ft[0] - 1.0) < (1e-12 if dtype == "float64"
                                        else 1e-5)


def test_light_travel_delay_raises():
    # The retarded-time light curve is ported
    # (tests/test_torch_light_travel_delay.py holds it against JAX): the
    # delays spread over the image and leave the flux finite.
    _jcfg, tcfg = _both("float64")
    _t, flux, st = spectra.hotspot_light_curve(
        scene_from_jax(_scene()), (4, 4), [0.0, 1.0], tcfg,
        light_travel_delay=True, device="cpu")
    assert np.isfinite(flux).all() and st["delay_spread"] >= 0.0
