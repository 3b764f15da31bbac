"""The port's polarized thin disk (polarization.py, the disk half)
against the JAX package: render_polarization with each field geometry
and hotspot_qu_loop.

The same scenes go through the JAX package's XLA path and the port's plain
loop on the CPU. Criteria:
  * the per-crossing algebra on the same crossings (JAX's trace) in
    float64: the emitted polarization, the pitch factor and the observed
    EVPA to 1e-9 (EVPA modulo pi);
  * float64 renders: the same polarized pixels, EVPA within one float32
    ulp modulo pi (both packages return float32 maps), pol_frac and
    intensity max |d| < 1e-6; the Q-U loop's I, Q, U to 1e-7 of their
    largest value (the two float64 traces record a few crossing radii
    1e-8 M apart);
  * float32: the NaN masks agree on >= 99 % of pixels, the median EVPA
    difference modulo pi < 1e-3 rad, the Q-U loop within 5e-3 of its
    largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import disk as jdisk
from light_path_tracer_tpu import polarization as jpol
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import disk, polarization
from light_path_tracer_tpu_torch.convert import (hotspot_from_jax,
                                                 render_cfg_from_jax,
                                                 scene_from_jax)
from light_path_tracer_tpu_torch.models import Kerr

THETA = float(np.radians(70.0))
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


def _mod_pi(d):
    return np.abs(np.remainder(d + np.pi / 2, np.pi) - np.pi / 2)


@pytest.mark.parametrize("field", ["toroidal", "vertical", "radial"])
def test_disk_polarization_algebra_matches_jax(field):
    """emission_polarization, walker_penrose at the crossing and
    observed_polarization on JAX's own float64 crossings."""
    rng = np.random.default_rng(9)
    al = rng.uniform(0.01, 0.12, 256)
    th = rng.uniform(-np.pi, np.pi, 256)
    res = jdisk.trace_disk_rays(JKerr(M=1.0, a=0.9), 100.0, jnp.asarray(al),
                                jnp.asarray(th), THETA, 5000.0, 20000,
                                jdisk.DiskConfig(), backend="xla",
                                record_momentum=True)
    hit = np.asarray(res.n_hits) > 0
    assert hit.sum() > 100
    r_in = jdisk.r_isco(1.0, 0.9)
    r_c = np.maximum(np.asarray(res.r_hits[0]), r_in)
    pr, pth, xi = (np.asarray(x) for x in (res.pr_hits[0], res.pth_hits[0],
                                           res.xi))
    M, a = jnp.asarray(1.0), jnp.asarray(0.9)
    fj, sj = jpol.emission_polarization(M, a, jnp.asarray(r_c),
                                        jnp.asarray(pr), jnp.asarray(pth),
                                        jnp.asarray(xi), field=field)
    kj = jpol.walker_penrose(a, jnp.asarray(r_c), jnp.full(256, np.pi / 2),
                             jpol.k_contravariant(
                                 M, a, jnp.asarray(r_c),
                                 jnp.full(256, np.pi / 2), jnp.asarray(pr),
                                 jnp.asarray(pth), jnp.asarray(xi)), fj)
    xj, yj, okj = jpol.observed_polarization(
        JKerr(M=1.0, a=0.9), 100.0, THETA, jnp.asarray(al), jnp.asarray(th),
        *kj)
    t = {k: torch.from_numpy(v) for k, v in dict(
        r=r_c, pr=pr, pth=pth, xi=xi, al=al, th=th).items()}
    Mt, at = torch.tensor(1.0, dtype=torch.float64), torch.tensor(
        0.9, dtype=torch.float64)
    ft, st = polarization.emission_polarization(Mt, at, t["r"], t["pr"],
                                                t["pth"], t["xi"],
                                                field=field)
    half = torch.full((256,), np.pi / 2, dtype=torch.float64)
    kt = polarization.walker_penrose(at, t["r"], half,
                                     polarization.k_contravariant(
                                         Mt, at, t["r"], half, t["pr"],
                                         t["pth"], t["xi"]), ft)
    xt, yt, okt = polarization.observed_polarization(
        Kerr(M=1.0, a=0.9), 100.0, THETA, t["al"], t["th"], *kt)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=1e-9)
    for u, v in zip(ft, fj):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-9,
                                   atol=1e-12)
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    ej = np.arctan2(np.asarray(xj), -np.asarray(yj))
    et = torch.atan2(xt, -yt).numpy()
    good = hit & np.asarray(okj) & (np.asarray(sj) > 0)
    assert _mod_pi(et[good] - ej[good]).max() < 1e-9


@pytest.mark.parametrize("dtype,field", [
    ("float64", "toroidal"), ("float64", "vertical"), ("float64", "radial"),
    ("float32", "toroidal")])
def test_render_polarization_matches_jax(dtype, field):
    jcfg, tcfg = _both(dtype)
    ej, pj, ij, sj = jpol.render_polarization(_scene(), DIM, jcfg,
                                              jdisk.DiskConfig(), field=field)
    et, pt, it, st = polarization.render_polarization(
        scene_from_jax(_scene()), DIM, tcfg, disk.DiskConfig(), field=field,
        device="cpu")
    for x in (et, pt, it):
        assert isinstance(x, np.ndarray) and x.dtype == np.float32
        assert x.shape == DIM
    for key in ("r_isco", "field", "total_rays", "traced_rays"):
        assert st[key] == sj[key]
    both = np.isfinite(ej) & np.isfinite(et)
    assert both.sum() > 20
    good = et[np.isfinite(et)]
    assert good.min() > -np.pi / 2 and good.max() <= np.pi / 2
    if dtype == "float64":
        for key in ("disk_pixels", "polarized_pixels"):
            assert st[key] == sj[key], key
        assert np.array_equal(np.isnan(et), np.isnan(ej))
        ulp = np.spacing(np.float32(np.pi / 2))
        assert _mod_pi(et[both].astype(np.float64) - ej[both]).max() <= ulp
        assert np.abs(pt - pj).max() < 1e-6
        assert np.abs(it - ij).max() < 1e-6
    else:
        assert (np.isnan(et) == np.isnan(ej)).mean() >= 0.99
        assert np.median(_mod_pi(et[both].astype(np.float64)
                                 - ej[both])) < 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hotspot_qu_loop_matches_jax(dtype):
    jcfg, tcfg = _both(dtype)
    spot = jdisk.HotSpot()
    period = abs(2 * np.pi / jdisk.keplerian_omega(1.0, 0.9, spot.r0))
    ts = np.linspace(0.0, period, 7)
    out_j = jpol.hotspot_qu_loop(_scene(), DIM, ts, jcfg,
                                 jdisk.DiskConfig(), spot)
    out_t = polarization.hotspot_qu_loop(
        scene_from_jax(_scene()), DIM, ts, tcfg, disk.DiskConfig(),
        hotspot_from_jax(spot), device="cpu")
    np.testing.assert_array_equal(out_t[0], out_j[0])
    # float64: 1e-7, not 1e-9: at 70 deg three rays of this grid cross
    # the disk 1e-8 M apart in the two packages' float64 traces (their sin
    # and cos round otherwise), and the sums carry r^-3.
    bar = 1e-7 if dtype == "float64" else 5e-3
    for u, v in zip(out_t[1:4], out_j[1:4]):
        assert u.dtype == np.float64 and u.shape == (7,)
        assert np.abs(u - v).max() <= bar * np.abs(v).max()
    st, sj = out_t[4], out_j[4]
    for key in ("orbit_period", "n_samples", "field", "total_rays"):
        assert st[key] == pytest.approx(sj[key], rel=1e-14) if isinstance(
            sj[key], float) else st[key] == sj[key]
    _t, I, Q, U, _st = out_t
    assert (I > 0).all()
    closure = max(abs(Q[0] - Q[-1]), abs(U[0] - U[-1])) / np.abs(Q).max()
    assert closure < (1e-9 if dtype == "float64" else 1e-4)


def test_disk_polarization_rejects():
    _jcfg, tcfg = _both("float64")
    with pytest.raises(ValueError, match="psi"):
        polarization.render_polarization(
            scene_from_jax(_scene(psi_y=0.1)), (4, 4), tcfg, device="cpu")
    with pytest.raises(ValueError, match="uncharged"):
        polarization.hotspot_qu_loop(scene_from_jax(_scene(Q=0.3)), (4, 4),
                                     [0.0], tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        polarization.render_polarization(scene_from_jax(_scene()), (4, 4),
                                         tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="b-field"):
        polarization.field_vector("helical", torch.ones(2))
