"""The PyTorch port's Kerr model against the JAX package's.

Same inputs, made with numpy from a seed, go through both. Tolerances:
float64 relative 1e-12, float32 relative 1e-5, each taken against the
largest magnitude of the compared component (components cross zero, where
a pointwise relative bound means nothing).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import make_metric as jmake_metric
from light_path_tracer_tpu_torch.convert import metric_from_jax
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman,
                                                ReissnerNordstrom,
                                                Schwarzschild, make_metric)

R_OBS = 100.0
RTOL = {"float64": 1e-12, "float32": 1e-5}
DTYPES = ["float64", "float32"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, dtype):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL[dtype] * scale)


def _pair(dtype, *arrays):
    """numpy float64 arrays -> (jax arrays, torch CPU tensors) in dtype."""
    j = tuple(jnp.asarray(np.asarray(a, np.dtype(dtype))) for a in arrays)
    t = tuple(torch.from_numpy(np.asarray(a, np.dtype(dtype)))
              for a in arrays)
    return j, t


def _screen(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.005, 0.3, n), rng.uniform(-np.pi, np.pi, n)


@pytest.mark.parametrize("theta_obs", [np.pi / 2, 1.1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_initial_conditions_match_jax(dtype, theta_obs):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    (ja, jt), (ta, tt) = _pair(dtype, *_screen(300, 1))
    jy, jpt, jpp, jinv = jm.initial_conditions_5d(R_OBS, ja, jt, theta_obs)
    ty, tpt, tpp, tinv = tm.initial_conditions_5d(R_OBS, ta, tt, theta_obs)
    for a, b in zip(ty, jy):
        assert a.dtype == getattr(torch, dtype)
        _close(a.numpy(), np.broadcast_to(np.asarray(b), a.shape), dtype)
    _close(tpt.numpy(), np.broadcast_to(np.asarray(jpt), tpt.shape), dtype)
    _close(tpp.numpy(), jpp, dtype)
    np.testing.assert_array_equal(tinv.numpy(),
                                  np.broadcast_to(np.asarray(jinv),
                                                  tinv.shape))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rhs5_matches_jax(dtype):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(2)
    n = 400
    r = rng.uniform(1.5, 60.0, n)
    r[:8] = 1.2   # inside 1.001 r_+: the RHS is frozen to zero
    state = (r, rng.uniform(0.05, 3.1, n), rng.uniform(-10, 10, n),
             rng.uniform(-1, 1, n), rng.uniform(-5, 5, n))
    p_t = -np.ones(n)
    p_phi = rng.uniform(-6, 6, n)
    j, t = _pair(dtype, *state, p_t, p_phi)
    ref = jm.rhs5(j[:5], j[5], j[6])
    got = tm.rhs5(t[:5], t[5], t[6])
    assert got.shape == (5, n)
    for c in range(5):
        _close(got[c].numpy(), ref[c], dtype)
        assert not got[c, :8].any()


@pytest.mark.parametrize("theta_obs", [np.pi / 2, 1.1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plunge_radii_match_jax(dtype, theta_obs):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    (ja, jt), (ta, tt) = _pair(dtype, *_screen(300, 3))
    ref = np.asarray(jm.plunge_radii(R_OBS, ja, jt, theta_obs))
    got = tm.plunge_radii(R_OBS, ta, tt, theta_obs).numpy()
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)
    _close(got, ref, dtype)
    assert (ref > 0).any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_angle_matches_jax(dtype):
    jm, tm = JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)
    rng = np.random.default_rng(4)
    n = 300
    r = rng.uniform(150.0, 250.0, n)
    r[:20] = 1.45          # parked at the capture surface
    captured = np.zeros(n, bool)
    captured[:30] = True   # includes lanes flagged by the tracer only
    state = (r, rng.uniform(0.2, 2.9, n), rng.uniform(-20, 20, n),
             rng.uniform(0.2, 1.0, n), rng.uniform(-3, 3, n))
    p_t, p_phi = -np.ones(n), rng.uniform(-6, 6, n)
    j, t = _pair(dtype, *state, p_t, p_phi)
    js, jfa, jnh = jm.extract_angle(j[:5], j[5], j[6], jnp.asarray(captured))
    ts, tfa, tnh = tm.extract_angle(t[:5], t[5], t[6],
                                    torch.from_numpy(captured))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tnh.numpy(), np.asarray(jnh))
    jfa = np.asarray(jfa)
    np.testing.assert_array_equal(np.isnan(tfa.numpy()), np.isnan(jfa))
    ok = ~np.isnan(jfa)
    assert ok.sum() > 200
    _close(tfa.numpy()[ok], jfa[ok], dtype)


@pytest.mark.parametrize("spin", [0.3, 0.9, 0.998])
def test_host_geometry_matches_jax(spin):
    jm, tm = JKerr(M=1.0, a=spin), Kerr(M=1.0, a=spin)
    assert tm.r_plus == jm.r_plus
    assert tm.capture_radius() == jm.capture_radius()
    assert tm.unstable_photon_radii() == jm.unstable_photon_radii()
    for theta_obs in (np.pi / 2, 1.1):
        assert tm.alpha_crit(R_OBS, theta_obs) == pytest.approx(
            jm.alpha_crit(R_OBS, theta_obs), rel=1e-12)


@pytest.mark.parametrize("kwargs", [dict(a=0.0), dict(a=0.0, Q=0.5),
                                    dict(a=0.0, Q=-0.3)])
def test_make_metric_returns_spherical_families(kwargs):
    """a = 0 selects Schwarzschild, or Reissner-Nordstrom with Q != 0, as
    the JAX package's make_metric does, and metric_from_jax carries the
    JAX metric across to the same object."""
    got = make_metric(M=1.0, **kwargs)
    ref = jmake_metric(M=1.0, **kwargs)
    assert type(got).__name__ == type(ref).__name__
    assert isinstance(got, ReissnerNordstrom if kwargs.get("Q")
                      else Schwarzschild)
    assert got == metric_from_jax(ref)
    assert got.R_S == pytest.approx(ref.R_S, rel=1e-12)


@pytest.mark.parametrize("kwargs", [dict(a=0.5, Q=0.5),
                                    dict(a=0.9, eps3=1.0),
                                    dict(a=0.0, eps3=-2.0),
                                    dict(a=-0.6, Q=0.7)])
def test_make_metric_raises_for_families_not_ported(kwargs):
    """Kerr-Newman and Johannsen-Psaltis, once not ported: make_metric
    returns each family as the JAX package's does, equal to
    metric_from_jax of the JAX metric, with the same host floats; eps3
    with a charge raises the JAX package's ValueError."""
    got = make_metric(M=1.0, **kwargs)
    ref = jmake_metric(M=1.0, **kwargs)
    assert type(got).__name__ == type(ref).__name__
    assert isinstance(got, KerrNewman if "Q" in kwargs
                      else JohannsenPsaltis)
    assert got == metric_from_jax(ref)
    assert got.r_plus == ref.r_plus
    assert got.capture_radius() == ref.capture_radius()
    with pytest.raises(ValueError):
        make_metric(M=1.0, a=0.5, Q=0.3, eps3=1.0)
    assert make_metric(M=1.0, a=0.9) == Kerr(M=1.0, a=0.9)


@pytest.mark.parametrize("dtype, bar", [("float64", 1e-14), ("float32", 2e-6)])
def test_tdot_matches_jax(dtype, bar):
    """dt/dlambda = g^tt p_t + g^tphi p_phi on random states: float64
    within 1e-14 of the largest value, float32 within 2e-6 (a few ulp of
    the quotient -A / (Sigma Delta))."""
    rng = np.random.default_rng(11)
    n = 512
    state = np.stack([rng.uniform(2.0, 200.0, n), rng.uniform(0.05, 3.1, n),
                      rng.uniform(-6, 6, n), rng.uniform(-1, 1, n),
                      rng.uniform(-3, 3, n)]).astype(dtype)
    p_t = -np.ones(n, dtype)
    p_phi = rng.uniform(-5, 5, n).astype(dtype)
    for a in (0.9, -0.5, 0.0):
        want = np.asarray(JKerr(M=1.0, a=a).tdot(
            tuple(jnp.asarray(c) for c in state), jnp.asarray(p_t),
            jnp.asarray(p_phi)))
        got = Kerr(M=1.0, a=a).tdot(torch.from_numpy(state),
                                    torch.from_numpy(p_t),
                                    torch.from_numpy(p_phi)).numpy()
        assert got.dtype == want.dtype == np.dtype(dtype)
        assert np.abs(got - want).max() <= bar * np.abs(want).max()
        assert (got > 0).all()                 # time runs forward outside
