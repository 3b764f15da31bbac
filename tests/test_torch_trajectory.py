"""The port's 8-D surface of the metrics and its path recorder
(light_path_tracer_tpu_torch/trajectory.py) against the JAX package's.

Inputs: the `plot` CLI's ten default viewing angles (0, 2, 4, 5, 5.5,
5.97, 6.5, 8, 10, 15 deg) at r_obs = 100 M, and 64 random 8-D states made
from a numpy seed for the RHS. Every family: Kerr a = 0.9, Kerr-Newman
(a 0.6, Q 0.6), Johannsen-Psaltis (a 0.9, eps3 2), Schwarzschild and
Reissner-Nordstrom Q = 0.6. Both packages run on the CPU. Criteria:
  * the 8-D RHS and the 8-D initial conditions within 1e-12 relative;
    the autograd Hamiltonian RHS equal to the hand-derived rhs5 and to
    JAX's rhs5_autodiff at 1e-12;
  * float64 adaptive recorder: the same outcome and n_valid on every ray;
    every recorded state within 1e-9 of the ray's largest |state| (5e-9
    for Reissner-Nordstrom, see below); p_t and p_phi exactly constant
    on every integrated sample of the port's path (the terminal sample,
    on the step's Hermite interpolant, within 4 ulps);
  * float32: the same outcome, and the final r and phi within 1e-3
    relative, on the escaping rays outside 1.05 alpha_crit;
  * the fixed-step RK4 recorder (method="fixed") in float64: same
    outcome and n_valid, states within 1e-9 of the path's scale;
  * Metric.trace_ray (trace_batch on the plain loop): the same outcome
    and winding, final alpha within 1e-10 in float64 (Kerr-Newman and
    Johannsen-Psaltis, which share Kerr's route, at 0, 4 and 15 deg);
  * trace_ray_trajectories: each ray bitwise its single-ray trace.
The step-size controller reads an error estimate that cancels to a few
digits, and XLA:CPU contracts its linear combinations (fused multiply-
adds) where PyTorch rounds every product: a last-bit difference there
moves a step size by ~1e-8 relative, so the recorded samples sit at
slightly other affine parameters. The records therefore agree to the
path's scale, not bitwise; Reissner-Nordstrom's reads 2.3e-9 on the
15-deg ray.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import trajectory as jtr
from light_path_tracer_tpu.models import JohannsenPsaltis as JJP
from light_path_tracer_tpu.models import Kerr as JKerr
from light_path_tracer_tpu.models import KerrNewman as JKN
from light_path_tracer_tpu.models import ReissnerNordstrom as JRN
from light_path_tracer_tpu.models import Schwarzschild as JS
from light_path_tracer_tpu_torch import trajectory as ttr
from light_path_tracer_tpu_torch.models import (JohannsenPsaltis, Kerr,
                                                KerrNewman,
                                                ReissnerNordstrom,
                                                Schwarzschild)

R_OBS = 100.0
ANGLES = (0.0, 2.0, 4.0, 5.0, 5.5, 5.97, 6.5, 8.0, 10.0, 15.0)
FAMILIES = {
    "kerr": (JKerr(M=1.0, a=0.9), Kerr(M=1.0, a=0.9)),
    "kerr_newman": (JKN(M=1.0, a=0.6, Q=0.6), KerrNewman(M=1.0, a=0.6,
                                                         Q=0.6)),
    "johannsen_psaltis": (JJP(M=1.0, a=0.9, eps3=2.0),
                          JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)),
    "schwarzschild": (JS(M=1.0), Schwarzschild(M=1.0)),
    "reissner_nordstrom": (JRN(M=1.0, Q=0.6),
                           ReissnerNordstrom(M=1.0, Q=0.6)),
}
STATE_BAR = {"reissner_nordstrom": 5e-9}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _states(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 50, n), rng.uniform(3.0, 60.0, n),
                     rng.uniform(0.2, np.pi - 0.2, n),
                     rng.uniform(-np.pi, np.pi, n), np.full(n, -1.0),
                     rng.uniform(-1, 1, n), rng.uniform(-4, 4, n),
                     rng.uniform(-6, 6, n)], axis=-1)


@pytest.mark.parametrize("family", FAMILIES)
def test_geodesic_equations_and_initial_conditions_match_jax(family):
    jm, tm = FAMILIES[family]
    s = _states()
    want = np.asarray(jm.geodesic_equations(0.0, jnp.asarray(s)))
    got = tm.geodesic_equations(0.0, torch.tensor(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    al = np.radians(np.array(ANGLES))
    ws, wi = jm.initial_conditions_8d(R_OBS, jnp.asarray(al), 0.3)
    gs, gi = tm.initial_conditions_8d(R_OBS, torch.tensor(al), 0.3)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("family", ["kerr", "kerr_newman"])
def test_rhs5_autodiff_matches_hand_rhs_and_jax(family):
    jm, tm = FAMILIES[family]
    s = _states()
    y = tuple(torch.tensor(s[:, i]) for i in (1, 2, 3, 5, 6))
    p_t, p_phi = torch.tensor(s[:, 4]), torch.tensor(s[:, 7])
    auto = tm.rhs5_autodiff(y, p_t, p_phi).numpy()
    hand = tm.rhs5(y, p_t, p_phi).numpy()
    np.testing.assert_allclose(auto, hand, rtol=1e-12, atol=1e-15)
    jy = tuple(jnp.asarray(s[:, i]) for i in (1, 2, 3, 5, 6))
    want = np.stack(jm.rhs5_autodiff(jy, jnp.asarray(s[:, 4]),
                                     jnp.asarray(s[:, 7])))
    np.testing.assert_allclose(auto, want, rtol=1e-12, atol=1e-15)
    assert not any(t.requires_grad for t in (tm.rhs5_autodiff(
        y, p_t, p_phi),))


def _jax_trajectory(jm, alpha, dtype, method="adaptive", n_steps=4000):
    with jax.enable_x64(dtype == "float64"):
        traj, outcome = jtr.trace_ray_trajectory(
            jm, R_OBS, alpha, dtype=getattr(jnp, dtype), method=method,
            n_steps=n_steps)
        if traj is None:
            return None, outcome
        return (dict(states=np.asarray(traj.states, np.float64),
                     n_valid=int(traj.n_valid)), outcome)


@pytest.mark.parametrize("family", FAMILIES)
def test_adaptive_recorder_float64_matches_jax(family):
    jm, tm = FAMILIES[family]
    traces = ttr.trace_ray_trajectories(
        tm, R_OBS, np.radians(ANGLES), dtype=torch.float64, device="cpu")
    bar = STATE_BAR.get(family, 1e-9)
    for deg, (traj, outcome) in zip(ANGLES, traces):
        want, joutcome = _jax_trajectory(jm, np.radians(deg), "float64")
        assert outcome == joutcome, deg
        if traj is None:
            assert want is None
            continue
        n = int(traj.n_valid)
        assert n == want["n_valid"], deg
        got = traj.states.numpy()
        assert got.shape == want["states"].shape
        scale = np.abs(want["states"][:n]).max()
        err = np.abs(got - want["states"]).max() / scale
        assert err < bar, (deg, err)
        # p_t and p_phi: exactly constant on every integrated sample; the
        # terminal sample, on the step's Hermite interpolant, mixes two
        # equal values with weights that sum to 1 to within an ulp.
        path = got[:n]
        for col in (4, 7):
            assert (path[:-1, col] == path[0, col]).all(), (deg, col)
            assert abs(path[-1, col] - path[0, col]) \
                <= 4 * np.finfo(np.float64).eps * abs(path[0, col])


@pytest.mark.parametrize("family", ["kerr", "schwarzschild"])
def test_adaptive_recorder_float32_matches_jax(family):
    jm, tm = FAMILIES[family]
    ac = np.degrees(tm.alpha_crit(R_OBS))
    traces = ttr.trace_ray_trajectories(
        tm, R_OBS, np.radians(ANGLES), dtype=torch.float32, device="cpu")
    checked = 0
    for deg, (traj, outcome) in zip(ANGLES, traces):
        want, joutcome = _jax_trajectory(jm, np.radians(deg), "float32")
        assert outcome == joutcome, deg
        if outcome != "escaped" or deg <= 1.05 * ac:
            continue
        n, nw = int(traj.n_valid), want["n_valid"]
        end, wend = traj.states[n - 1].double().numpy(), want["states"][nw - 1]
        for col in (1, 3):
            assert abs(end[col] - wend[col]) <= 1e-3 * abs(wend[col]), (
                deg, col, end[col], wend[col])
        checked += 1
    assert checked >= 6


@pytest.mark.parametrize("family", ["kerr", "schwarzschild"])
def test_fixed_recorder_float64_matches_jax(family):
    jm, tm = FAMILIES[family]
    for deg in (2.0, 8.0):
        traj, outcome = ttr.trace_ray_trajectory(
            tm, R_OBS, np.radians(deg), dtype=torch.float64,
            method="fixed", n_steps=600, device="cpu")
        want, joutcome = _jax_trajectory(jm, np.radians(deg), "float64",
                                         method="fixed", n_steps=600)
        assert outcome == joutcome
        assert int(traj.n_valid) == want["n_valid"]
        scale = np.abs(want["states"]).max()
        assert np.abs(traj.states.numpy() - want["states"]).max() \
            < 1e-9 * scale


@pytest.mark.parametrize("family", FAMILIES)
def test_trace_ray_matches_jax(family):
    jm, tm = FAMILIES[family]
    # Kerr-Newman and Johannsen-Psaltis take the same trace_batch route as
    # Kerr: three of the angles (a captured, a near and a far ray) each.
    angles = ((0.0, 4.0, 15.0) if family in ("kerr_newman",
                                              "johannsen_psaltis")
              else ANGLES)
    for deg in angles:
        with jax.enable_x64(True):
            wa, wn, wo = jm.trace_ray(R_OBS, np.radians(deg),
                                      dtype=jnp.float64)
        ga, gn, go = tm.trace_ray(R_OBS, np.radians(deg),
                                  dtype=torch.float64, device="cpu")
        assert (go, gn) == (wo, wn), deg
        if wo == "escaped":
            assert abs(ga - wa) < 1e-10, (deg, ga, wa)


def test_batched_trajectories_equal_single_ray():
    tm = Kerr(M=1.0, a=0.9)
    traces = ttr.trace_ray_trajectories(
        tm, R_OBS, np.radians(ANGLES[1:4]), dtype=torch.float64,
        device="cpu")
    for deg, (traj, outcome) in zip(ANGLES[1:4], traces):
        one, o1 = ttr.trace_ray_trajectory(tm, R_OBS, np.radians(deg),
                                           dtype=torch.float64, device="cpu")
        assert outcome == o1
        assert torch.equal(one.states, traj.states)
        assert torch.equal(one.lambdas, traj.lambdas)
        assert int(one.n_valid) == int(traj.n_valid)
    with pytest.raises(ValueError):
        ttr.trace_ray_trajectory(tm, R_OBS, 0.1, method="rk45",
                                 device="cpu")
