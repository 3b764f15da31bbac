"""The port's differentiable tracer (light_path_tracer_tpu_torch/diff.py)
against the JAX package's.

Inputs: the screen fans of tests/test_diff.py (alpha in [0.30, 0.60] rad
or [0.45, 1.0] for the fit, theta off the screen axes) at r_obs = 20 M,
theta_obs = 80 deg, float64 on the CPU. Criteria:
  * trace_final_alpha_diff: equal statuses, final alpha within 1e-10 of
    JAX's;
  * d(mean final alpha)/da by torch.autograd within 1e-8 relative of
    jax.grad on 6 rays at n_steps 256; one value of a a lane gives each
    lane's derivative (the fit's Jacobian column), whose mean equals it
    at 1e-12; the gradients in M and r_obs finite and nonzero;
  * a short fit_scene_params run (12 rays, 3 iterations) from a = 0.35
    towards a = 0.7: the loss falls by 1e3 and a moves within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import diff as jdiff
from light_path_tracer_tpu_torch import diff

R_OBS = 20.0
THETA_OBS = float(np.radians(80.0))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rays(n_alpha=4, n_theta=6, lo=0.30, hi=0.60):
    al = np.linspace(lo, hi, n_alpha)
    th = np.linspace(0.2, 2 * np.pi - 0.2, n_theta, endpoint=False)
    A, T = np.meshgrid(al, th)
    return A.ravel(), T.ravel()


def test_trace_matches_jax():
    al, th = _rays()
    with jax.enable_x64(True):
        wa, ws = jdiff.trace_final_alpha_diff(
            1.0, 0.7, R_OBS, jnp.asarray(al), jnp.asarray(th), THETA_OBS,
            n_steps=1024, h_max=0.5)
        wa, ws = np.asarray(wa), np.asarray(ws)
    ga, gs = diff.trace_final_alpha_diff(1.0, 0.7, R_OBS, torch.tensor(al),
                                         torch.tensor(th), THETA_OBS,
                                         n_steps=1024, h_max=0.5)
    np.testing.assert_array_equal(gs.numpy(), ws)
    esc = ws == 1
    assert esc.sum() >= 0.8 * len(esc)
    np.testing.assert_allclose(ga.numpy()[esc], wa[esc], rtol=0, atol=1e-10)


def _mean_alpha_torch(a, al, th):
    fa, st = diff.trace_final_alpha_diff(1.0, a, R_OBS, al, th, THETA_OBS,
                                         n_steps=256, h_max=0.5)
    ok = st == 1
    return torch.where(ok, fa, torch.zeros_like(fa)).sum() / ok.sum()


def test_grad_matches_jax_grad():
    al, th = _rays(n_alpha=2, n_theta=3)

    def mean_alpha(a):
        fa, st = jdiff.trace_final_alpha_diff(
            1.0, a, R_OBS, jnp.asarray(al), jnp.asarray(th), THETA_OBS,
            n_steps=256, h_max=0.5)
        ok = st == 1
        return jnp.sum(jnp.where(ok, fa, 0.0)) / jnp.maximum(jnp.sum(ok), 1)

    with jax.enable_x64(True):
        want = float(jax.grad(mean_alpha)(jnp.asarray(0.6, jnp.float64)))
    a = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    tal, tth = torch.tensor(al), torch.tensor(th)
    (got,) = torch.autograd.grad(_mean_alpha_torch(a, tal, tth), a)
    assert abs(float(got) - want) <= 1e-8 * abs(want)
    lanes = torch.full((len(al),), 0.6, dtype=torch.float64,
                       requires_grad=True)
    fa, st = diff.trace_final_alpha_diff(1.0, lanes, R_OBS, tal, tth,
                                         THETA_OBS, n_steps=256, h_max=0.5)
    (col,) = torch.autograd.grad(
        torch.where(st == 1, fa, torch.zeros_like(fa)).sum(), lanes)
    assert bool((st == 1).all())
    assert abs(float(col.mean()) - float(got)) <= 1e-12 * abs(float(got))

    M = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    r = torch.tensor(R_OBS, dtype=torch.float64, requires_grad=True)
    fa, st = diff.trace_final_alpha_diff(M, 0.5, r, tal, tth, THETA_OBS,
                                         n_steps=256, h_max=0.5)
    gM, gR = torch.autograd.grad(
        torch.where(st == 1, fa, torch.zeros_like(fa)).sum(), (M, r))
    assert torch.isfinite(gM) and torch.isfinite(gR) and float(gM) != 0.0


def test_fit_moves_towards_the_spin():
    al, th = _rays(n_alpha=2, n_theta=6, lo=0.45, hi=1.0)
    tal, tth = torch.tensor(al), torch.tensor(th)
    observed, _ = diff.trace_final_alpha_diff(1.0, 0.7, R_OBS, tal, tth,
                                              THETA_OBS, n_steps=1024,
                                              h_max=0.5)
    fitted, history = diff.fit_scene_params(
        observed, tal, tth, init_params={"a": 0.35},
        fixed_params={"M": 1.0, "r_obs": R_OBS, "theta_obs": THETA_OBS},
        n_steps=1024, h_max=0.5, iters=3)
    assert history[-1] < history[0] * 1e-3
    assert abs(fitted["a"] - 0.7) < 2e-2
    assert list(fitted) == ["a"]
