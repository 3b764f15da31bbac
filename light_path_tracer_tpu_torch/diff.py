"""Differentiable geodesic tracing: gradients through the integrator.

The counterpart of `light_path_tracer_tpu.diff`. The fixed-step RK4
comparison tracer (ops/kerr_rk4.py) with per-lane done-freezing (h = 0
once a lane is captured, escaped or invalid) is differentiable end to
end, so the sensitivity of the final deflection field to the scene,
d(final_alpha)/d(a, M, r_obs, theta_obs), comes from torch.autograd
instead of finite differences, and "which spin produced this deflection
field" becomes a least-squares fit.

  * (M, a) ride `models.TensorKerr`: tensors of the rays' dtype whose
    autograd graph flows through the initial conditions, the RHS, the
    capture radius and the angle extraction.
  * The event localisation (the linear interpolation onto the capture
    or escape radius) stays inside the graph: the crossing fraction is
    the implicit-function derivative of the stopping condition, smooth
    wherever the outcome is locally constant.
  * A lane that goes non-finite is replaced by its last state before
    anything downstream reads it, as the JAX package's `_select` does;
    a NaN excursion elsewhere would still poison the shared parameter
    gradient, so fits use escaping rays well away from the screen axes.
  * The JAX package runs a fixed-length `lax.scan` of n_steps steps.
    Once no lane is RUNNING every further step is the identity (h = 0
    everywhere), so the loop here stops there; the host asks every few
    steps. Values and gradients are those of the full-length scan.

`fit_scene_params` wraps the tracer in Levenberg-Marquardt: the residual
Jacobian column by column by reverse-mode AD, one pass per fitted
parameter (P <= 4; JAX's jacfwd makes P forward passes). The lanes are
independent, so a parameter given one copy a lane makes each lane's
residual depend on its own copy alone, and one backward pass of the
residuals' sum yields the whole column. The damped normal equations are
solved on the rays' device.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.kerr import TensorKerr, _scalar
from light_path_tracer_tpu_torch.ops.kerr_rk4 import _rk4_step
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    _SYNC_EVERY, CAPTURED, ESCAPED, INVALID, RUNNING, _all_finite, _lerp,
    _select)

#: Parameters fit_scene_params can fit, in the flat vector's order.
FITTABLE = ("a", "M", "r_obs", "theta_obs")


def trace_final_alpha_diff(M, a, r_obs, alphas, thetas, theta_obs,
                           n_steps: int = 2048, h_max: float = 0.5):
    """Differentiable batched Kerr trace -> (final_alpha, status).

    M, a, r_obs, theta_obs: Python numbers, 0-dim tensors (which may
    require grad) or (N,) tensors, one value a lane; alphas/thetas: (N,)
    screen angles on the device the trace runs on. status is ESCAPED,
    CAPTURED, INVALID or RUNNING (n_steps was too few for that lane);
    final_alpha is NaN where the lane did not escape.
    """
    M = _scalar(M, alphas)
    a = _scalar(a, alphas)
    r_obs = _scalar(r_obs, alphas)
    theta_obs = _scalar(theta_obs, alphas)
    metric = TensorKerr(M, a)

    r_capture = metric.capture_radius()
    r_escape = r_obs * 2.0

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)

    def rhs(y):
        return metric.rhs5(y, p_t, p_phi)

    status = torch.where(invalid0, INVALID, RUNNING).to(torch.int32)
    h_base = _scalar(h_max, alphas)
    zero = torch.zeros_like(alphas)
    one = torch.ones_like(alphas)
    y = torch.stack(y0)

    for step in range(n_steps):
        running = status == RUNNING
        if step % _SYNC_EVERY == 0 and not bool(running.any()):
            break
        # Near-horizon shrink (kerr_rk4's); h = 0 freezes finished lanes.
        r_curr = y[0]
        h = h_base.expand(alphas.shape)
        h = torch.where(r_curr < r_capture * 4.0,
                        torch.clamp(h, max=0.25), h)
        h = torch.where(r_curr < r_capture * 2.0,
                        torch.clamp(h, max=0.10), h)
        h = torch.where(r_curr < r_capture * 1.2,
                        torch.clamp(h, max=0.05), h)
        h = torch.where(running, h, zero)

        y_next = _rk4_step(rhs, y, h)
        ok = _all_finite(y_next) & (y_next[0] > 0.0)
        # Sanitised before anything downstream reads it: frozen or
        # failed lanes route no NaN into the lerp.
        y_next = _select(ok, y_next, y)

        adv = running & ok
        r_prev, r_next = y[0], y_next[0]
        cap = adv & (r_prev > r_capture) & (r_next <= r_capture)
        esc = adv & (r_prev < r_escape) & (r_next >= r_escape) & ~cap

        denom = r_next - r_prev
        safe_den = torch.where(denom == 0.0, one, denom)
        target = torch.where(cap, r_capture, r_escape)
        frac = torch.where(
            (denom == 0.0) | ~(cap | esc), one,
            torch.clamp((target - r_prev) / safe_den, 0.0, 1.0))
        y_evt = _lerp(y, y_next, frac)
        y = _select(adv, _select(cap | esc, y_evt, y_next), y)

        status = torch.where(
            running & ~ok, INVALID,
            torch.where(cap, CAPTURED,
                        torch.where(esc, ESCAPED, status))).to(torch.int32)

    captured = status == CAPTURED
    ext_status, final_alpha, _n_half = metric.extract_angle(
        y, p_t, p_phi, captured)
    escaped = (status == ESCAPED) & (ext_status == 1)
    final_alpha = torch.where(escaped, final_alpha,
                              torch.full_like(final_alpha, np.nan))
    # A degenerate extraction on an escaped lane is INVALID, as in the
    # tracers (ops/kerr_trace.py finalize_angles).
    status_out = torch.where(
        escaped, ESCAPED,
        torch.where((status == ESCAPED) & (ext_status == 0), INVALID,
                    status)).to(torch.int32)
    return final_alpha, status_out


def _params_vector(params, defaults, like):
    """(values in FITTABLE order, free names, fixed 0-dim tensors)."""
    free = [k for k in FITTABLE if k in params]
    vec = torch.tensor([float(params[k]) for k in free], dtype=like.dtype,
                       device=like.device)
    fixed = {k: _scalar(v, like) for k, v in defaults.items()
             if k not in free}
    return vec, free, fixed


def fit_scene_params(observed_alpha, alphas, thetas, init_params,
                     fixed_params, *, n_steps: int = 2048,
                     h_max: float = 0.5, iters: int = 20,
                     tol: float = 1e-14):
    """Recover scene parameters from an observed deflection field by
    Levenberg-Marquardt over the masked final-alpha residuals.

    observed_alpha: (N,) observed final viewing angles (NaN: lost, masked
    out); alphas, thetas: (N,) screen coordinates of those rays, on the
    device to trace on; init_params: starting guesses of the parameters
    to fit (keys from FITTABLE); fixed_params: the rest of M, a, r_obs,
    theta_obs. The Jacobian comes from reverse-mode AD, one pass per
    parameter (module docstring); the damping divides by 3 after an
    accepted step and multiplies by 10 after a rejected one. Returns
    (fitted dict, loss history) with loss the masked mean squared
    residual (rad^2).
    """
    obs = torch.as_tensor(observed_alpha)
    alphas = torch.as_tensor(alphas, dtype=obs.dtype, device=obs.device)
    thetas = torch.as_tensor(thetas, dtype=obs.dtype, device=obs.device)
    obs_ok = torch.isfinite(obs)
    obs_filled = torch.where(obs_ok, obs, torch.zeros_like(obs))
    vec0, free, fixed = _params_vector(init_params, fixed_params, obs)

    def residual(vec, lanes=None):
        """The masked residuals; lanes = (i, (N,) tensor) gives free
        parameter i one value a lane."""
        p = dict(fixed)
        for i, k in enumerate(free):
            p[k] = vec[i]
        if lanes is not None:
            p[free[lanes[0]]] = lanes[1]
        pred, status = trace_final_alpha_diff(
            p["M"], p["a"], p["r_obs"], alphas, thetas, p["theta_obs"],
            n_steps=n_steps, h_max=h_max)
        ok = obs_ok & (status == ESCAPED)
        n = torch.clamp(ok.sum(), min=1).to(obs.dtype)
        return torch.where(ok, pred - obs_filled,
                           torch.zeros_like(pred)) / torch.sqrt(n)

    def res_and_jac(vec):
        """The residuals and their (N, P) Jacobian, column by column."""
        cols, r = [], None
        for i in range(len(free)):
            copies = vec[i].expand(obs.shape).clone().requires_grad_()
            with torch.enable_grad():
                out = residual(vec, (i, copies))
                (col,) = torch.autograd.grad(out.sum(), copies)
            r = out.detach()
            cols.append(col)
        return r, torch.stack(cols, dim=1)

    def loss_of(vec):
        return float((residual(vec) ** 2).sum())

    def clip_physical(vec):
        # |a| < M keeps the horizon real.
        if "a" in free:
            i = free.index("a")
            m_now = float(vec[free.index("M")] if "M" in free
                          else fixed["M"])
            vec = vec.clone()
            vec[i] = torch.clamp(vec[i], -0.998 * m_now, 0.998 * m_now)
        return vec

    with torch.no_grad():
        vec = vec0
        lam = 1e-3
        history = [loss_of(vec)]
        for _ in range(iters):
            r, J = res_and_jac(vec)
            g = J.T @ r
            H = J.T @ J
            accepted = False
            for _retry in range(8):
                delta = torch.linalg.solve(
                    H + lam * torch.eye(len(vec), dtype=vec.dtype,
                                        device=vec.device), g)
                cand = clip_physical(vec - delta)
                cand_loss = loss_of(cand)
                if np.isfinite(cand_loss) and cand_loss < history[-1]:
                    vec, lam, accepted = cand, max(lam / 3.0, 1e-12), True
                    history.append(cand_loss)
                    break
                lam *= 10.0
            if not accepted or history[-1] < tol:
                break
    return {k: float(vec[i]) for i, k in enumerate(free)}, history
