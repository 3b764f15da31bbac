"""Fixed-step RK4 Kerr tracer: the comparison integrator, plain PyTorch.

The counterpart of `light_path_tracer_tpu.ops.kerr_rk4`, selected by
`trace_batch(integrator="rk4")` (RenderConfig.integrator, `--integrator
rk4`) on any device. The JAX package runs it as XLA, outside its Pallas
kernels, so it has no CUDA kernel here either: on a CUDA tensor this loop
is the path. Semantics, lane by lane:

  * base step h_max (1.0), 0.5 under axis_refine, with a floor of 0.02
    (0.01 refined);
  * near-horizon shrinking: h <= 0.25 / 0.10 / 0.05 (0.20 / 0.08 / 0.03
    refined) inside r < 4 / 2 / 1.2 x r_capture, then h <= lambda_max -
    lambda;
  * a non-finite step (or r <= 0) halves the next try, down to the floor,
    where the ray is INVALID;
  * capture (r <= r_capture) and escape (r >= 2 r_obs) are located by
    linear interpolation of the state on the step.

n_steps is the loop's iteration count, as the JAX package's while_loop
counts it: iterations run while any lane is RUNNING below lambda_max, at
most max_steps. The host asks the device whether a lane still runs only
every few iterations; the iterations between run no lane, leave every
state as it was and are not counted. On the card those blocks of
iterations replay as CUDA graphs (ops/graphs.py), bitwise the eager
loop.
"""

from __future__ import annotations

import math

import torch

from light_path_tracer_tpu_torch.ops.graphs import step_blocks
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    _SYNC_EVERY, CAPTURED, ESCAPED, INVALID, RUNNING, _all_finite, _axpy,
    _lerp, _select, _wsum)
from light_path_tracer_tpu_torch.ops.types import TraceResult


def _rk4_step(rhs, y, h):
    """One classical RK4 step of the (5, N) state with per-lane h."""
    k1 = rhs(y)
    k2 = rhs(_axpy(y, _wsum(h, [k1], [0.5])))
    k3 = rhs(_axpy(y, _wsum(h, [k2], [0.5])))
    k4 = rhs(_axpy(y, _wsum(h, [k3], [1.0])))
    return _axpy(y, (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))


def trace_rays_kerr_rk4(metric, r_obs, alphas, thetas, theta_obs,
                        axis_refine, lambda_max: float,
                        max_steps: int = 200000, h_max: float = 1.0):
    """Fixed-step RK4 batch tracer on the tensors' device; the same
    TraceResult contract as the adaptive tracers, with n_steps the
    iteration count (int64)."""
    trace_rays_kerr_rk4.launches += 1
    dtype, device = alphas.dtype, alphas.device

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=device)

    r_capture = scalar(metric.capture_radius())
    r_escape = scalar(r_obs * 2.0)
    lam_max = scalar(lambda_max)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)

    def rhs(y):
        return metric.rhs5(y, p_t, p_phi)

    status = torch.where(invalid0, INVALID, RUNNING).to(torch.int32)

    def per_lane(refined, plain):
        return torch.where(axis_refine, scalar(refined), scalar(plain))

    h_base = per_lane(min(h_max, 0.5), h_max)
    h_floor = per_lane(min(0.01, h_max), min(0.02, h_max))
    shr1 = per_lane(0.20, 0.25)
    shr2 = per_lane(0.08, 0.10)
    shr3 = per_lane(0.03, 0.05)

    one = scalar(1.0)

    def step(carry):
        y, lam, status, scale, steps = carry
        running = (status == RUNNING) & (lam < lam_max)
        steps = steps + running.any().to(torch.int64)

        r_curr = y[0]
        h = h_base
        h = torch.where(r_curr < r_capture * 4.0, torch.minimum(h, shr1), h)
        h = torch.where(r_curr < r_capture * 2.0, torch.minimum(h, shr2), h)
        h = torch.where(r_curr < r_capture * 1.2, torch.minimum(h, shr3), h)
        h = torch.minimum(h, lam_max - lam)
        h = torch.clamp(h * scale, min=0.0)

        y_next = _rk4_step(rhs, y, h)
        ok = _all_finite(y_next) & (y_next[0] > 0.0)

        # Failure: halve and retry next iteration; at the floor, INVALID.
        fail = running & ~ok
        dead = fail & (h * 0.5 <= h_floor)
        scale = torch.where(fail, scale * 0.5, one)

        adv = running & ok
        r_prev, r_next = y[0], y_next[0]
        cap = adv & (r_prev > r_capture) & (r_next <= r_capture)
        esc = adv & (r_prev < r_escape) & (r_next >= r_escape) & ~cap

        denom = r_next - r_prev
        safe_den = torch.where(denom == 0.0, one, denom)
        frac = torch.where(
            denom == 0.0, one,
            torch.where(cap, torch.clamp((r_capture - r_prev) / safe_den,
                                         0.0, 1.0),
                        torch.where(esc, torch.clamp(
                            (r_escape - r_prev) / safe_den, 0.0, 1.0),
                            one)))
        y_evt = _lerp(y, y_next, frac)
        y_out = _select(adv, _select(cap | esc, y_evt, y_next), y)
        lam = torch.where(adv, lam + frac * h, lam)

        corrupt = adv & ~_all_finite(y_out[0:5])
        status = torch.where(cap, CAPTURED, torch.where(esc, ESCAPED,
                                                        status))
        status = torch.where(dead | corrupt, INVALID, status).to(torch.int32)
        return (y_out, lam, status, scale, steps), ()

    def keep_going(carry):
        _y, lam, status = carry[:3]
        return bool(((status == RUNNING) & (lam < lam_max)).any())

    carry = (torch.stack(y0), torch.zeros_like(alphas), status,
             torch.ones_like(alphas),     # halving-on-retry multiplier
             torch.zeros((), dtype=torch.int64, device=device))
    (y, _lam, status, _scale, steps), _ = step_blocks(
        step, carry, max_steps, keep_going, block=_SYNC_EVERY)

    captured = status == CAPTURED
    ext_status, final_alpha, n_half = metric.extract_angle(
        y, p_t, p_phi, captured)
    invalid_f = (status == INVALID) | (ext_status == 0)
    cap_f = ~invalid_f & (ext_status == -1)
    status_out = torch.where(
        invalid_f, INVALID,
        torch.where(cap_f, CAPTURED, ESCAPED)).to(torch.int32)
    final_alpha = torch.where(status_out == ESCAPED, final_alpha,
                              torch.full_like(final_alpha, math.nan))
    n_half = torch.where(invalid_f & (status == INVALID),
                         torch.zeros_like(n_half), n_half)
    return TraceResult(final_alpha, n_half, status_out, steps)


# Calls of the loop, so a run can show which path it took.
trace_rays_kerr_rk4.launches = 0
