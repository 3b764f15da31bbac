"""Batched Schwarzschild orbit-equation tracer, plain PyTorch.

The plain version of the CUDA orbit kernel
(ops/cuda/schwarzschild_kernel.py) and the counterpart of
`light_path_tracer_tpu.ops.schwarzschild_trace`. One masked loop advances
the whole batch through the reduced orbit ODE u''(phi) = -u + 3 M u^2
(the metric's `orbit_rhs`; Reissner-Nordstrom adds -2 Q^2 u^3) with
fixed-step RK4, h = clip(phi_max - phi, 0, h_max), at most
ceil(phi_max / h_max) steps. Each step checks for capture (u crosses
1 / (1.01 R_S)) and escape (u crosses 1 / (2 r_obs)), and on a crossing
moves u onto it and w and phi by the same linear fraction of the step.
The escape heading then gives the final angle (`orbit_extract_angle`).

Status codes: 1 escaped, -1 captured, 0 invalid, 2 running (rays still
running at phi_max fold into escaped at extraction). Finished lanes are
frozen by masking and every lane counts its own steps, so a lane's result
does not depend on the rest of the batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from light_path_tracer_tpu_torch.ops.kerr_trace import warp_step_sum
from light_path_tracer_tpu_torch.ops.types import TraceResult

RUNNING = 2
ESCAPED = 1
CAPTURED = -1
INVALID = 0

# The masked loop asks the device whether any lane still runs only every
# this many steps: the question costs a host sync, and the extra steps
# leave finished lanes untouched.
_SYNC_EVERY = 8


def _lerp_frac(prev, nxt, target):
    """Fraction of the step at which `prev -> nxt` crosses `target`."""
    denom = nxt - prev
    flat = denom == 0.0
    one = torch.ones_like(denom)
    frac = torch.where(flat, one,
                       (target - prev) / torch.where(flat, one, denom))
    return torch.clamp(frac, 0.0, 1.0)


def orbit_constants(metric, r_obs, phi_max, h_max):
    """Host-side loop constants: (u_capture, u_escape, n_steps), the
    radii as float64 values that a caller rounds once to its dtype."""
    u_capture = 1.0 / (metric.R_S * 1.01)
    u_escape = 1.0 / (2.0 * r_obs)
    n_steps = int(np.ceil(phi_max / h_max))
    return u_capture, u_escape, n_steps


def fold_status(metric, phi_f, u_f, w_f, status_f):
    """Final orbit state -> (final_alpha, n_half_orbits, status).

    Rays still running at phi_max fold into escaped; the radius check
    (r_f <= 1.1 R_S) reclassifies them and escaped rays as captured;
    final_alpha is NaN unless the ray escaped.
    """
    final_alpha, n_half, captured_by_radius = metric.orbit_extract_angle(
        phi_f, u_f, w_f)
    escaped_like = (status_f == ESCAPED) | (status_f == RUNNING)
    captured = (status_f == CAPTURED) | (escaped_like & captured_by_radius)
    invalid_f = status_f == INVALID
    status_out = torch.where(
        invalid_f, INVALID,
        torch.where(captured, CAPTURED, ESCAPED)).to(torch.int32)
    final_alpha = torch.where(status_out == ESCAPED, final_alpha,
                              torch.full_like(final_alpha, math.nan))
    n_half = torch.where(invalid_f, torch.zeros_like(n_half), n_half)
    return final_alpha, n_half, status_out


def trace_rays_schwarzschild(metric, r_obs, alphas, phi_max: float = 50.0,
                             h_max: float = 0.05, return_steps: bool = False):
    """Trace a batch of spherically symmetric rays; returns TraceResult.

    alphas: (N,) viewing angles (radians), float32 or float64, on any
    device. n_steps follows the TraceResult contract (the sum over
    32-ray warps of the warp's largest per-ray step count). With
    return_steps=True, returns (TraceResult, per-ray int32 step counts).
    """
    trace_rays_schwarzschild.launches += 1
    dtype, device = alphas.dtype, alphas.device

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=device)

    u, w, invalid = metric.orbit_initial_state(float(r_obs), alphas)
    u_cap_f, u_esc_f, n_steps = orbit_constants(metric, float(r_obs),
                                                phi_max, h_max)
    u_capture, u_escape = scalar(u_cap_f), scalar(u_esc_f)
    phi_max_a, h_max_a = scalar(phi_max), scalar(h_max)
    zero = scalar(0.0)

    status = torch.where(invalid, INVALID, RUNNING).to(torch.int32)
    phi = torch.zeros_like(alphas)
    steps = torch.zeros_like(status)
    rhs = metric.orbit_rhs

    for step in range(n_steps):
        active = status == RUNNING
        if step % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        h = torch.clamp(torch.minimum(h_max_a, phi_max_a - phi), min=zero)

        k1u, k1w = rhs(u, w)
        k2u, k2w = rhs(u + 0.5 * h * k1u, w + 0.5 * h * k1w)
        k3u, k3w = rhs(u + 0.5 * h * k2u, w + 0.5 * h * k2w)
        k4u, k4w = rhs(u + h * k3u, w + h * k3w)
        u_next = u + (h / 6.0) * (k1u + 2.0 * k2u + 2.0 * k3u + k4u)
        w_next = w + (h / 6.0) * (k1w + 2.0 * k2w + 2.0 * k3w + k4w)

        cap = (u < u_capture) & (u_next >= u_capture)
        esc = (u > u_escape) & (u_next <= u_escape) & ~cap
        one = torch.ones_like(u)
        frac = torch.where(cap, _lerp_frac(u, u_next, u_capture),
                           torch.where(esc, _lerp_frac(u, u_next, u_escape),
                                       one))
        u_new = torch.where(cap, u_capture,
                            torch.where(esc, u_escape, u_next))
        w_new = w + frac * (w_next - w)
        phi_new = phi + frac * h
        status_new = torch.where(cap, CAPTURED,
                                 torch.where(esc, ESCAPED, status)).to(
                                     torch.int32)

        u = torch.where(active, u_new, u)
        w = torch.where(active, w_new, w)
        phi = torch.where(active, phi_new, phi)
        status = torch.where(active, status_new, status)
        steps = steps + active.to(steps.dtype)

    final_alpha, n_half, status_out = fold_status(metric, phi, u, w, status)
    res = TraceResult(final_alpha, n_half, status_out, warp_step_sum(steps))
    return (res, steps) if return_steps else res


# Calls of the plain loop, so a run can show which path it took.
trace_rays_schwarzschild.launches = 0
