"""Full-trajectory geodesic integration on the public 8-D state.

The counterpart of `light_path_tracer_tpu.trajectory`: integrate
[t, r, theta, phi, p_t, p_r, p_theta, p_phi] with terminal capture and
escape events and return the whole path, for the trajectory plots
(`ray`, `plot`), the timelike orbits (particles.py) and conservation
checks; the tracers return only the final angle.

The JAX package records the path with a fixed-length `lax.scan` of
masked attempts. Here a Python loop makes the same attempts on the
tensors' device, plain PyTorch (no Pallas kernel runs on this path in
the JAX package either), and writes each into the same record:
`(n_steps + 1, ..., 8)` states and `lambdas`, rejected attempts
re-recording the current point, then the stable compaction that moves
the accepted samples to the front, so `states[:n_valid]` is the path.
Once every lane is done the remaining attempts could only re-record the
final point; the loop stops there (the host asks only every few
attempts) and fills the rest of the record with it, as the scan would.
On the card the blocks of attempts between the host's questions replay
as CUDA graphs (ops/graphs.py): the same kernels, bitwise the same path.
Every operation is elementwise per lane (the error norm sums its eight
components in order), so a lane's record does not depend on the rest of
the batch: `trace_ray_trajectories` traces several rays in one loop and
each equals its single-ray `trace_ray_trajectory`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from light_path_tracer_tpu_torch.ops import tableau as tb
from light_path_tracer_tpu_torch.ops.graphs import step_blocks

# Attempts between the host's questions whether any lane still runs.
_SYNC_EVERY = 8


class Trajectory(NamedTuple):
    states: torch.Tensor    # (n_steps+1, ..., 8) recorded path
    lambdas: torch.Tensor   # (n_steps+1, ...) affine parameter
    outcome: torch.Tensor   # (...,) int32: 1 escaped, -1 captured, 0 invalid
    n_valid: torch.Tensor   # (...,) int32 number of live samples


def _all_finite8(s):
    return torch.isfinite(s).all(dim=-1)


def _outcome(s_f, r_stop_inner):
    final_r = s_f[..., 1]
    return torch.where(final_r <= r_stop_inner * 1.1, -1,
                       torch.where(_all_finite8(s_f), 1, 0)).to(torch.int32)


def integrate_geodesic_8d_adaptive(metric, state0, *, r_obs,
                                   n_steps: int = 2000,
                                   rtol: float = 1e-8, atol: float = 1e-10):
    """Adaptive DP45 path recorder on the public 8-D state.

    The reference's scipy RK45 tolerances (rtol 1e-8 / atol 1e-10),
    terminal capture (r <= capture_radius) and escape (r >= 2 r_obs)
    events placed on the step's cubic Hermite interpolant, and every
    attempt slot recorded; rejected attempts re-record the current point.

    state0: (..., 8), batched over the leading axes, on any device.
    """
    r_stop_inner = metric.capture_radius()
    r_stop_outer = 2.0 * float(r_obs)
    dtype, device = state0.dtype, state0.device
    lead = state0.shape[:-1]

    def rhs(s):
        return metric.geodesic_equations(0.0, s)

    h0 = torch.full(lead, 0.1, dtype=dtype, device=device)
    lam0 = torch.zeros(lead, dtype=dtype, device=device)
    done0 = torch.zeros(lead, dtype=torch.bool, device=device)
    path = torch.empty((n_steps,) + tuple(state0.shape), dtype=dtype,
                       device=device)
    lams = torch.empty((n_steps,) + tuple(lead), dtype=dtype, device=device)
    live = torch.zeros((n_steps,) + tuple(lead), dtype=torch.bool,
                       device=device)
    one = torch.ones((), dtype=dtype, device=device)

    def attempt(carry):
        s, k1, h, lam, done = carry
        hh = h[..., None]
        k2 = rhs(s + hh * tb.A21 * k1)
        k3 = rhs(s + hh * (tb.A31 * k1 + tb.A32 * k2))
        k4 = rhs(s + hh * (tb.A41 * k1 + tb.A42 * k2 + tb.A43 * k3))
        k5 = rhs(s + hh * (tb.A51 * k1 + tb.A52 * k2 + tb.A53 * k3
                           + tb.A54 * k4))
        k6 = rhs(s + hh * (tb.A61 * k1 + tb.A62 * k2 + tb.A63 * k3
                           + tb.A64 * k4 + tb.A65 * k5))
        s5 = s + hh * (tb.B1 * k1 + tb.B3 * k3 + tb.B4 * k4
                       + tb.B5 * k5 + tb.B6 * k6)
        k7 = rhs(s5)

        err = hh * (tb.E1 * k1 + tb.E3 * k3 + tb.E4 * k4
                    + tb.E5 * k5 + tb.E6 * k6 + tb.E7 * k7)
        sc = atol + rtol * torch.maximum(torch.abs(s), torch.abs(s5))
        q = err / sc
        q2 = q * q
        # The mean of the eight squares, summed in order: elementwise per
        # lane, whatever the batch's shape.
        acc = q2[..., 0]
        for c in range(1, 8):
            acc = acc + q2[..., c]
        err_norm = torch.sqrt(acc / 8.0)
        finite = _all_finite8(s5)
        accept = ~done & finite & (err_norm <= 1.0)

        r_prev, r_next = s[..., 1], s5[..., 1]
        cap = accept & (r_prev > r_stop_inner) & (r_next <= r_stop_inner)
        esc = accept & (r_prev < r_stop_outer) & (r_next >= r_stop_outer)
        den = torch.where(r_next == r_prev, one, r_next - r_prev)
        frac = torch.where(
            cap, torch.clamp((r_stop_inner - r_prev) / den, 0.0, 1.0),
            torch.where(esc, torch.clamp((r_stop_outer - r_prev) / den,
                                         0.0, 1.0), one))
        # Cubic-Hermite event interpolation from the step's end
        # derivatives (k1 and the FSAL stage k7): the terminal sample
        # stays on the solution manifold, unlike a linear lerp.
        fr = frac[..., None]
        fr2 = fr * fr
        fr3 = fr2 * fr
        s_interp = ((2 * fr3 - 3 * fr2 + 1) * s
                    + (fr3 - 2 * fr2 + fr) * hh * k1
                    + (-2 * fr3 + 3 * fr2) * s5
                    + (fr3 - fr2) * hh * k7)
        s_new = torch.where((cap | esc)[..., None], s_interp, s5)

        factor = 0.9 * torch.clamp(err_norm, min=1e-30) ** (-0.2)
        h_new = torch.where(accept, h * torch.clamp(factor, 0.2, 5.0),
                            torch.where(~done & finite,
                                        h * torch.clamp(factor, min=0.2),
                                        h * 0.25))
        h_new = torch.clamp(h_new, max=1.0 * r_stop_outer)

        s_out = torch.where(accept[..., None], s_new, s)
        k1_out = torch.where((accept & ~(cap | esc))[..., None], k7, k1)
        lam_out = torch.where(accept, lam + frac * h, lam)
        done_out = done | cap | esc | ~finite
        return ((s_out, k1_out, h_new, lam_out, done_out),
                (s_out, lam_out, accept & ~done))

    def sink(i, recs):
        n = recs[0].shape[0]
        path[i:i + n], lams[i:i + n], live[i:i + n] = recs

    (s, _k1, _h, lam, _done), i = step_blocks(
        attempt, (state0, rhs(state0), h0, lam0, done0), n_steps,
        lambda carry: not bool(carry[4].all()), sink, block=_SYNC_EVERY)
    # Every lane is done: the scan's remaining slots re-record the end.
    path[i:] = s
    lams[i:] = lam

    states = torch.cat([state0[None], path], dim=0)
    lambdas = torch.cat([torch.zeros((1,) + tuple(lead), dtype=dtype,
                                     device=device), lams], dim=0)
    live_full = torch.cat(
        [torch.ones((1,) + tuple(lead), dtype=torch.bool, device=device),
         live], dim=0)
    # Compaction: the accepted samples to the front (stable), so
    # states[:n_valid] is the path.
    order = torch.argsort((~live_full).to(torch.uint8), dim=0, stable=True)
    states = torch.take_along_dim(states, order[..., None].expand(
        states.shape), dim=0)
    lambdas = torch.take_along_dim(lambdas, order, dim=0)
    n_valid = live_full.sum(dim=0).to(torch.int32)
    return Trajectory(states, lambdas, _outcome(s, r_stop_inner), n_valid)


def integrate_geodesic_8d(metric, state0, *, r_obs, n_steps: int = 4000,
                          h_base: float = 0.5):
    """Integrate 8-D states (..., 8) with a curvature-scheduled RK4 step
    (h_base x clip((r - r_in) / (10 r_in), 0.02, 1)) and capture
    (r <= capture_radius) / escape (r >= 2 r_obs) stopping."""
    r_stop_inner = metric.capture_radius()
    r_stop_outer = 2.0 * float(r_obs)
    dtype, device = state0.dtype, state0.device
    lead = state0.shape[:-1]
    h_base = torch.full((), float(h_base), dtype=dtype, device=device)

    def rhs(s):
        return metric.geodesic_equations(0.0, s)

    path = torch.empty((n_steps,) + tuple(state0.shape), dtype=dtype,
                       device=device)
    lams = torch.empty((n_steps,) + tuple(lead), dtype=dtype, device=device)
    dones = torch.ones((n_steps,) + tuple(lead), dtype=torch.bool,
                       device=device)

    def step(carry):
        s, lam, done = carry
        r = s[..., 1]
        h = h_base * torch.clamp((r - r_stop_inner) / (10.0 * r_stop_inner),
                                 0.02, 1.0)
        h = torch.where(done, torch.zeros_like(h), h)[..., None]

        k1 = rhs(s)
        k2 = rhs(s + 0.5 * h * k1)
        k3 = rhs(s + 0.5 * h * k2)
        k4 = rhs(s + h * k3)
        s_next = s + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

        r_next = s_next[..., 1]
        newly_done = ((r_next <= r_stop_inner) | (r_next >= r_stop_outer)
                      | ~_all_finite8(s_next))
        s_out = torch.where(done[..., None], s, s_next)
        lam_out = torch.where(done, lam, lam + h[..., 0])
        done_out = done | newly_done
        return (s_out, lam_out, done_out), (s_out, lam_out, done_out)

    def sink(i, recs):
        n = recs[0].shape[0]
        path[i:i + n], lams[i:i + n], dones[i:i + n] = recs

    (s, lam, _done), i = step_blocks(
        step, (state0, torch.zeros(lead, dtype=dtype, device=device),
               torch.zeros(lead, dtype=torch.bool, device=device)),
        n_steps, lambda carry: not bool(carry[2].all()), sink,
        block=_SYNC_EVERY)
    path[i:] = s
    lams[i:] = lam

    states = torch.cat([state0[None], path], dim=0)
    lambdas = torch.cat([torch.zeros((1,) + tuple(lead), dtype=dtype,
                                     device=device), lams], dim=0)
    n_valid = 1 + (~dones).sum(dim=0).to(torch.int32)
    return Trajectory(states, lambdas, _outcome(s, r_stop_inner), n_valid)


_OUTCOMES = {1: "escaped", -1: "captured", 0: "invalid"}


def trace_ray_trajectories(metric, r_obs, alphas, theta=0.0,
                           theta_obs=math.pi / 2, n_steps: int = 4000,
                           h_base: float = 0.5, dtype=torch.float32,
                           method: str = "adaptive", device=None):
    """Several single-ray traces in one loop: a list of (Trajectory,
    outcome) per alpha, each equal to `trace_ray_trajectory`'s for that
    alpha ((None, "invalid") where the launch is invalid)."""
    if method not in ("adaptive", "fixed"):
        raise ValueError(f"method must be 'adaptive' or 'fixed', got "
                         f"{method!r}")
    device = torch.device("cuda" if device is None else device)
    alpha_arr = torch.as_tensor(np.asarray(alphas, np.float64).reshape(-1),
                                dtype=dtype, device=device)
    state8, invalid = metric.initial_conditions_8d(
        float(r_obs), alpha_arr, theta, theta_obs)
    bad = invalid.cpu().numpy()
    keep = np.flatnonzero(~bad)
    out = [(None, "invalid")] * len(bad)
    if keep.size == 0:
        return out
    start = state8[torch.as_tensor(keep, device=device)]
    if method == "adaptive":
        traj = integrate_geodesic_8d_adaptive(
            metric, start, r_obs=float(r_obs), n_steps=min(n_steps, 2000))
    else:
        traj = integrate_geodesic_8d(
            metric, start, r_obs=float(r_obs), n_steps=n_steps,
            h_base=h_base)
    outcomes = traj.outcome.cpu().numpy()
    for j, i in enumerate(keep):
        one = Trajectory(traj.states[:, j], traj.lambdas[:, j],
                         traj.outcome[j], traj.n_valid[j])
        out[i] = (one, _OUTCOMES[int(outcomes[j])])
    return out


def trace_ray_trajectory(metric, r_obs, alpha, theta=0.0,
                         theta_obs=math.pi / 2, n_steps: int = 4000,
                         h_base: float = 0.5, dtype=torch.float32,
                         method: str = "adaptive", device=None):
    """Single-ray full-path trace. method: 'adaptive' (DP45 at the
    reference's tolerances, at most 2,000 attempts) or 'fixed'
    (curvature-scheduled RK4). device: None traces on the card.
    Returns (Trajectory, outcome) with outcome 'captured' | 'escaped' |
    'invalid' (Trajectory None for an invalid launch)."""
    device = torch.device("cuda" if device is None else device)
    alpha_arr = torch.tensor([alpha], dtype=dtype, device=device)
    state8, invalid = metric.initial_conditions_8d(
        float(r_obs), alpha_arr, theta, theta_obs)
    if bool(invalid[0]):
        return None, "invalid"
    if method == "adaptive":
        traj = integrate_geodesic_8d_adaptive(
            metric, state8[0], r_obs=float(r_obs),
            n_steps=min(n_steps, 2000))
    elif method == "fixed":
        traj = integrate_geodesic_8d(
            metric, state8[0], r_obs=float(r_obs), n_steps=n_steps,
            h_base=h_base)
    else:
        raise ValueError(f"method must be 'adaptive' or 'fixed', got "
                         f"{method!r}")
    return traj, _OUTCOMES[int(traj.outcome)]


def plot_trajectories(metric, r_obs, angles_deg, ax=None,
                      dtype=torch.float32, device=None, traces=None):
    """Equatorial-plane trajectory overlay of one ray a viewing angle
    (degrees), traced together (`trace_ray_trajectories`, or `traces`,
    its result for these angles). Needs matplotlib, imported here: the
    rest of the package runs without it. Returns the axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        _fig, ax = plt.subplots(figsize=(10, 10))

    circle = np.linspace(0, 2 * np.pi, 200)
    r_horizon = metric.capture_radius()
    ax.fill(r_horizon * np.cos(circle), r_horizon * np.sin(circle),
            "k", label="Event horizon")
    if hasattr(metric, "R_PHOTON"):
        r_ph = metric.R_PHOTON
        ax.plot(r_ph * np.cos(circle), r_ph * np.sin(circle),
                "r--", linewidth=1.5, label="Photon sphere")
    ax.plot(r_obs, 0, "go", markersize=10, label=f"Observer (r={r_obs}M)")

    if traces is None:
        traces = trace_ray_trajectories(metric, r_obs,
                                        np.radians(angles_deg),
                                        dtype=dtype, device=device)
    for alpha_deg, (traj, outcome) in zip(angles_deg, traces):
        if traj is None:
            continue
        n = int(traj.n_valid)
        r = traj.states[:n, 1].cpu().numpy()
        phi = traj.states[:n, 3].cpu().numpy()
        color = "steelblue" if outcome == "escaped" else "crimson"
        style = "-" if outcome == "escaped" else "--"
        ax.plot(r * np.cos(phi), r * np.sin(phi), color=color,
                linestyle=style, linewidth=1.2,
                label=f"α={alpha_deg}° ({outcome})")

    alpha_crit = np.degrees(metric.alpha_crit(r_obs, device=device))
    ax.set_title(f"Photon trajectories (critical angle ≈ {alpha_crit:.2f}°)")
    ax.set_xlabel("x / M")
    ax.set_ylabel("y / M")
    ax.set_aspect("equal")
    ax.legend(loc="upper left", fontsize=8)
    ax.grid(True, alpha=0.3)
    return ax
