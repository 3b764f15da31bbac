"""Batched adaptive Dormand-Prince 4(5) Kerr tracer, plain PyTorch.

The plain version of the CUDA kernel (ops/cuda/kerr_trace_kernel.py) and
the counterpart of `light_path_tracer_tpu.ops.kerr_trace` for the shadow
main path. One masked loop advances the whole batch: each iteration makes
one DP45 attempt per running lane (six new RHS evaluations plus the FSAL
stage), then a per-lane masked accept/reject:

  * error norm: mixed abs/rel RMS over the 5 state components, with
    per-lane tolerances (the axis-refine band); in float32 the scale is
    increment-aware, |y| + h max(|k1|, |k7|);
  * reject: h *= max(0.2, 0.9 err^-0.2); non-finite proposal: h *= 0.25;
    h below h_min -> INVALID;
  * accept: capture (r <= 1.01 r_+), escape (r >= 2 r_obs) and the
    certain-plunge exit are located on the step's cubic Hermite
    interpolant; FSAL reuses stage 7 as the next stage 1 (not after an
    event step); growth h *= 5 (tiny error) or min(5, 0.9 err^-0.2).

The state is a (5, N) tensor, so the JAX package's tuple helpers become
single tensor operations; each element still sees the same arithmetic in
the same order. Finished lanes are frozen by masking, and every lane
counts its own attempts, so the result of a lane does not depend on the
rest of the batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from light_path_tracer_tpu_torch.ops import tableau as tb
from light_path_tracer_tpu_torch.ops.types import TraceResult

RUNNING = 2
ESCAPED = 1
CAPTURED = -1
INVALID = 0

# Tolerance presets: (atol, rtol) normal / axis-refined, keyed by dtype.
# The values are the JAX package's (its TOLS comment has their
# calibration): float64 at the reference tolerances, float32 in three
# tiers, "fast" (3e-5), "precise" (3e-6) and "gate" (1e-6).
TOLS = {
    torch.float64: dict(atol=1e-8, rtol=1e-6,
                        atol_ref=1e-10, rtol_ref=1e-8,
                        h_min=1e-12, tiny_err=1e-10),
    torch.float32: dict(atol=3e-5, rtol=3e-5,
                        atol_ref=1e-5, rtol_ref=1e-5,
                        h_min=1e-7, tiny_err=1e-8),
}

TOLS_PRECISE = {
    torch.float64: TOLS[torch.float64],
    torch.float32: dict(atol=3e-6, rtol=3e-6,
                        atol_ref=1e-6, rtol_ref=1e-6,
                        h_min=1e-7, tiny_err=1e-9),
}

TOLS_GATE = {
    torch.float64: dict(atol=1e-7, rtol=1e-7,
                        atol_ref=3e-8, rtol_ref=3e-8,
                        h_min=1e-12, tiny_err=1e-10),
    torch.float32: dict(atol=1e-6, rtol=1e-6,
                        atol_ref=3e-7, rtol_ref=3e-7,
                        h_min=1e-7, tiny_err=1e-9),
}

# The masked loop asks the device whether any lane still runs only every
# this many iterations: the question costs a host sync, and the extra
# iterations leave finished lanes untouched.
_SYNC_EVERY = 8

WARP = 32


def get_tols(dtype, precision: str = "fast"):
    """Tolerance preset for a compute dtype.

    precision: "fast" | "precise" | "gate" | "tol:<x>" — the last sets
    atol = rtol = x (axis-refine tier x/3).
    """
    if precision.startswith("tol:"):
        t = float(precision[4:])
        base = TOLS[dtype]
        return dict(atol=t, rtol=t, atol_ref=t / 3.0, rtol_ref=t / 3.0,
                    h_min=base["h_min"], tiny_err=base["tiny_err"])
    tables = {"fast": TOLS, "precise": TOLS_PRECISE, "gate": TOLS_GATE}
    if precision not in tables:
        raise ValueError(f"precision must be 'fast', 'precise', 'gate' "
                         f"or 'tol:<x>', got {precision!r}")
    return tables[precision][dtype]


def _h_init_for(r_obs) -> float:
    """Initial step size max(1, r_obs/100)."""
    return max(1.0, 0.01 * float(r_obs))


def warp_step_sum(attempts):
    """n_steps of the TraceResult contract (ops/types.py) from per-ray
    attempt counts: the sum over groups of WARP consecutive rays of the
    group's largest count, as int64."""
    a = attempts.to(torch.int64)
    a = F.pad(a, (0, (-a.numel()) % WARP))
    return a.view(-1, WARP).amax(dim=1).sum()


def _wsum(h, ks, cs):
    """h * sum(c_i * k_i), summed in order, for (5, N) stages ks."""
    acc = cs[0] * ks[0]
    for k, c in zip(ks[1:], cs[1:]):
        acc = acc + c * k
    return h * acc


def _axpy(y, d):
    return y + d


def _all_finite(y):
    """(N,) mask: every component of the (5, N) state is finite."""
    return torch.isfinite(y).all(dim=0)


def _select(mask, a, b):
    return torch.where(mask, a, b)


def _hermite_eval(y0, y1, f0, f1, h, s):
    """Cubic Hermite interpolant on the accepted step at fraction s, from
    the step's endpoint derivatives (k1 and the FSAL stage k7)."""
    s2 = s * s
    s3 = s2 * s
    h00 = 2.0 * s3 - 3.0 * s2 + 1.0
    h10 = s3 - 2.0 * s2 + s
    h01 = -2.0 * s3 + 3.0 * s2
    h11 = s3 - s2
    return h00 * y0 + h10 * h * f0 + h01 * y1 + h11 * h * f1


def _hermite_crossing_frac(r0, r1, fr0, fr1, h, target, frac_linear,
                           n_newton: int = 4):
    """Step fraction where the Hermite interpolant of r crosses `target`.

    Newton iterations from the linear estimate, clamped to [0, 1] and
    guarded against flat derivatives; a non-finite result falls back to
    the linear estimate.
    """
    s = frac_linear
    for _ in range(n_newton):
        s2 = s * s
        p = ((2.0 * s2 * s - 3.0 * s2 + 1.0) * r0
             + (s2 * s - 2.0 * s2 + s) * h * fr0
             + (-2.0 * s2 * s + 3.0 * s2) * r1
             + (s2 * s - s2) * h * fr1)
        dp = ((6.0 * s2 - 6.0 * s) * r0
              + (3.0 * s2 - 4.0 * s + 1.0) * h * fr0
              + (-6.0 * s2 + 6.0 * s) * r1
              + (3.0 * s2 - 2.0 * s) * h * fr1)
        ok = torch.abs(dp) > 1e-30
        step = torch.where(
            ok, (p - target) / torch.where(ok, dp, torch.ones_like(dp)),
            torch.zeros_like(dp))
        s = torch.clamp(s - step, 0.0, 1.0)
    return torch.where(torch.isfinite(s), s, frac_linear)


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, Queue 1)")


def dp45_integrate(metric, y0, p_t, p_phi, status0, *, atol, rtol, h_min,
                   tiny_err, r_capture, r_escape, lambda_max, h_init,
                   max_steps, r_plunge=None, formulation="theta",
                   method="dp45", disk_plane=None, extra_rhs=None,
                   record_time=False, sat_window=0):
    """The masked whole-batch adaptive DP45 loop (main-path subset).

    y0: (5, N) state; p_t, p_phi, atol, rtol, r_plunge: (N,); r_capture,
    r_escape, h_min: 0-dim tensors. Returns (y_final, status, lambda,
    attempts) with `attempts` the per-ray int32 attempt count. The mu
    chart, DOP853, disk recording, extra state components, the time
    recorder and the saturation exit are later slices of the port.
    """
    if formulation != "theta":
        raise _not_ported(f"formulation={formulation!r}")
    if method != "dp45":
        raise _not_ported(f"method={method!r}")
    if disk_plane is not None:
        raise _not_ported("disk recording")
    if extra_rhs is not None:
        raise _not_ported("extra state components (extra_rhs)")
    if record_time:
        raise _not_ported("record_time")
    if sat_window:
        raise _not_ported("the saturation exit (sat_window)")

    dtype = y0.dtype
    lam_max = torch.full((), float(lambda_max), dtype=dtype,
                         device=y0.device)

    def rhs(y):
        return metric.rhs5(y, p_t, p_phi)

    y = y0
    k1 = rhs(y)
    h = torch.full_like(y[0], h_init)
    lam = torch.zeros_like(y[0])
    status = status0
    attempts = torch.zeros_like(status0)

    for step in range(max_steps):
        running = (status == RUNNING) & (lam < lam_max)
        if step % _SYNC_EVERY == 0 and not bool(running.any()):
            break
        h_eff = torch.clamp(torch.minimum(h, lam_max - lam), min=0.0)

        # -- RK stages (k1 via FSAL) --
        k2 = rhs(_axpy(y, _wsum(h_eff, [k1], [tb.A21])))
        k3 = rhs(_axpy(y, _wsum(h_eff, [k1, k2], [tb.A31, tb.A32])))
        k4 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3],
                                [tb.A41, tb.A42, tb.A43])))
        k5 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3, k4],
                                [tb.A51, tb.A52, tb.A53, tb.A54])))
        k6 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3, k4, k5],
                                [tb.A61, tb.A62, tb.A63, tb.A64, tb.A65])))
        y5 = _axpy(y, _wsum(h_eff, [k1, k3, k4, k5, k6],
                            [tb.B1, tb.B3, tb.B4, tb.B5, tb.B6]))
        k7 = rhs(y5)

        finite_ok = _all_finite(y5) & (y5[0] > 0.0)

        # -- per-component error scale --
        mag = torch.maximum(torch.abs(y), torch.abs(y5))
        if dtype == torch.float32:
            # Increment-aware scale: in float32 the estimator's own
            # roundoff is ~eps h max|k|, which exceeds atol + rtol|y|
            # where the derivatives spike (the 1/sin^2-stiff polar axis),
            # and the controller would reject forever. float64 keeps the
            # |y|-only scale.
            mag = mag + h_eff * torch.maximum(torch.abs(k1), torch.abs(k7))
        scales = atol + rtol * mag

        # -- embedded error norm over the 5 components --
        err = _wsum(h_eff, [k1, k3, k4, k5, k6, k7],
                    [tb.E1, tb.E3, tb.E4, tb.E5, tb.E6, tb.E7])
        ratio = torch.where(finite_ok, err / scales, torch.zeros_like(err))
        err_sq = torch.zeros_like(h_eff)
        for i in range(5):
            err_sq = err_sq + ratio[i] * ratio[i]
        err_norm = torch.sqrt(err_sq / 5.0)

        accept = running & finite_ok & (err_norm <= 1.0)
        reject = running & finite_ok & (err_norm > 1.0)
        blowup = running & ~finite_ok

        # -- events on accepted lanes (capture has priority) --
        r_prev, r_next = y[0], y5[0]
        cap = accept & (r_prev > r_capture) & (r_next <= r_capture)
        if r_plunge is not None:
            cap = cap | (accept & (r_next <= r_plunge) & (r_next < r_prev))
        esc = accept & (r_prev < r_escape) & (r_next >= r_escape) & ~cap
        event = cap | esc

        one = torch.ones_like(h_eff)
        denom = r_next - r_prev
        safe_den = torch.where(denom == 0.0, one, denom)
        frac_cap = torch.clamp((r_capture - r_prev) / safe_den, 0.0, 1.0)
        frac_esc = torch.clamp((r_escape - r_prev) / safe_den, 0.0, 1.0)
        frac_lin = torch.where(
            denom == 0.0, one,
            torch.where(cap, frac_cap, torch.where(esc, frac_esc, one)))
        target = torch.where(cap, r_capture, r_escape)
        frac = torch.where(
            event,
            _hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff,
                                   target, frac_lin),
            frac_lin)
        y_event = _hermite_eval(y, y5, k1, k7, h_eff, frac)
        y_acc = _select(event, y_event, y5)
        lam_acc = lam + frac * h_eff

        # -- step-size control (one pow serves both shrink and grow) --
        factor = 0.9 * torch.clamp(err_norm, min=1e-30) ** -0.2
        shrink = torch.clamp(factor, min=0.2)
        grow = torch.where(err_norm < tiny_err, 5.0 * one,
                           torch.clamp(factor, max=5.0))
        h_new = torch.where(accept, h * grow,
                            torch.where(reject, h * shrink,
                                        torch.where(blowup, h * 0.25, h)))
        underflow = (reject | blowup) & (h_new < h_min)

        # -- state/status update (masked) --
        y = _select(accept, y_acc, y)
        # FSAL: stage 7 seeds the next step's stage 1 on plain accepts.
        k1 = _select(accept & ~event, k7, k1)
        lam = torch.where(accept, lam_acc, lam)
        corrupt = accept & ~_all_finite(y_acc)
        status = torch.where(cap, CAPTURED,
                             torch.where(esc, ESCAPED, status))
        status = torch.where(underflow | corrupt, INVALID, status)
        attempts = attempts + running.to(attempts.dtype)
        h = h_new

    return y, status, lam, attempts


def trace_rays_kerr(metric, r_obs, alphas, thetas, theta_obs, axis_refine,
                    lambda_max: float, max_steps: int = 200000,
                    precision: str = "fast", formulation: str = "theta",
                    method: str = "dp45"):
    """Trace a batch of Kerr rays adaptively; returns TraceResult.

    alphas/thetas: (N,) screen viewing angle / azimuth; theta_obs scalar;
    axis_refine: (N,) bool tolerance-tightening mask. Runs on the
    tensors' own device; call sites pass lambda_max = max(5000, 6 r_obs).
    """
    trace_rays_kerr.launches += 1
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)
    atol = torch.where(axis_refine, torch.full_like(alphas, tols["atol_ref"]),
                       torch.full_like(alphas, tols["atol"]))
    rtol = torch.where(axis_refine, torch.full_like(alphas, tols["rtol_ref"]),
                       torch.full_like(alphas, tols["rtol"]))

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=alphas.device)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    status0 = torch.where(invalid0, INVALID, RUNNING).to(torch.int32)
    r_plunge = metric.plunge_radii(r_obs, alphas, thetas, theta_obs)

    y_f, status_f, _lam_f, attempts = dp45_integrate(
        metric, torch.stack(y0), p_t, p_phi, status0,
        atol=atol, rtol=rtol, h_min=scalar(tols["h_min"]),
        tiny_err=tols["tiny_err"],
        r_capture=scalar(metric.capture_radius()),
        r_escape=scalar(float(r_obs) * 2.0),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs),
        max_steps=max_steps, r_plunge=r_plunge,
        formulation=formulation, method=method)

    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f, p_t, p_phi, status_f)
    return TraceResult(final_alpha, n_half, status_out,
                       warp_step_sum(attempts))


# Calls of the plain loop, so a run can show which path it took.
trace_rays_kerr.launches = 0


def finalize_angles(metric, y_f, p_t, p_phi, status_f):
    """Final 5-D state -> (final_alpha, n_half_orbits, status).

    Escape heading via the coordinate-velocity chain rule, NaN
    final_alpha for anything that did not escape, degenerate-state
    INVALID promotion. Shared by the plain loop and the CUDA wrapper.
    """
    captured = status_f == CAPTURED
    ext_status, final_alpha, n_half = metric.extract_angle(
        y_f, p_t, p_phi, captured)

    invalid_f = (status_f == INVALID) | (ext_status == 0)
    cap_f = ~invalid_f & (ext_status == -1)
    status_out = torch.where(
        invalid_f, INVALID,
        torch.where(cap_f, CAPTURED, ESCAPED)).to(torch.int32)
    final_alpha = torch.where(status_out == ESCAPED, final_alpha,
                              torch.full_like(final_alpha, math.nan))
    n_half = torch.where(invalid_f & (status_f == INVALID),
                         torch.zeros_like(n_half), n_half)
    return final_alpha, n_half, status_out
