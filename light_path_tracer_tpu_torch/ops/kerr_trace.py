"""Batched adaptive Dormand-Prince Kerr tracer, plain PyTorch.

The plain version of the CUDA kernel (ops/cuda/kerr_trace_kernel.py) and
the counterpart of `light_path_tracer_tpu.ops.kerr_trace` for the shadow
main path. One masked loop advances the whole batch: each iteration makes
one attempt per running lane, then a per-lane masked accept/reject. The
embedded pair is `method`'s: "dp45", Dormand-Prince 4(5) (six new RHS
evaluations plus the FSAL stage), or "dop853", Hairer's DOP853 8(5,3)
(eleven new stages plus the FSAL end stage):

  * error norm: mixed abs/rel over every state component, with per-lane
    tolerances (the axis-refine band); in float32 the scale is
    increment-aware, |y| + h max|k| (DP45: over k1 and k7; DOP853: over
    all 13 stages). DP45 takes the RMS of the 4th-order estimate, DOP853
    Hairer's combined h |e5|^2 / sqrt(n (|e5|^2 + 0.01 |e3|^2)), a
    non-finite value of which is a hard reject;
  * reject: h *= max(0.2, 0.9 err^-1/(q+1)) (q = 4 for DP45, 7 for
    DOP853); non-finite proposal: h *= 0.25; h below h_min -> INVALID;
  * accept: capture (r <= 1.01 r_+), escape (r >= 2 r_obs) and the
    certain-plunge exit are located on the step's cubic Hermite
    interpolant (event_interp="hermite") or at the linear crossing
    fraction ("linear"); FSAL reuses the end stage as the next stage 1
    (not after an event step); growth h *= 5 (tiny error) or
    min(5, 0.9 err^-1/(q+1)).

The state is a (5, N) tensor, (5 + n_extras, N) with error-controlled
path-integral components (the volumetric and spectral transfer), so the
JAX package's tuple helpers become single tensor operations; each element
still sees the same arithmetic in the same order. Finished lanes are
frozen by masking, and every lane counts its own attempts, so the result
of a lane does not depend on the rest of the batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from light_path_tracer_tpu_torch.models.kerr import TracedKerr
from light_path_tracer_tpu_torch.operands import kernel_operand
from light_path_tracer_tpu_torch.ops import tableau as tb
from light_path_tracer_tpu_torch.ops.graphs import step_blocks
from light_path_tracer_tpu_torch.ops.types import (
    DiskTraceResult, ExtrasResult, SpectralResult, SurfaceResult,
    TraceResult, VolumetricResult)

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

# The embedded pairs and event interpolants the loop runs.
METHODS = ("dp45", "dop853")
EVENT_INTERPS = ("hermite", "linear")


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
    """Initial step size max(1, r_obs/100). A 0-dim tensor r_obs is a
    run-time radius (the third of `dynamic_params`): the step is then
    formed in its dtype, max(1, 0.01 r_obs) rounded once, as the JAX
    package forms it for a traced radius."""
    if isinstance(r_obs, torch.Tensor):
        h = np.float32(0.01) * np.float32(float(r_obs))
        return float(max(np.float32(1.0), h))
    return max(1.0, 0.01 * float(r_obs))


def traced_scalars(metric, r_obs, dynamic_params, dtype):
    """The metric and observer radius of a trace with run-time parameters:
    (metric, r_obs) unchanged when dynamic_params is None; for (M, a) a
    `TracedKerr` (M, a and its radii formed in float32) in place of
    `metric`, which is then a placeholder; for (M, a, r_obs) also the
    radius as a 0-dim float32 tensor, from which the escape radius
    2 r_obs and the first step (_h_init_for) are formed in float32. The
    JAX package's dynamic mode is float32 only (its Pallas path), and so
    is this one: ValueError for any other dtype."""
    if dynamic_params is None:
        return metric, r_obs
    if dtype != torch.float32:
        raise ValueError(f"dynamic_params traces float32 rays only (the "
                         f"JAX package's Pallas path is float32-only); got "
                         f"{dtype}")
    if len(dynamic_params) not in (2, 3):
        raise ValueError(f"dynamic_params is (M, a) or (M, a, r_obs), got "
                         f"{len(dynamic_params)} values")
    metric = TracedKerr(float(dynamic_params[0]), float(dynamic_params[1]))
    if len(dynamic_params) == 3:
        r_obs = torch.tensor(float(dynamic_params[2]), dtype=torch.float32)
    return metric, r_obs


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
    """(N,) mask: every component of the (C, N) state is finite."""
    return torch.isfinite(y).all(dim=0)


def _select(mask, a, b):
    return torch.where(mask, a, b)


def _lerp(y, y_next, frac):
    return y + frac * (y_next - y)


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


def check_method(method, event_interp="hermite"):
    """ValueError for an embedded pair or event interpolant that no
    adaptive loop runs, the fixed-step RK4 included: it is a tracer of
    its own (ops/kerr_rk4.py), which `trace_batch(integrator="rk4")`
    selects."""
    if method == "rk4":
        raise ValueError("integrator='rk4' is the fixed-step tracer "
                         "(ops/kerr_rk4.py, trace_batch(integrator='rk4'));"
                         " the adaptive loops and the CUDA kernels run "
                         + " or ".join(METHODS))
    if method not in METHODS:
        raise ValueError(f"unknown integrator {method!r}; the adaptive loop "
                         f"runs {' or '.join(METHODS)}")
    if event_interp not in EVENT_INTERPS:
        raise ValueError(f"unknown event_interp {event_interp!r}; expected "
                         f"{' or '.join(EVENT_INTERPS)}")


def dp45_integrate(metric, y0, p_t, p_phi, status0, *, atol, rtol, h_min,
                   tiny_err, r_capture, r_escape, lambda_max, h_init,
                   max_steps, r_plunge=None, formulation="theta",
                   method="dp45", event_interp="hermite", disk_plane=None,
                   max_disk_hits=2, record_momentum=False, disk_normal=None,
                   extra_disks=None, extra_rhs=None, record_time=False,
                   sat_window=0, sat_monitor=(), sat_r_max=None):
    """The masked whole-batch adaptive loop (DP45 or DOP853).

    y0: (5, N) state, or (5 + n_extras, N) with extra_rhs; p_t, p_phi,
    atol, rtol, r_plunge: (N,); r_capture, r_escape, h_min: 0-dim
    tensors. Returns (y_final, status, lambda, attempts) with `attempts`
    the per-ray int32 attempt count. method: "dp45" or "dop853" (module
    docstring); event_interp: "hermite" or "linear", how capture, escape
    and the plane crossing are located on an accepted step.

    extra_rhs(y, p_t, p_phi) -> tuple of n_extras (N,) derivatives of
    the extra components (y is the whole state): path integrals such as
    the volumetric emission, integrated by the same embedded pair under
    the same error control as the geodesic (the error norm runs over
    every component, events shorten them to the event point).

    sat_window > 0 adds the emission-saturation and frozen-state exits:
    a lane whose monitored extras y[5 + i], i in sat_monitor, have not
    changed bitwise for sat_window consecutive attempts (accepted or
    rejected) while r <= sat_r_max, or whose whole state has not changed
    for sat_window attempts anywhere, ends with lambda = lambda_max: it
    reads as budget-complete (still RUNNING) and the two-pass drivers do
    not re-trace it.

    disk_plane=(r_in, r_out, theta_plane, opaque) adds the crossing
    recorder and a fifth return value, the dict of hit records: "n" (N,)
    int32 and "r", "phi" ("pr", "pth" with record_momentum) as
    (max_disk_hits, N) tensors. On each accepted step a sign change of
    the plane's detector over [y, y_acc] (or landing on the plane) is
    located at the linear root of that difference on the step's Hermite
    interpolant (linear interpolation on lanes whose step an event
    shortened, and on every lane with event_interp="linear"); a crossing
    with r_in <= r <= r_out fills slot n and increments n up to
    max_disk_hits. The detector of an equatorial plane (disk_normal None)
    is cos(theta) - cos(theta_plane), with the physical azimuth phi + pi
    where sin(theta) < 0. disk_normal tilts the plane: a static basis
    ((n), (e1), (e2)) of Python floats, or a callable r -> basis (a warp,
    disk.warped_basis); the detector is then n . xhat(theta, phi), the
    azimuth the in-plane atan2(xhat . e2, xhat . e1), and slot "xi" also
    records the ray's angular momentum about n (the flat-embedding n . L
    with a sign-preserving clamp of sin(theta) at 1e-12).

    extra_disks: further ((r_in, r_out, theta_plane, opaque), normal)
    planes, each with its own track of max_disk_hits slots under
    hits["extra"] (a tuple of dicts like the first). A ray that is still
    running parks, as ESCAPED, at its first in-disk crossing of any opaque
    plane, the first in list order where one step crosses two.

    record_time: hits["t"] (max_disk_hits, N) holds the coordinate time
    of each recorded crossing and hits["t_now"] (N,) the ray's time at
    the end (at its parking crossing for an opaque stop), accumulated by
    a trapezoid of metric.tdot over each accepted (event-shortened)
    segment; theta chart and a disk plane only.

    formulation: "theta" integrates (r, theta, phi, p_r, p_theta) with
    metric.rhs5; "mu" integrates (r, mu = cos(theta), phi, p_r, p_mu)
    with the transcendental-free metric.rhs5_mu (the caller converts y0
    with metric.state_to_mu and the result back with
    metric.state_from_mu), with mu's error weighed on the theta scale:
    its magnitude is floored at pi/2. The mu chart takes no extras, time
    recorder or disk plane, as in the JAX package.
    """
    if formulation not in ("theta", "mu"):
        raise ValueError(f"formulation must be 'theta' or 'mu', got "
                         f"{formulation!r}")
    mu = formulation == "mu"
    if mu and extra_rhs is not None:
        raise ValueError("extra_rhs requires formulation='theta' (the "
                         "emissivity evaluates the theta chart)")
    if mu and record_time:
        raise ValueError("record_time requires formulation='theta' (tdot "
                         "evaluates the theta chart)")
    if mu and disk_plane is not None:
        raise ValueError("disk mode supports formulation='theta' only")
    check_method(method, event_interp)
    if record_time and disk_plane is None:
        raise ValueError("record_time needs a disk_plane (it exists to "
                         "time crossings)")
    if sat_window and not sat_monitor:
        raise ValueError("sat_window > 0 needs a non-empty sat_monitor "
                         "(with nothing monitored every in-band lane "
                         "would 'saturate')")

    dtype = y0.dtype
    lam_max = torch.full((), float(lambda_max), dtype=dtype,
                         device=y0.device)

    if mu:
        def rhs(y):
            return metric.rhs5_mu(y, p_t, p_phi)
    elif extra_rhs is None:
        def rhs(y):
            return metric.rhs5(y, p_t, p_phi)
    else:
        def rhs(y):
            return torch.cat((metric.rhs5(y[:5], p_t, p_phi),
                              torch.stack(tuple(extra_rhs(y, p_t, p_phi)))))

    y = y0
    n_comp = y0.shape[0]
    n_div = kernel_operand(n_comp, y0)
    k1 = rhs(y)
    h = torch.full_like(y[0], h_init)
    lam = torch.zeros_like(y[0])
    status = status0
    attempts = torch.zeros_like(status0)
    if sat_window:
        sat_cnt = torch.zeros_like(status0)
        frz_cnt = torch.zeros_like(status0)
        sat_r_band = torch.full((), float(sat_r_max), dtype=dtype,
                                device=y0.device)

    if disk_plane is not None:
        planes = [_Plane(disk_plane, disk_normal)] + [
            _Plane(pl, nrm) for pl, nrm in (extra_disks or ())]
        slot_ids = torch.arange(max_disk_hits, dtype=torch.int32,
                                device=y0.device)[:, None]
        keys = (("r", "phi") + (("pr", "pth") if record_momentum else ())
                + (("t",) if record_time else ()))
        tracks = [pl.track(keys, max_disk_hits, status0, dtype)
                  for pl in planes]
        if record_time:
            t_now = torch.zeros_like(y0[0])

            def tdot(ys):
                return metric.tdot(ys, p_t, p_phi)

    def attempt(carry):
        y, k1, h, lam, status, attempts = carry[:6]
        if sat_window:
            sat_cnt, frz_cnt = carry[6:8]
        if record_time:
            t_now = carry[-1]
        running = (status == RUNNING) & (lam < lam_max)
        h_eff = torch.clamp(torch.minimum(h, lam_max - lam), min=0.0)

        # -- RK stages (k1 via FSAL) --
        if method == "dop853":
            ks = [k1]
            for row in tb.D853_A[1:]:
                ks.append(rhs(_axpy(y, _wsum(h_eff, [ks[j] for j, _ in row],
                                             [v for _, v in row]))))
            y5 = _axpy(y, _wsum(h_eff, [ks[j] for j, _ in tb.D853_B],
                                [v for _, v in tb.D853_B]))
            k7 = rhs(y5)          # the FSAL end stage
            ks.append(k7)
        else:
            k2 = rhs(_axpy(y, _wsum(h_eff, [k1], [tb.A21])))
            k3 = rhs(_axpy(y, _wsum(h_eff, [k1, k2], [tb.A31, tb.A32])))
            k4 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3],
                                    [tb.A41, tb.A42, tb.A43])))
            k5 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3, k4],
                                    [tb.A51, tb.A52, tb.A53, tb.A54])))
            k6 = rhs(_axpy(y, _wsum(h_eff, [k1, k2, k3, k4, k5],
                                    [tb.A61, tb.A62, tb.A63, tb.A64,
                                     tb.A65])))
            y5 = _axpy(y, _wsum(h_eff, [k1, k3, k4, k5, k6],
                                [tb.B1, tb.B3, tb.B4, tb.B5, tb.B6]))
            k7 = rhs(y5)

        finite_ok = _all_finite(y5) & (y5[0] > 0.0)

        # -- per-component error scale --
        mag = torch.maximum(torch.abs(y), torch.abs(y5))
        if mu:
            # mu spans [-1, 1] and sits near 0 where theta sits near pi/2,
            # so its relative term would vanish at the equator: weigh its
            # error on the theta scale (|d mu| <= |d theta|).
            mag = torch.cat((mag[:1], torch.clamp(mag[1:2], min=math.pi / 2),
                             mag[2:]))
        if dtype == torch.float32:
            # Increment-aware scale: in float32 the estimator's own
            # roundoff is ~eps h max|k|, which exceeds atol + rtol|y| where
            # the derivatives spike (the 1/sin^2-stiff polar axis), and the
            # controller would reject forever. DOP853's larger steps can
            # hold the whole spike inside the step, so it takes the maximum
            # over every stage. float64 keeps the |y|-only scale.
            if method == "dop853":
                kmag = torch.abs(k1)
                for kj in ks[1:]:
                    kmag = torch.maximum(kmag, torch.abs(kj))
            else:
                kmag = torch.maximum(torch.abs(k1), torch.abs(k7))
            mag = mag + h_eff * kmag
        scales = atol + rtol * mag

        # -- embedded error norm over every component --
        if method == "dop853":
            # Hairer's combined 5th/3rd-order estimator (dop853.f).
            one = torch.ones_like(h_eff)
            e5 = _wsum(one, [ks[j] for j, _ in tb.D853_E5],
                       [v for _, v in tb.D853_E5])
            e3 = _wsum(one, [ks[j] for j, _ in tb.D853_E3],
                       [v for _, v in tb.D853_E3])
            r5 = torch.where(finite_ok, e5 / scales, torch.zeros_like(e5))
            r3 = torch.where(finite_ok, e3 / scales, torch.zeros_like(e3))
            e5_sq = torch.zeros_like(h_eff)
            e3_sq = torch.zeros_like(h_eff)
            for i in range(n_comp):
                e5_sq = e5_sq + r5[i] * r5[i]
                e3_sq = e3_sq + r3[i] * r3[i]
            denom = e5_sq + 0.01 * e3_sq
            err_norm = (h_eff * e5_sq
                        / torch.sqrt(torch.clamp(float(n_comp) * denom,
                                                 min=1e-30)))
            # A stage can overflow where y5 stays finite (the large A
            # coefficients probe far from y): the attempt probed garbage,
            # so a non-finite error is a hard reject (shrink 0.2).
            err_norm = torch.where(torch.isfinite(err_norm), err_norm,
                                   torch.full_like(err_norm, math.inf))
        else:
            err = _wsum(h_eff, [k1, k3, k4, k5, k6, k7],
                        [tb.E1, tb.E3, tb.E4, tb.E5, tb.E6, tb.E7])
            ratio = torch.where(finite_ok, err / scales,
                                torch.zeros_like(err))
            err_sq = torch.zeros_like(h_eff)
            for i in range(n_comp):
                err_sq = err_sq + ratio[i] * ratio[i]
            # the kernel divides (light_path_tracer_tpu_torch/operands.py)
            err_norm = torch.sqrt(err_sq / n_div)

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
        if event_interp == "hermite":
            target = torch.where(cap, r_capture, r_escape)
            frac = torch.where(
                event,
                _hermite_crossing_frac(r_prev, r_next, k1[0], k7[0], h_eff,
                                       target, frac_lin),
                frac_lin)
            y_event = _hermite_eval(y, y5, k1, k7, h_eff, frac)
        else:
            frac = frac_lin
            y_event = _lerp(y, y5, frac)
        y_acc = _select(event, y_event, y5)
        lam_acc = lam + frac * h_eff

        # -- step-size control (one pow serves both shrink and grow) --
        # The exponent is -1/(q + 1) for the pair's error order q.
        exponent = -0.125 if method == "dop853" else -0.2
        factor = 0.9 * torch.clamp(err_norm, min=1e-30) ** exponent
        shrink = torch.clamp(factor, min=0.2)
        grow = torch.where(err_norm < tiny_err, 5.0 * one,
                           torch.clamp(factor, max=5.0))
        h_new = torch.where(accept, h * grow,
                            torch.where(reject, h * shrink,
                                        torch.where(blowup, h * 0.25, h)))
        underflow = (reject | blowup) & (h_new < h_min)

        if disk_plane is not None:
            # -- plane crossings on the accepted segment [y, y_acc] --
            seg = frac * h_eff
            if record_time:
                # a trapezoid of tdot over the accepted segment
                td_prev = tdot(y)
                t_acc = t_now + 0.5 * seg * (td_prev + tdot(y_acc))
            crossings = []
            for pl, track in zip(planes, tracks):
                d_prev, d_next = pl.detector(y), pl.detector(y_acc)
                crossed = accept & ((d_prev * d_next < 0.0)
                                    | ((d_next == 0.0) & (d_prev != 0.0)))
                den = torch.where(d_next == d_prev, one, d_next - d_prev)
                frac_c = torch.clamp(-d_prev / den, 0.0, 1.0)
                # k7 is the derivative at y5, so an event-shortened step
                # interpolates linearly.
                if event_interp == "hermite":
                    y_cross = _select(
                        event, _lerp(y, y_acc, frac_c),
                        _hermite_eval(y, y_acc, k1, k7, seg, frac_c))
                else:
                    y_cross = _lerp(y, y_acc, frac_c)
                r_c = y_cross[0]
                in_disk = crossed & (r_c >= pl.r_in) & (r_c <= pl.r_out)
                rec = dict(r=r_c, **pl.azimuth(y_cross, p_phi))
                if record_momentum:
                    rec.update(pr=y_cross[3], pth=y_cross[4])
                if record_time:
                    # the trapezoid over the sub-segment to the crossing
                    rec["t"] = t_now + 0.5 * (frac_c * seg) * (
                        td_prev + tdot(y_cross))
                take = in_disk & (track["n"] == slot_ids)
                for key, val in rec.items():
                    track[key] = torch.where(take, val, track[key])
                track["n"] = torch.where(
                    in_disk, torch.clamp(track["n"] + 1, max=max_disk_hits),
                    track["n"])
                crossings.append((in_disk & (track["n"] == 1), y_cross,
                                  rec.get("t")))

        # -- state/status update (masked) --
        y_prev = y
        y = _select(accept, y_acc, y)
        # FSAL: the end stage seeds the next step's stage 1 on plain
        # accepts.
        k1 = _select(accept & ~event, k7, k1)
        lam = torch.where(accept, lam_acc, lam)
        corrupt = accept & ~_all_finite(y_acc)
        status = torch.where(cap, CAPTURED,
                             torch.where(esc, ESCAPED, status))
        status = torch.where(underflow | corrupt, INVALID, status)
        if disk_plane is not None:
            # The ray parks at its first in-disk crossing of an opaque
            # plane (the first in list order); a ray that was captured in
            # the same step keeps its capture.
            t_stop = t_acc if record_time else None
            for pl, (first_hit, y_cross, t_c) in zip(planes, crossings):
                if not pl.opaque:
                    continue
                stop = first_hit & (status == RUNNING)
                y = _select(stop, y_cross, y)
                status = torch.where(stop, ESCAPED, status)
                if record_time:
                    t_stop = torch.where(stop, t_c, t_stop)
            if record_time:
                t_now = torch.where(accept, t_stop, t_now)
        if sat_window:
            # Saturation and frozen-state exits: count consecutive
            # attempts, accepted or rejected, that left the monitored
            # extras (resp. the whole state) bitwise unchanged. The
            # measured grinder is a reject limit cycle that never
            # accepts again, so counting accepted steps would never fire.
            changed = torch.zeros_like(running)
            for i in sat_monitor:
                changed = changed | (y[5 + i] != y_prev[5 + i])
            sat_cnt = torch.where(
                running, torch.where(changed, 0, sat_cnt + 1), sat_cnt)
            changed = changed | (y != y_prev).any(dim=0)
            frz_cnt = torch.where(
                running, torch.where(changed, 0, frz_cnt + 1), frz_cnt)
            saturated = (running & (status == RUNNING)
                         & (((sat_cnt >= sat_window) & (y[0] <= sat_r_band))
                            | (frz_cnt >= sat_window)))
            lam = torch.where(saturated, lam_max, lam)
        attempts = attempts + running.to(attempts.dtype)
        h = h_new
        out = (y, k1, h, lam, status, attempts)
        if sat_window:
            out += (sat_cnt, frz_cnt)
        if record_time:
            out += (t_now,)
        return out, ()

    def keep_going(carry):
        lam, status = carry[3], carry[4]
        return bool(((status == RUNNING) & (lam < lam_max)).any())

    carry = (y, k1, h, lam, status, attempts)
    if sat_window:
        carry += (sat_cnt, frz_cnt)
    if record_time:
        carry += (t_now,)
    # On the card the blocks replay as CUDA graphs, bitwise the eager
    # loop, except with plane records (their tracks are updated in place
    # outside the carry).
    carry, _ = step_blocks(attempt, carry, max_steps, keep_going,
                           block=_SYNC_EVERY, graph=disk_plane is None)
    y, k1, h, lam, status, attempts = carry[:6]
    if record_time:
        t_now = carry[-1]

    if disk_plane is not None:
        hits = tracks[0]
        if len(tracks) > 1:
            hits["extra"] = tuple(tracks[1:])
        if record_time:
            hits["t_now"] = t_now
        return y, status, lam, attempts, hits
    return y, status, lam, attempts


def _div(num, den):
    """num / den for a Python float num, divided as the kernels and the
    JAX package divide (PyTorch's float / tensor multiplies den's
    reciprocal by num)."""
    return torch.full((), float(num), dtype=den.dtype,
                      device=den.device) / den


class WarpedBasis:
    """The disk basis of a Bardeen-Petterson warp (disk.warped_basis):
    the plane tilts by iota(r) = tilt / (1 + (warp_radius / r)^power)
    about the line of nodes at tilt_azimuth. Called with r it returns
    ((n), (e1), (e2)) of tensors, the plain loops' detector basis; the
    CUDA kernel reads the four numbers."""

    def __init__(self, tilt, tilt_azimuth, warp_radius, power=4.0):
        self.tilt, self.warp_radius = float(tilt), float(warp_radius)
        self.power = float(power)
        self.sl = float(math.sin(tilt_azimuth))
        self.cl = float(math.cos(tilt_azimuth))

    def __call__(self, r):
        sl, cl = self.sl, self.cl
        # the kernel divides and calls pow (operands.py)
        ratio = _div(self.warp_radius, torch.clamp(r, min=1e-6))
        iota = _div(self.tilt,
                    1.0 + ratio ** kernel_operand(self.power, ratio))
        si, ci = torch.sin(iota), torch.cos(iota)
        zero = torch.zeros_like(si)
        n = (si * sl, -si * cl, ci)
        e1 = (cl + zero, sl + zero, zero)
        e2 = (-sl * ci, cl * ci, si)
        return n, e1, e2


class _Plane:
    """One disk plane of dp45_integrate's recorder: its annulus, opacity
    and detector basis (None: the equatorial cos(theta) detector)."""

    def __init__(self, plane, normal):
        self.r_in, self.r_out, theta_plane, self.opaque = plane
        # The cos(theta) detector sees the plane on every branch of the
        # double-cover chart (over-the-pole rays cross at theta = -pi/2).
        # cos(pi/2) is 6.1e-17, not 0: the tangent case needs it.
        self.plane_c = math.cos(theta_plane)
        if normal is None or callable(normal):
            self.basis = normal
        else:
            self.basis = lambda r, _b=normal: _b

    def track(self, keys, max_hits, status0, dtype):
        track = {"n": torch.zeros_like(status0)}
        for key in keys + (("xi",) if self.basis is not None else ()):
            track[key] = torch.zeros((max_hits,) + status0.shape,
                                     dtype=dtype, device=status0.device)
        return track

    def detector(self, ys):
        if self.basis is None:
            return torch.cos(ys[1]) - self.plane_c
        (nx, ny, nz), _e1, _e2 = self.basis(ys[0])
        sth, cth = torch.sin(ys[1]), torch.cos(ys[1])
        sph, cph = torch.sin(ys[2]), torch.cos(ys[2])
        return nx * sth * cph + ny * sth * sph + nz * cth

    def azimuth(self, yc, p_phi):
        """The crossing's physical azimuth ("phi") and, on a tilted plane,
        the ray's angular momentum about its normal ("xi")."""
        if self.basis is None:
            # phi + pi on the sin(theta) < 0 branch of the chart
            return dict(phi=torch.where(torch.sin(yc[1]) < 0.0,
                                        yc[2] + math.pi, yc[2]))
        (nx, ny, nz), e1, e2 = self.basis(yc[0])
        th, ph, pth = yc[1], yc[2], yc[4]
        sth, cth = torch.sin(th), torch.cos(th)
        sph, cph = torch.sin(ph), torch.cos(ph)
        xh, yh, zh = sth * cph, sth * sph, cth
        u1 = xh * e1[0] + yh * e1[1] + zh * e1[2]
        u2 = xh * e2[0] + yh * e2[1] + zh * e2[2]
        # L = (-sin phi p_th - cot th cos phi p_phi, cos phi p_th - cot th
        # sin phi p_phi, p_phi), with a sign-preserving clamp of sin th
        tiny = torch.full_like(sth, 1e-12)
        sth_safe = torch.where(torch.abs(sth) < 1e-12,
                               torch.where(sth < 0.0, -tiny, tiny), sth)
        cot = cth / sth_safe
        lx = -sph * pth - cot * cph * p_phi
        ly = cph * pth - cot * sph * p_phi
        return dict(phi=torch.atan2(u2, u1),
                    xi=nx * lx + ny * ly + nz * p_phi)


def trace_rays_kerr(metric, r_obs, alphas, thetas, theta_obs, axis_refine,
                    lambda_max: float, max_steps: int = 200000,
                    precision: str = "fast", formulation: str = "theta",
                    method: str = "dp45", return_unconverged: bool = False,
                    event_interp: str = "hermite", force_invalid=None,
                    dynamic_params=None):
    """Trace a batch of Kerr rays adaptively; returns TraceResult.

    alphas/thetas: (N,) screen viewing angle / azimuth; theta_obs scalar;
    axis_refine: (N,) bool tolerance-tightening mask. Runs on the
    tensors' own device; call sites pass lambda_max = max(5000, 6 r_obs).
    method: "dp45" or "dop853"; event_interp: "hermite" or "linear".
    formulation: "theta" or "mu" (dp45_integrate; the same geodesics, but
    mu alone is ill-conditioned for rays near the polar axis, which
    trace_rays_kerr_hybrid re-traces in theta). force_invalid: an (N,)
    bool mask of rays frozen INVALID before their first attempt (the
    hybrid tracer's poisoning). return_unconverged=True returns
    (TraceResult, mask) with mask the rays whose raw status is still
    RUNNING after the loop: neither event fired within max_steps attempts
    and lambda was not spent, or it was. The two-pass drivers re-trace
    those. dynamic_params: run-time (M, a) or (M, a, r_obs), float32 only
    (traced_scalars); `metric` (and with three values `r_obs`) is then a
    placeholder, and lambda_max must bound the largest radius of a sweep.
    """
    trace_rays_kerr.launches += 1
    dtype = alphas.dtype
    metric, r_obs = traced_scalars(metric, r_obs, dynamic_params, dtype)
    tols = get_tols(dtype, precision)
    atol = torch.where(axis_refine, torch.full_like(alphas, tols["atol_ref"]),
                       torch.full_like(alphas, tols["atol"]))
    rtol = torch.where(axis_refine, torch.full_like(alphas, tols["rtol_ref"]),
                       torch.full_like(alphas, tols["rtol"]))

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=alphas.device)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    if formulation == "mu":
        y0 = metric.state_to_mu(y0)
    if force_invalid is not None:
        invalid0 = invalid0 | force_invalid
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
        formulation=formulation, method=method, event_interp=event_interp)
    if formulation == "mu":
        y_f = torch.stack(metric.state_from_mu(y_f))

    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f, p_t, p_phi, status_f)
    result = TraceResult(final_alpha, n_half, status_out,
                         warp_step_sum(attempts))
    if return_unconverged:
        return result, status_f == RUNNING
    return result


# Calls of the plain loop, so a run can show which path it took.
trace_rays_kerr.launches = 0


# The hybrid tracer's pole threshold (Kerr.pole_risk's s_thresh) and the
# observer inclination below which it traces everything in theta.
HYBRID_S_THRESH = 1e-3
POLAR_OBSERVER_SIN = 0.1


def hybrid_slots(n, slots=None) -> int:
    """Re-trace slots of the hybrid tracer for n rays: by default
    min(n, max(8192, ceil(n / 32))), the JAX package's sizing (about
    twice the pole-risk share of an equatorial observer's grid); never
    more than n."""
    if slots is None:
        slots = min(n, max(8192, -(-n // 32)))
    return min(int(slots), n)


def hybrid_poison(metric, r_obs, alphas, thetas, theta_obs, slots,
                  s_thresh=HYBRID_S_THRESH):
    """The hybrid's poison mask: the first `slots` pole-risk rays in index
    order (the ones pass B is sure to pick up; any further risk rays
    integrate in mu). No host sync."""
    n = alphas.numel()
    risk = metric.pole_risk(r_obs, alphas, thetas, theta_obs, s_thresh)
    idx_r = torch.nonzero_static(risk, size=slots, fill_value=n)[:, 0]
    poison = torch.zeros(n + 1, dtype=torch.bool, device=alphas.device)
    poison[idx_r] = True
    return poison[:n]


def stragglers(mask, slots):
    """(idx, dest): the first `slots` ray indices where `mask` holds, in
    index order, padded with ray 0 as JAX's nonzero(size=slots,
    fill_value=0) pads them, and the scatter destination of each slot,
    with the padding sent to a spare row past the end. No host sync."""
    n = mask.numel()
    slots = min(int(slots), n)
    idx = torch.nonzero_static(mask, size=slots, fill_value=0)[:, 0]
    real = torch.arange(slots, device=mask.device) < mask.sum()
    return idx, torch.where(real, idx, n)


def _scatter(a1, a2, dest):
    """a1 with row dest[j] replaced by a2[j] (dest == len(a1) drops j)."""
    out = torch.cat([a1, a1[:1]])
    out[dest] = a2
    return out[:-1]


def merge_results(res1, res2, dest):
    """res1 with the re-traced rays' fields from res2 (two results of one
    NamedTuple type, tuple fields taken element by element, slot j of
    res2 going to ray dest[j]); n_steps counts both passes."""
    fields = []
    for name, a, b in zip(res1._fields, res1, res2):
        if name == "n_steps":
            fields.append(a + b)
        elif isinstance(a, tuple):
            fields.append(tuple(_scatter(x, y, dest) for x, y in zip(a, b)))
        else:
            fields.append(_scatter(a, b, dest))
    return type(res1)(*fields)


def trace_rays_kerr_hybrid(metric, r_obs, alphas, thetas, theta_obs,
                           axis_refine, lambda_max: float,
                           max_steps: int = 200000,
                           event_interp: str = "hermite",
                           s_thresh: float = HYBRID_S_THRESH,
                           slots: int | None = None,
                           pass1_steps: int | None = None,
                           dynamic_params=None, precision: str = "fast",
                           method: str = "dp45"):
    """The mu-chart tracer: mu bulk, theta re-trace of the pole lanes;
    returns TraceResult. The plain version, with the JAX package's XLA
    backend's semantics:

      1. the first `slots` pole-risk rays (metric.pole_risk at s_thresh)
         are poisoned, frozen INVALID before their first attempt;
      2. every ray is traced in mu at full depth (max_steps; pass1_steps
         is ignored, as the XLA branch ignores it, and nothing is left
         unconverged);
      3. the poisoned rays and those that ended INVALID, the first
         `slots` of them in index order (padded with ray 0), are
         re-traced in theta at full depth and scattered back.

    n_steps is the sum of both passes. A nearly polar observer
    (|sin theta_obs| < 0.1) traces everything in theta. The CUDA driver
    with the Pallas backend's semantics is
    ops/cuda/kerr_trace_kernel.trace_rays_kerr_hybrid. dynamic_params:
    run-time (M, a) or (M, a, r_obs) of the sequences, float32 only
    (traced_scalars): the pole risk, both passes and the extraction use
    the TracedKerr metric and the run-time radius; lambda_max stays the
    caller's, for the largest radius of a sweep.
    """
    metric, r_obs = traced_scalars(metric, r_obs, dynamic_params,
                                   alphas.dtype)
    kw = dict(precision=precision, method=method, event_interp=event_interp)
    if abs(math.sin(float(theta_obs))) < POLAR_OBSERVER_SIN:
        return trace_rays_kerr(metric, r_obs, alphas, thetas, theta_obs,
                               axis_refine, lambda_max, max_steps, **kw)
    slots = hybrid_slots(alphas.numel(), slots)
    poison = hybrid_poison(metric, r_obs, alphas, thetas, theta_obs, slots,
                           s_thresh)
    res_a = trace_rays_kerr(metric, r_obs, alphas, thetas, theta_obs,
                            axis_refine, lambda_max, max_steps,
                            formulation="mu", force_invalid=poison, **kw)
    idx, dest = stragglers(poison | (res_a.status == INVALID), slots)
    res_b = trace_rays_kerr(metric, r_obs, alphas[idx], thetas[idx],
                            theta_obs, axis_refine[idx], lambda_max,
                            max_steps, **kw)
    return merge_results(res_a, res_b, dest)


def disk_results(metric, p_t, p_phi, y_f, status_f, attempts, tracks):
    """One DiskTraceResult a plane from a disk trace's final state and the
    planes' hit records (the (max_hits, N) tensors split into per-slot
    rows; "t_now", the time at the end, with the time recorder), sharing
    the escape angle extracted in torch."""
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f, p_t, p_phi, status_f)
    steps = warp_step_sum(attempts)

    def one(hits):
        rows = {k: tuple(hits[k].unbind(0)) if k in hits else ()
                for k in ("r", "phi", "xi", "pr", "pth", "t")}
        return DiskTraceResult(status_out, hits["n"], rows["r"], p_phi,
                               steps, final_alpha, n_half, rows["phi"],
                               rows["xi"], rows["pr"], rows["pth"],
                               rows["t"], hits.get("t_now", ()))
    return tuple(one(hits) for hits in tracks)


def trace_disk_rays_kerr(metric, r_obs, alphas, thetas, theta_obs,
                         lambda_max: float, max_steps: int, disk_plane,
                         max_disk_hits: int = 2, precision: str = "fast",
                         formulation: str = "theta",
                         return_unconverged: bool = False,
                         record_momentum: bool = False,
                         method: str = "dp45", disk_normal=None,
                         extra_disks=None, record_time: bool = False):
    """Trace rays recording disk-plane crossings; returns DiskTraceResult,
    or with extra_disks a tuple of them, one a plane, sharing the ray's
    status, heading and steps.

    The plain version of the CUDA disk kernel and the counterpart of the
    JAX package's disk-mode trace: base tolerances on every ray (no
    axis-refine band), no certain-plunge exit. disk_plane = (r_in, r_out,
    theta_plane, opaque); disk_normal, extra_disks and record_time as in
    dp45_integrate (t_hits, t_end). method: "dp45" or "dop853"; events
    are Hermite, as in the disk kernel and every JAX entry point.
    return_unconverged as in trace_rays_kerr.
    """
    trace_disk_rays_kerr.launches += 1
    if formulation != "theta":
        raise ValueError("disk mode supports formulation='theta' only")
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=alphas.device)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    status0 = torch.where(invalid0, INVALID, RUNNING).to(torch.int32)
    y_f, status_f, _lam_f, attempts, hits = dp45_integrate(
        metric, torch.stack(y0), p_t, p_phi, status0,
        atol=torch.full_like(alphas, tols["atol"]),
        rtol=torch.full_like(alphas, tols["rtol"]),
        h_min=scalar(tols["h_min"]), tiny_err=tols["tiny_err"],
        r_capture=scalar(metric.capture_radius()),
        r_escape=scalar(float(r_obs) * 2.0),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs),
        max_steps=max_steps, disk_plane=disk_plane,
        max_disk_hits=max_disk_hits, record_momentum=record_momentum,
        method=method, disk_normal=disk_normal, extra_disks=extra_disks,
        record_time=record_time)
    t_now = {"t_now": hits["t_now"]} if record_time else {}
    results = disk_results(
        metric, p_t, p_phi, y_f, status_f, attempts,
        [hits] + [dict(t, **t_now) for t in hits.get("extra", ())])
    result = results if extra_disks else results[0]
    if return_unconverged:
        return result, status_f == RUNNING
    return result


trace_disk_rays_kerr.launches = 0


def saturation_r_max(metric) -> float:
    """Radial band bound of the emission-saturation exit: 1.2 x the
    outermost unstable spherical photon orbit. Only a lane inside the
    band can be a trapped near-critical orbiter; outside it a no-change
    streak is transit towards the source."""
    return 1.2 * max(float(r) for r in metric.unstable_photon_radii())


def _trace_extras(metric, r_obs, alphas, thetas, theta_obs, extra,
                  n_extras, lambda_max, max_steps, precision, method,
                  sat_window, sat_monitor):
    """The coupled-extras trace shared by the volumetric, spectral and
    aux entry points: base tolerances on every ray, no certain-plunge
    exit (plunging photons collect emission down to the capture
    surface), the extras starting at 0. Returns (y_f, status_f, lam_f,
    attempts, p_t, p_phi)."""
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=alphas.device)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    y0 = torch.cat((torch.stack(y0),
                    torch.zeros((n_extras,) + alphas.shape, dtype=dtype,
                                device=alphas.device)))
    status0 = torch.where(invalid0, INVALID, RUNNING).to(torch.int32)
    y_f, status_f, lam_f, attempts = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=torch.full_like(alphas, tols["atol"]),
        rtol=torch.full_like(alphas, tols["rtol"]),
        h_min=scalar(tols["h_min"]), tiny_err=tols["tiny_err"],
        r_capture=scalar(metric.capture_radius()),
        r_escape=scalar(float(r_obs) * 2.0),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs),
        max_steps=max_steps, method=method, extra_rhs=extra,
        sat_window=sat_window, sat_monitor=sat_monitor,
        sat_r_max=saturation_r_max(metric) if sat_window else None)
    return y_f, status_f, lam_f, attempts, p_t, p_phi


def unconverged(status_f, lam_f, lambda_max):
    """Rays the two-pass drivers re-trace: still RUNNING with lambda
    budget left (the step cap stopped them). A saturation exit parks
    lambda at lambda_max, so those rays read as finished."""
    return (status_f == RUNNING) & (lam_f < lam_f.new_tensor(
        float(lambda_max)))


def extras_result(metric, p_t, p_phi, y_f, status_f, attempts):
    """ExtrasResult from an extras trace's final (5 + n, N) state:
    extras zeroed on lanes whose integration went INVALID (keyed off the
    integration status, not the extraction's), angles by
    finalize_angles. Shared by the plain loop and the CUDA wrapper."""
    ok = status_f != INVALID
    extras = tuple(torch.where(ok, e, torch.zeros_like(e))
                   for e in y_f[5:].unbind(0))
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f[:5], p_t, p_phi, status_f)
    return ExtrasResult(extras, final_alpha, n_half, status_out,
                        warp_step_sum(attempts))


def volumetric_result(res: ExtrasResult, absorbing: bool):
    """VolumetricResult from the (I,) or (I, tau) ExtrasResult."""
    em = res.extras[0]
    tau = res.extras[1] if absorbing else torch.zeros_like(em)
    return VolumetricResult(em, res.final_alpha, res.n_half_orbits,
                            res.status, res.n_steps, tau)


def spectral_result(res: ExtrasResult):
    """SpectralResult from the (tau_hat, I_1..I_n) ExtrasResult."""
    return SpectralResult(res.extras[1:], res.extras[0], res.final_alpha,
                          res.n_half_orbits, res.status, res.n_steps)


def trace_rays_volumetric(metric, r_obs, alphas, thetas, theta_obs,
                          emission_fn, lambda_max: float,
                          max_steps: int = 200000, precision: str = "fast",
                          method: str = "dp45", absorption_fn=None,
                          sat_window: int = 0,
                          return_unconverged: bool = False):
    """Trace rays accumulating a volumetric radiative-transfer integral;
    returns VolumetricResult (with return_unconverged, also the mask of
    rays the two-pass drivers re-trace).

    emission_fn(y5, p_t, p_phi) -> per-lane emissivity weight is
    integrated as a sixth state component. absorption_fn (optional)
    -> the invariant opacity chi makes the transfer self-absorbed: the
    state carries I and the optical depth tau from the camera, with
    dI = exp(-max(tau, -30)) emission and dtau = chi (the floor bounds
    exp(+|tau|) on unphysical RK stage probes). sat_window > 0 enables
    the saturation exits monitoring I. The plain version of the CUDA
    kernel's volumetric forms.
    """
    trace_rays_volumetric.launches += 1
    if absorption_fn is None:
        n_extras = 1

        def extra(y, p_t, p_phi):
            return (emission_fn(y[:5], p_t, p_phi),)
    else:
        n_extras = 2

        def extra(y, p_t, p_phi):
            return (torch.exp(-torch.clamp(y[6], min=-30.0))
                    * emission_fn(y[:5], p_t, p_phi),
                    absorption_fn(y[:5], p_t, p_phi))
    y_f, status_f, lam_f, attempts, p_t, p_phi = _trace_extras(
        metric, r_obs, alphas, thetas, theta_obs, extra, n_extras,
        lambda_max, max_steps, precision, method, sat_window, (0,))
    result = volumetric_result(
        extras_result(metric, p_t, p_phi, y_f, status_f, attempts),
        absorption_fn is not None)
    if return_unconverged:
        return result, unconverged(status_f, lam_f, lambda_max)
    return result


trace_rays_volumetric.launches = 0


def trace_rays_spectral(metric, r_obs, alphas, thetas, theta_obs,
                        transfer_fn, n_bands: int, lambda_max: float,
                        max_steps: int = 200000, precision: str = "fast",
                        method: str = "dp45", sat_window: int = 0,
                        sat_monitor: tuple = None,
                        return_unconverged: bool = False):
    """Multi-frequency transfer: one trace carrying (tau_hat, I_1..I_n).

    transfer_fn(y, p_t, p_phi) -> (d tau_hat, d I_1, ..., d I_n) reads
    the whole state. sat_monitor lists the intensity extras the
    saturation exit watches (default the n bands, extras 1..n). Returns
    SpectralResult (with return_unconverged, also the re-trace mask).
    """
    trace_rays_spectral.launches += 1
    if sat_monitor is None:
        sat_monitor = tuple(range(1, 1 + n_bands))
    y_f, status_f, lam_f, attempts, p_t, p_phi = _trace_extras(
        metric, r_obs, alphas, thetas, theta_obs, transfer_fn,
        1 + n_bands, lambda_max, max_steps, precision, method, sat_window,
        sat_monitor)
    result = spectral_result(
        extras_result(metric, p_t, p_phi, y_f, status_f, attempts))
    if return_unconverged:
        return result, unconverged(status_f, lam_f, lambda_max)
    return result


trace_rays_spectral.launches = 0


def trace_rays_aux(metric, r_obs, alphas, thetas, theta_obs, transfer_fn,
                   n_extras: int, aux, lambda_max: float,
                   max_steps: int = 200000, precision: str = "fast",
                   method: str = "dp45", sat_window: int = 0,
                   sat_monitor: tuple = (),
                   return_unconverged: bool = False):
    """Generic coupled-extras trace with per-ray auxiliary constants:
    transfer_fn(y, p_t, p_phi, aux) -> n_extras derivatives, aux any
    per-ray tensors the integrand reads as it reads p_t and p_phi.
    Returns ExtrasResult (with return_unconverged, also the re-trace
    mask)."""
    trace_rays_aux.launches += 1

    def extra(y, p_t, p_phi):
        return transfer_fn(y, p_t, p_phi, aux)
    y_f, status_f, lam_f, attempts, p_t, p_phi = _trace_extras(
        metric, r_obs, alphas, thetas, theta_obs, extra, n_extras,
        lambda_max, max_steps, precision, method, sat_window, sat_monitor)
    result = extras_result(metric, p_t, p_phi, y_f, status_f, attempts)
    if return_unconverged:
        return result, unconverged(status_f, lam_f, lambda_max)
    return result


trace_rays_aux.launches = 0


def trace_rays_surface(metric, r_obs, alphas, thetas, theta_obs,
                       r_surface: float, lambda_max: float,
                       max_steps: int = 200000, precision: str = "fast",
                       method: str = "dp45", record_time: bool = False):
    """Trace rays onto an opaque sphere at r = r_surface; returns
    SurfaceResult.

    The shared adaptive loop with the surface as its capture event
    (r_capture = r_surface, r_escape = 2 r_obs), base tolerances on every
    ray, no certain-plunge exit and Hermite event location, so captured
    rays end localised on the sphere and escaped ones on the escape
    sphere, their raw end state returned as it is. record_time=True
    integrates the coordinate time as an error-controlled sixth
    component (dt/dlambda = metric.tdot), shortened to the event point
    with the rest of the state. The plain version of the CUDA surface
    kernel (ops/cuda/surface_kernel.py).
    """
    trace_rays_surface.launches += 1
    dtype = alphas.dtype
    tols = get_tols(dtype, precision)

    def scalar(x):
        return torch.full((), float(x), dtype=dtype, device=alphas.device)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    y0 = torch.stack(y0)
    extra = None
    if record_time:
        y0 = torch.cat((y0, torch.zeros_like(y0[:1])))

        def extra(y, p_t, p_phi):
            return (metric.tdot(y[:5], p_t, p_phi),)
    status0 = torch.where(invalid0, INVALID, RUNNING).to(torch.int32)
    y_f, status_f, _lam_f, attempts = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=torch.full_like(alphas, tols["atol"]),
        rtol=torch.full_like(alphas, tols["rtol"]),
        h_min=scalar(tols["h_min"]), tiny_err=tols["tiny_err"],
        r_capture=scalar(r_surface), r_escape=scalar(float(r_obs) * 2.0),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs),
        max_steps=max_steps, method=method, extra_rhs=extra)

    t_hit = y_f[5] if record_time else torch.zeros_like(y_f[0])
    xi = p_phi / torch.clamp(-p_t, min=1e-30)
    final_alpha, n_half, status_out = finalize_angles(
        metric, y_f[:5], p_t, p_phi, status_f)
    return SurfaceResult(y_f[1], y_f[2], y_f[3], y_f[4], xi, t_hit,
                         final_alpha, n_half, status_out,
                         warp_step_sum(attempts))


trace_rays_surface.launches = 0


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
