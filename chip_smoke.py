#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version on the card, drives three paths through the entry
points a user calls (the 1024^2 Kerr a=0.9 shadow, the 1024^2
Schwarzschild shadow and the 512^2 Schwarzschild lensed render) and
checks what they produce, then the config-4 thin-disk render, the 1024^2
volumetric hot-flow and spectral renders, the polarized, flare-movie and
order-decomposition renders, and the card's arithmetic peak rates.
Phases:
  1. machine: card name and power limit, torch and nvcc versions;
  2. build: nvcc for sm_90a without FMA contraction (-fmad=false), with
     the build time and each kernel instance's registers and spills; for
     each extras instance also the blocks of 128 threads an SM holds
     (the runtime's occupancy query) and its functor's block bound;
  3. kernel vs plain version: 4,096 random rays (status agreement > 0.99,
     p99 |d final_alpha| < 2e-3 on stable escaped rays), a 128^2 image
     (shadow masks agree on >= 99.5% of pixels), and the main path's
     524,288 rays at 1024^2 (same gates), each with both times, the
     kernel alone by torch.profiler, the mean attempts and the lane
     efficiency (attempts over 32 x the warp step sum);
  4. main path: render_shadow once to warm up and 3 more times; the kernel
     launch counter must grow and the plain loop's stay at 0; the shadow
     must be the Kerr D inside the alpha_crit circle; then 3 frames under
     torch.profiler: launches, device ms and busy share a frame.
  5. orbit kernel vs plain version, Schwarzschild and Reissner-Nordstrom
     Q=0.6: 4,096 random rays in [0.2, 4] alpha_crit plus an alpha = 0
     lane, then the 1,048,576 rays of the 1024^2 grid (status agreement
     > 0.999, p99 |d final_alpha| < 1e-4 on stable escaped rays, the
     alpha = 0 lane INVALID), each with both times and both n_steps;
  6. config 1: the 1024^2 Schwarzschild shadow through render_shadow,
     warm-up and 3 runs; 1,048,576 traced rays, the orbit kernel launched
     and its plain loop not; captured pixels 0.98-1.02 x the analytic
     alpha_crit disk, none outside 1.01 alpha_crit;
  7. config 2: the 512^2 Schwarzschild lensed render through
     render_scene, warm-up and 3 runs, with every stage's time; a finite
     (512, 512, 3) float32 image whose black pixels are the captured rays;
     then a 64^2 render on the card against the CPU (shadow masks >= 99 %,
     bilinear image RMSE < 1e-3 on pixels of winding < 2).
  8. disk kernel vs plain version: 4,096 random rays (alpha in [0.01,
     0.12] rad, theta_obs = 80 deg), opaque and then translucent with
     momenta, and the 1,048,576 rays of the 1024^2 config-4 grid with
     both versions capped at 512 attempts (status and n_hits agreement
     > 0.99; on rays hit in both, median |d r_hits[0]| < 1e-3 M and p99
     < 0.1 M; median |d final_alpha| < 1e-4 on escaped no-hit rays), each
     with both times and both n_steps;
  9. two-pass drivers: on the 1024^2 disk grid, aligned and offset by a
     quarter pixel, trace_disk_rays_two_pass equals the single pass bitwise
     (status, n_hits, r_hits, phi_hits, final_alpha) whenever at most
     `slots` rays are unconverged, with both times; the disk driver over
     the kernel and over the plain loop on phase 8's 4,096 rays (phase 8's
     gates); trace_rays_kerr_two_pass on the main-path rays with
     pass1_steps = 64, bitwise against the single pass and over the plain
     loop; then render_shadow with two_pass=True equals phase 4's image;
 10. config 4: the 1024^2 Kerr a=0.9 thin-disk render through render_disk,
     warm-up and 3 runs; the disk kernel launched (through the two-pass
     driver) and its plain loop not; a finite (1024, 1024) float32 image in
     [0, 1] with disk pixels and captured rays, its brighter half > 2x the
     dimmer (Doppler beaming); then a 64^2 render on the card against the
     CPU (disk masks >= 99 %, median |d image| < 1e-3 on disk pixels).
 11. extras kernel vs plain version: 4,096 random rays (alpha in [0.3, 4]
     alpha_crit, theta_obs = 80 deg, max_steps 2500, sat_window 2048), the
     thin, absorbed (alpha0 0.5), jet (beta 0.6, index -1), 2-band
     (0.5/2, q 2) and 3-band (0.1/1/10, q 3) spectral forms (status
     agreement > 0.99, p99 |d tau| < 1e-3, p99 |d emission| / max per
     band < 1e-3, or < 2x the plain loop's own float32 gap from its
     float64 result on the same rays where that is larger), with both
     times and both n_steps;
 12. the 1024^2 volumetric scene (a = 0.9, theta_obs = 80 deg, FOV 16 deg,
     default RIAFConfig): the kernel's single pass against the two-pass
     drivers bitwise (thin and 3-band spectral; default first pass and a
     256-attempt one), the rays the saturation and frozen-state exits
     ended and the slowest rays; the plain loop against the kernel on the
     256^2 grid of the scene for each of phase 13's four paths, both
     capped at 1,024 attempts (phase 11's gates; the float64 run that
     widens a bar only for the 3-band form); both drivers (thin and
     3-band) over the kernel and over the plain loop on phase 11's rays;
 13. the four volumetric paths through render_volumetric and
     render_volumetric_spectrum at 1024^2 (thin, absorbed alpha0 0.3, jet
     beta 0.6, 3-band spectral 0.1/1/10), warm-up and 3 runs each: two
     kernel launches per driver call and no plain loop, finite images in
     [0, 1], the thin torus's Doppler crescent (half ratio > 2), absorbed
     emission below the thin, the SSA turnover and the growing
     photosphere of the spectrum; then 64^2 renders on the card against
     the CPU, the thin image and each band of the 3-band spectrum
     (emission masks >= 99 %, median |d image| < 1e-4).
 14. the Stokes, movie and order forms of the extras kernel vs the plain
     loop: Stokes (toroidal and vertical field, four per-ray aux
     constants), Movie<8> thin and absorbed (alpha0 0.3, spot_amp 8, eight
     frames over one blob period) and Order<3> thin and absorbed, on
     phase 11's 4,096 random rays with max_steps 1500 and sat_window 512
     (the plain loop costs ~10-40 ms an iteration, whatever the batch),
     against the plain loop in float32 and (Stokes, movie) float64; then
     the five forms of phase 15 on the scene's 256^2 grid, the Stokes
     and absorbed order forms at the main path's window, both capped at
     2,048 attempts (the lanes that reach that cap again with sat_window
     512, where the exits must end them in both), the movie and thin
     order forms with sat_window 512 capped at 1,024 (their plain loops
     take 60-105 s at 2,048 attempts);
     then each form's single pass on the 1024^2 scene (its time, the
     exits' counts and the slowest rays) with the two-pass driver
     bitwise against it. Gates: status agreement > 0.99; every
     Stokes and movie extra p99 |d| / max < 1e-3 (Q and U against
     max |I|), or < 2x the plain loop's own float32 gap from float64.
     A two-order form joins the random rays: its open-ended last bucket
     takes every later crossing.
     The order buckets are not held per ray (floor(m) switches where m
     sits within rounding of an integer after a crossing: a coin flip
     per ray and crossing) but every order on its own: its flux within
     max(3 %, 3 / sqrt(rays that carry it)) of its own plain flux, more
     than 40 % of its carriers with the same bucket value, the flux
     moved between orders < max(1 %, 1 / sqrt(carriers of order 0)) of
     the total, the buckets' sum per ray within 1e-3 of the largest
     (p99), the winding's p95 |dm| < 5e-3; the aux two-pass driver
     bitwise against the single pass, over the kernel and over the plain
     loop;
 15. the polarized, movie (thin and absorbed) and decomposed renders
     through render_polarized_volumetric, render_volumetric_movie and
     render_volumetric_decomposed at 1024^2 (a = 0.9, theta_obs = 80 deg,
     FOV 16 deg, psi = 0; eight frames over one period with spot_amp 8;
     three orders), warm-up and 3 runs each: two kernel launches per
     driver call and no plain loop; the light curve varies over the
     period and is flat with spot_amp 0; the orders sum to the thin image
     within 1e-3 of its peak on 99.9 % of the pixels (fewer than 1e-3 of
     them above it, each placed: an exit lane, the shadow's rim, or by
     its plane crossings) and in total flux within 1e-4 (the two traces
     carry other states and so take other steps) and their flux falls
     with order; pol_frac
     <= p0 and Q even, U odd under the top-bottom mirror at theta_obs =
     90 deg; then 64^2 renders on the card against the CPU, the absorbed
     movie and decomposition too, every order by phase 14's gates;
 16. the peak probe (its FMAs written out as fmaf / fma, which
     -fmad=false leaves fused): the chains against the same recurrence in
     torch
     (k = 64: float32 and float64 within 4 k ulp, sinf within 4 ulp, the
     eight-chain library forms within 4 k ulp of their sum) and the
     card's FP32 FMA (one chain and eight a thread), FP64 FMA, mixed and
     sinf rates from the marginal time between chain lengths 2,048 and
     8,192, and the rates of exp, pow, the IEEE division, sqrt, sin and
     cos in float32 and float64, eight chains a thread, between shorter
     lengths (peak_probe.CHAIN_LENGTHS).
 17. the float64 instances against the plain float64 loop: the Kerr and
     disk kernels on 1,024 of phases 3's and 8's rays, the orbit kernel
     on 1,024 rays and the alpha = 0 lane (Schwarzschild and RN), every
     extras form on phase 11's and 14's 4,096 rays against the float64
     plain runs those phases made (the orders' made here). Gates:
     statuses > 0.999; p99 |d final_alpha| < 1e-6 rad on stable escaped
     rays (orbit < 1e-8); disk median |d r_hits[0]| < 1e-6 M; extras p99
     |d| / max < 1e-6 (tau against max(1, max |tau|)); the orders by
     phase 14's flux gates. Then every entry-point family in float64 at
     64^2 on the card against the CPU (render_shadow, render_scene,
     render_disk, render_volumetric, _spectrum, _movie thin and absorbed,
     _decomposed, render_polarized_volumetric): only float64 instances
     launch, no float32 one and no plain loop; shadow pixels equal on
     99.9 %, masks 99.9 %, lensed RMSE < 1e-6, median |d image| < 1e-6,
     Stokes medians < 1e-8 of the peak, orders by flux. Then the float32
     kernel against the float64 one on the 1024^2 main-path rays: status
     agreement > 0.99, final-alpha RMSE on rays escaped in both, read
     against the north star's 1e-3 rad, and both times.
 18. the exact-cycle exit: each ray kernel with the exit and with it off
     (`_cycle_exit=False`, which grinds every attempt) on the aligned and
     quarter-offset 1024^2 config-4 disk grids, the 1024^2 Kerr shadow,
     and the volumetric scene's 1024^2 and 256^2 grids for the thin,
     absorbed, jet, 3-band, Stokes, movie and order forms at window
     2,048 (scripts/torch_cycle_census.py): every output bitwise equal
     (state or extras, status, final alpha, half-orbits, flags, per-ray
     attempts, warp step sum), with the lanes counted by kind (exact
     cycle and its period, frozen with a moving lambda, ground without
     freezing) and both times; the 256^2 order lane (171, 129).
 19. the reference's rays and the Kerr kernel's booking: config 4's rays
     (959, 510..512) of the aligned grid end as JAX ends them (escaped,
     no hit, 51, 51 and 17 attempts; with FMA contraction 511 froze), the
     quarter-offset grid's seven lanes that froze with contraction, capped
     at 1,000 attempts, as the plain loop on the CPU ends them (status,
     hits, attempts; two lanes still end otherwise, ROADMAP Queue 3 #1,
     and are printed, not gated), the 256^2 order lane (171, 129)
     captured as in the plain loop (its attempts printed); the in-kernel
     extraction against finalize_angles on the main path's final states
     (statuses, half-orbits and NaN masks equal, final alpha within 1e-6
     rad, 1e-13 in float64); the warp step sum the Kerr kernel books
     (each warp adds its largest attempt count) equal to torch's from the
     per-ray attempts, and its unconverged flags to the raw statuses, on
     the main path's 524,288 rays (float32 and float64) and on the
     aligned and quarter-offset config-4 grids, with the wrapper's time
     (CUDA events).
Each path's launch counters are set to 0 just before it and read just
after (float32 and float64 instances count apart: `.launches`,
`.launches_f64`). The second-to-last line is a JSON object of per-kernel
results: beside each kernel's time stand its flops-only bound `bound_ms`
(the larger of its flops over the H100's published 67 TFLOP/s float32
rate, 34 TFLOP/s for the float64 instances, and its bytes over 3.35
TB/s, from this run's per-ray attempt counts and the flops per attempt
counted from the CUDA sources with the library functions left out), the
counted bound `bound_counted_ms` (every operation of an attempt by kind,
`ops`, each at the rate phase 16 measured for it, a flop at no less than
half the published peak, ops/cuda/bounds.py), the slowest ray's attempts
with the time that ray takes when traced alone, and for the extras
kernel the instance it launched with its registers, spills (bytes, from
ptxas's report of the loaded library's build; null where that build kept
none), blocks an SM and block bound. The last line is
{"ok": true, "device": {...}}. Exit code 0 iff every phase passed;
without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from light_path_tracer_tpu_torch.ops.cuda import bounds  # noqa: E402
from light_path_tracer_tpu_torch.ops.cuda.bounds import (  # noqa: E402
    extras_work, kerr_work, orbit_work)

R_OBS = 100.0
LAMBDA_MAX = 5000.0
GATE_STEPS = 20000
KERNEL_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45.cu"
REPLACES = "light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py:40"
ORBIT_SOURCE = "light_path_tracer_tpu_torch/csrc/schwarzschild_rk4.cu"
ORBIT_REPLACES = ("light_path_tracer_tpu/ops/pallas/"
                  "schwarzschild_kernel.py:30")
DRIVER_SOURCE = "light_path_tracer_tpu_torch/ops/cuda/kerr_trace_kernel.py"
JAX_KERNELS = "light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py"
THETA_DISK = float(np.radians(80.0))


class SmokeFailure(Exception):
    pass


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, repeats):
    """Mean device time of fn() over `repeats` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, out


def device_profile(fn, reps, key=""):
    """Per call of fn, over `reps` calls after a warm-up, by torch.profiler:
    the wall ms (host clock, the profiler included), the device ms of every
    device activity, the kernel launches (copies and fills left out), the
    device's busy share of the wall time, and the launches of the kernels
    whose name holds `key` with their mean device ms a launch (the
    profiler on the card can drop a launch's record; the mean is over the
    launches it kept)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3 / reps
    device_us = key_us = 0.0
    launches = key_launches = 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or getattr(
            ev, "cuda_time_total", 0.0)
        if ev.device_type.name != "CUDA" or us <= 0.0:
            continue
        device_us += us
        if "Memcpy" in ev.key or "Memset" in ev.key:
            continue
        launches += ev.count
        if key and key in ev.key:
            key_us += us
            key_launches += ev.count
    device_ms = device_us / 1e3 / reps
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                launches=launches / reps, busy=device_ms / wall_ms,
                kernel_ms=key_us / 1e3 / max(key_launches, 1),
                kernel_launches=key_launches / reps)


def compare(rk, rp, alphas, ac):
    """Kernel result rk against plain result rp on the same rays: status
    agreement, and |d final_alpha| on stable escaped rays (escaped in
    both, |alpha - alpha_crit| > 0.05 alpha_crit)."""
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    fk, fp = rk.final_alpha.cpu().numpy(), rp.final_alpha.cpu().numpy()
    al = alphas.cpu().numpy().astype(np.float64)
    stable = (sk == 1) & (sp == 1) & (np.abs(al - ac) > 0.05 * ac)
    d = np.abs(fk[stable] - fp[stable]).astype(np.float64)
    return dict(status_agree=float((sk == sp).mean()),
                mask_agree=float((np.isnan(fk) == np.isnan(fp)).mean()),
                p99=float(np.percentile(d, 99)) if d.size else 0.0,
                max_abs=float(d.max()) if d.size else 0.0,
                stable=int(stable.sum()), captured=int((sk == -1).sum()))


def both_versions(label, metric, alphas, thetas, refine, max_steps,
                  kernel_repeats):
    """Run kernel and plain version on the same CUDA rays; print both."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_kerr_cuda, trace_rays_kerr_plain)
    args = (metric, R_OBS, alphas, thetas, np.pi / 2, refine, LAMBDA_MAX,
            max_steps)
    ms, rk = cuda_ms(lambda: trace_rays_kerr_cuda(*args), kernel_repeats)
    plain_ms, rp = cuda_ms(lambda: trace_rays_kerr_plain(*args), 1)
    cmp = compare(rk, rp, alphas, metric.alpha_crit(R_OBS))
    probe = {}
    trace_rays_kerr_cuda(*args, probe=probe)
    cmp.update(attempts_stats(probe["attempts"], lambda i: (
        trace_rays_kerr_cuda(metric, R_OBS, alphas[i:i + 1],
                             thetas[i:i + 1], np.pi / 2, refine[i:i + 1],
                             LAMBDA_MAX, max_steps))))
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps))
    # The kernel alone (device time) beside the wrapper, and how busy its
    # lanes were: attempts over 32 x the warp step sum.
    cmp["kernel_ms"] = device_profile(lambda: trace_rays_kerr_cuda(*args),
                                      kernel_repeats, "kerr_dp45")["kernel_ms"]
    cmp["attempts_mean"] = cmp["attempts_sum"] / cmp["n"]
    cmp["lane_efficiency"] = cmp["attempts_sum"] / (32 * cmp["n_steps_kernel"])
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    cmp["attempts"] = probe["attempts"]
    return cmp


def orbit_both(label, metric, alphas, kernel_repeats):
    """Orbit kernel and plain version on the same CUDA rays; print both,
    with the kernel's per-ray step statistics."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel import (
        trace_rays_schwarzschild_cuda, trace_rays_schwarzschild_plain)
    ms, rk = cuda_ms(lambda: trace_rays_schwarzschild_cuda(
        metric, R_OBS, alphas), kernel_repeats)
    plain_ms, rp = cuda_ms(lambda: trace_rays_schwarzschild_plain(
        metric, R_OBS, alphas), 1)
    _, steps = trace_rays_schwarzschild_cuda(metric, R_OBS, alphas,
                                             return_steps=True)
    st = steps.cpu().numpy()
    cmp = compare(rk, rp, alphas, metric.alpha_crit(R_OBS))
    warps = np.pad(st, (0, -st.size % 32)).reshape(-1, 32).max(axis=1)
    cmp.update(attempts_stats(steps, lambda i: (
        trace_rays_schwarzschild_cuda(metric, R_OBS, alphas[i:i + 1]))))
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps),
               steps_mean=float(st.mean()), steps_max=int(st.max()),
               lane_efficiency=float(st.sum() / (32.0 * warps.sum())))
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    return cmp, rk


def disk_compare(rk, rp):
    """Disk kernel result rk against plain result rp on the same rays:
    status and n_hits agreement, |d r_hits[0]| on rays hit in both, and
    |d final_alpha| on rays escaped with no hit in both."""
    sk, sp = rk.status.cpu().numpy(), rp.status.cpu().numpy()
    nk, npl = rk.n_hits.cpu().numpy(), rp.n_hits.cpu().numpy()
    both = (nk > 0) & (npl > 0)
    d = np.abs(rk.r_hits[0].cpu().numpy()[both]
               - rp.r_hits[0].cpu().numpy()[both]).astype(np.float64)
    fk, fp = rk.final_alpha.cpu().numpy(), rp.final_alpha.cpu().numpy()
    free = (nk == 0) & (npl == 0) & np.isfinite(fk) & np.isfinite(fp)
    dfa = np.abs(fk[free] - fp[free]).astype(np.float64)
    return dict(status_agree=float((sk == sp).mean()),
                nhits_agree=float((nk == npl).mean()),
                hit=int(both.sum()), two_hits=int((nk >= 2).sum()),
                median_dr=float(np.median(d)) if d.size else 0.0,
                p99_dr=float(np.percentile(d, 99)) if d.size else 0.0,
                max_dr=float(d.max()) if d.size else 0.0,
                free=int(free.sum()),
                median_dfa=float(np.median(dfa)) if dfa.size else 0.0)


def disk_both(label, metric, alphas, thetas, max_steps, plane, max_hits,
              kernel_repeats, record_momentum=False):
    """Disk kernel and plain version on the same CUDA rays; print both,
    and require the phase-8 gates."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_cuda, trace_disk_rays_plain)
    args = (metric, R_OBS, alphas, thetas, THETA_DISK, LAMBDA_MAX,
            max_steps, plane, max_hits)
    kw = dict(record_momentum=record_momentum)
    ms, rk = cuda_ms(lambda: trace_disk_rays_cuda(*args, **kw),
                     kernel_repeats)
    plain_ms, rp = cuda_ms(lambda: trace_disk_rays_plain(*args, **kw), 1)
    cmp = disk_compare(rk, rp)
    if record_momentum:
        both = ((rk.n_hits > 0) & (rp.n_hits > 0)).cpu()
        cmp["median_dpr"] = float(
            (rk.pr_hits[0].cpu() - rp.pr_hits[0].cpu()).abs()[both]
            .median())
    probe = {}
    trace_disk_rays_cuda(*args, probe=probe, **kw)
    cmp.update(attempts_stats(probe["attempts"], lambda i: (
        trace_disk_rays_cuda(metric, R_OBS, alphas[i:i + 1],
                             thetas[i:i + 1], *args[4:], **kw))))
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps))
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    require(cmp["status_agree"] > 0.99 and cmp["nhits_agree"] > 0.99
            and cmp["median_dr"] < 1e-3 and cmp["p99_dr"] < 0.1
            and cmp["median_dfa"] < 1e-4, f"{label} gate: {cmp}")
    cmp["attempts"] = probe["attempts"]
    return cmp


def same_bits(a, b):
    """Bitwise equality of two float or int tensors (NaN == NaN)."""
    import torch
    if a.dtype.is_floating_point:
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def disk_bitwise(r1, r2):
    fields = [(r1.status, r2.status), (r1.n_hits, r2.n_hits),
              (r1.final_alpha, r2.final_alpha)]
    fields += list(zip(r1.r_hits, r2.r_hits)) + list(zip(r1.phi_hits,
                                                         r2.phi_hits))
    return all(same_bits(a, b) for a, b in fields)


def kernel_label(mangled):
    """A short name for a kernel instance in ptxas's report."""
    import re
    real = {"f": "float", "d": "double"}
    m = re.search(r"kerr_dp45_kernelI([fd])Lb(\d)ELi(\d)ELb(\d)E", mangled)
    if m:
        return (f"kerr_dp45<{real[m.group(1)]},disk={m.group(2)},"
                f"hits={m.group(3)},momentum={m.group(4)}>")
    m = re.search(r"kerr_dp45_extras_kernelINS_\d+([A-Za-z]+)I(\w*?)([fd])EE",
                  mangled)
    if m:
        args = [v if k == "i" else ("absorbing=" + v)
                for k, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
        args.append(real[m.group(3)])
        return f"kerr_dp45_extras<{m.group(1)}<{','.join(args)}>>"
    m = re.search(r"orbit_rk4_kernelILb(\d)E([fd])", mangled)
    if m:
        return f"orbit_rk4<charged={m.group(1)},{real[m.group(2)]}>"
    m = re.search(r"\d+(fma8?_chain_kernel|mix_chain_kernel|"
                  r"sin_chain_kernel)(I[fd])?", mangled)
    if m:
        kind = {"If": "<float>", "Id": "<double>", None: ""}[m.group(2)]
        return f"peak_probe::{m.group(1)}{kind}"
    m = re.search(r"op8_chain_kernelINS_\d+(\w+?)StepE([fd])", mangled)
    if m:
        return (f"peak_probe::op8_chain_kernel<{m.group(1)},"
                f"{real[m.group(2)]}>")
    return mangled


def extras_resources(report):
    """Fill RESOURCES for every extras instance: what the runtime reports
    for the card (volumetric_kernel.describe_instance: registers, local
    memory, blocks an SM) and ptxas's spills (report: ptxas_report's rows
    of the loaded library's build; the spill fields are None where that
    build left no report); fails if an instance is missing or no block
    fits an SM."""
    import re
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    ptx = {name: spill for name, _regs, spill in report}
    for label, entry, form, variant, dtype in vk.extras_instances():
        require(label in ptx or not ptx, f"ptxas reported no {label}")
        d = vk.describe_instance(entry, form, variant, dtype)
        nums = dict((k, int(v)) for v, k in re.findall(
            r"(\d+) bytes (stack frame|spill stores|spill loads)",
            ptx.get(label, "")))
        require(d["blocks_per_sm"] > 0, f"{label}: {d}")
        RESOURCES[label] = dict(
            registers=d["registers"],
            spill_stores=nums.get("spill stores"),
            spill_loads=nums.get("spill loads"),
            stack_bytes=nums.get("stack frame"),
            local_bytes=d["local_bytes"], blocks_per_sm=d["blocks_per_sm"],
            min_blocks=d["min_blocks"])


def ptxas_report(log):
    """(kernel, registers, spill line) for each entry in nvcc's log."""
    import re
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_label(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name, spill = None, ""
    return rows


def attempts_stats(attempts, alone):
    """Sum and maximum of a launch's per-ray attempt counts, and the time
    the slowest ray takes when it is traced alone: alone(i) runs the same
    wrapper on ray i only."""
    import torch
    a = attempts.to(torch.int64)
    i = int(a.argmax())
    ms, _ = cuda_ms(lambda: alone(i), 3)
    return dict(attempts_sum=int(a.sum()), slowest_attempts=int(a[i]),
                slowest_alone_ms=ms)


def driver_attempts(attempts, pass1_steps):
    """Attempts a two-pass driver spends on rays whose single-pass counts
    are `attempts`: the first pass up to its cap, then the unconverged
    rays again from the start."""
    import torch
    a = attempts.to(torch.int64)
    return int(torch.clamp(a, max=pass1_steps).sum() + a[a > pass1_steps]
               .sum())


# Each extras instance's resources, filled in phase 2: label (as
# kernel_label names it) -> registers, spills, local memory, blocks an SM
# and block bound.
RESOURCES = {}


def kernel_entry(name, source, replaces, launches, max_abs_err, ms,
                 plain_ms, n, bytes_per_ray, work, stats=None,
                 instance=None):
    """One entry of the kernels line. work: the operations this run's
    inputs need (bounds.Work: per-ray attempts times one attempt's, in the
    instance's scalar type); bound_ms is the flops-only bound at the
    published peak of that type (the counted bound joins once phase 16
    has measured the card's rates); stats: attempts_stats of the timed
    call (a kernel's own single launch; a driver's entry has none);
    instance: the extras instance it launched, whose resources (phase 2)
    the entry carries."""
    n_bytes = n * bytes_per_ray
    bound, by = bounds.flops_bound_ms(work, n_bytes)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "rays": n, "flops": work.flops, "flops_type": work.dtype,
             "ops": work.ops, "bytes": n_bytes}
    if stats:
        entry.update({k: stats[k] for k in ("slowest_attempts",
                                            "slowest_alone_ms")
                      if k in stats})
    if instance:
        entry.update(instance=instance, **RESOURCES.get(instance, {}))
    return entry


THETA_VOL = float(np.radians(80.0))
VOL_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_extras.cu"
VOL_JAX = "light_path_tracer_tpu/ops/pallas/volumetric_kernel.py"
VOL_DRIVERS = "light_path_tracer_tpu_torch/ops/cuda/kerr_trace_kernel.py"
# Sizes of phases 11-13: random rays, the scene's grid, the plain loop's
# grid and the card-vs-CPU check.
VOL_RAYS = 4096
VOL_DIM = (1024, 1024)
VOL_PLAIN_DIM = (256, 256)
VOL_CHECK_DIM = (64, 64)
# Attempt cap of phase 11 and of phase 12's driver check: above the
# exits' ~2,150 attempts at sat_window 2048 (the plain loop costs ~10-30
# ms an iteration, and a lane that never ends runs to the cap).
VOL_STEPS = 2500
DRIVER_STEPS = 2500
# Attempt cap of phase 12's 256^2 grid, kernel and plain loop alike.
GRID_STEPS = 1024


def volumetric_forms():
    """Phase 11's forms: (RIAFConfig, spectral bands or None)."""
    from light_path_tracer_tpu_torch.volumetric import RIAFConfig
    return {"thin": (RIAFConfig(), None),
            "absorbed": (RIAFConfig(alpha0=0.5), None),
            "jet": (RIAFConfig(profile="jet", jet_beta=0.6, index=-1.0),
                    None),
            "spectral 2-band": (RIAFConfig(g_power=4.0, alpha0=1.0,
                                           opacity_index=2.0), (0.5, 2.0)),
            "spectral 3-band": scene_forms()["spectral 3-band"]}


def scene_forms():
    """The four paths of phases 12 and 13 (the rows of the JAX package's
    scripts/newmodes_bench.py): (RIAFConfig, spectral bands or None)."""
    from light_path_tracer_tpu_torch.volumetric import RIAFConfig
    return {"volumetric thin": (RIAFConfig(), None),
            "volumetric absorbed": (RIAFConfig(alpha0=0.3), None),
            "volumetric jet b=0.6": (RIAFConfig(profile="jet", jet_beta=0.6,
                                                index=-1.0), None),
            "spectral 3-band": (RIAFConfig(g_power=4.0, alpha0=1.0,
                                           opacity_index=3.0),
                                (0.1, 1.0, 10.0))}


def extras_trace(metric, riaf, freqs, alphas, thetas, max_steps, kernel,
                 **kw):
    """One volumetric or spectral trace through the kernel wrapper
    (kernel=True), its plain loop (False) or a two-pass driver (kw
    `driver`); returns (result, [emission-like extras], [tau-like])."""
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    driver = kw.pop("driver", False)
    args = (metric, R_OBS, alphas, thetas, THETA_VOL)
    if freqs:
        tf = volumetric.make_spectral_transfer(metric, riaf, freqs)
        plain = kerr_trace.trace_rays_spectral
        fn = vk.trace_rays_spectral_cuda if kernel else plain
        if driver:
            kw["trace_fn"] = fn
            fn = kk.trace_rays_spectral_two_pass
        res = fn(*args, tf, len(freqs), LAMBDA_MAX, max_steps, **kw)
        return res, list(res.emission), [res.tau_hat]
    em, ab = volumetric.make_transfer_fns(metric, riaf)
    plain = kerr_trace.trace_rays_volumetric
    fn = vk.trace_rays_volumetric_cuda if kernel else plain
    if driver:
        kw["trace_fn"] = fn
        fn = kk.trace_rays_volumetric_two_pass
    res = fn(*args, em, LAMBDA_MAX, max_steps, absorption_fn=ab, **kw)
    return res, [res.emission], [res.optical_depth]


def extras_compare(a, b):
    """Result a = (res, em, tau) against result b on the same rays:
    status agreement, p99 |d emission| / max(|b|) per band (and the
    largest), max |d emission|, p99 |d tau|."""
    sk, sp = a[0].status.cpu().numpy(), b[0].status.cpu().numpy()
    ok = sk == sp
    out = dict(status_agree=float(ok.mean()), p99_em_bands=[],
               max_abs_em=0.0, p99_tau=0.0)
    for xk, xp in zip(a[1], b[1]):
        xk = xk.cpu().numpy().astype(np.float64)
        xp = xp.cpu().numpy().astype(np.float64)
        d = np.abs(xk - xp)[ok]
        scale = max(np.abs(xp).max(), 1e-30)
        out["p99_em_bands"].append(float(np.percentile(d, 99)) / scale)
        out["max_abs_em"] = max(out["max_abs_em"], float(d.max()))
    out["p99_em"] = max(out["p99_em_bands"])
    for xk, xp in zip(a[2], b[2]):
        d = np.abs(xk.cpu().numpy().astype(np.float64)
                   - xp.cpu().numpy().astype(np.float64))[ok]
        out["p99_tau"] = max(out["p99_tau"], float(np.percentile(d, 99)))
    return out


def f32_gap(metric, riaf, freqs, alphas, thetas, max_steps, plain32, **kw):
    """The plain loop's own float32 result plain32 against its float64
    result on the same rays (extras_compare's numbers), and that float64
    result with its time (phase 17 holds the float64 kernel against it)."""
    ms, rp64 = cuda_ms(lambda: extras_trace(
        metric, riaf, freqs, alphas.double(), thetas.double(), max_steps,
        False, **kw), 1)
    return extras_compare(plain32, rp64), (rp64, ms)


def extras_gate(what, g, gap=None):
    """Phase 11's gates on kernel-vs-plain numbers g: status agreement
    > 0.99, p99 |d tau| < 1e-3, and p99 |d emission| / max per band
    below 1e-3, or below twice the plain loop's own float32 gap from
    float64 on the same rays (gap, where given) if that is larger: two
    float32 results each within e of the float64 one are within 2e of
    each other. (The 0.1 band of the 3-band spectrum, q 3, carries
    f^(1-q) = 100 times tau_hat's rounding.)"""
    if gap:
        g["f32_gap_em_bands"] = gap["p99_em_bands"]
        g["f32_gap_tau"] = gap["p99_tau"]
    g["em_bars"] = [max(1e-3, 2.0 * e) for e in g.get(
        "f32_gap_em_bands", [0.0] * len(g["p99_em_bands"]))]
    require(g["status_agree"] > 0.99
            and all(p < b for p, b in zip(g["p99_em_bands"], g["em_bars"]))
            and g["p99_tau"] < 1e-3, f"{what} gate: {g}")


def extras_bitwise(a, b):
    ra, rb = a[0], b[0]
    pairs = [(ra.status, rb.status), (ra.final_alpha, rb.final_alpha),
             (ra.n_half_orbits, rb.n_half_orbits)]
    pairs += list(zip(a[1], b[1])) + list(zip(a[2], b[2]))
    return all(same_bits(x, y) for x, y in pairs)


def grinders(probe, width):
    """Rays the saturation (flag 2) or frozen-state (flag 4) exit ended,
    and the rays that ran longest, from a kernel probe."""
    att = probe["attempts"].cpu().numpy()
    fl = probe["flags"].cpu().numpy()
    ended = (fl & 6) != 0
    top = np.argsort(att)[-5:][::-1]
    return dict(
        exited=int(ended.sum()),
        saturation_exits=int(((fl & 2) != 0).sum()),
        frozen_exits=int(((fl & 4) != 0).sum()),
        exit_attempts=([int(att[ended].min()), int(att[ended].max())]
                       if ended.any() else []),
        attempts_mean=float(att.mean()),
        attempts_p999=float(np.percentile(att, 99.9)),
        attempts_max=int(att.max()),
        slowest=[dict(row=int(i // width), col=int(i % width),
                      attempts=int(att[i]), flags=int(fl[i]))
                 for i in top])


def volumetric_phases(dev, card):
    """Phases 11-13; returns the kernels-line entries of the extras kernel
    and its drivers."""
    import torch
    from light_path_tracer_tpu_torch import camera, volumetric
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)

    # -- 11. extras kernel vs plain version -----------------------------
    kerr = Kerr(M=1.0, a=0.9)
    ac = kerr.alpha_crit(R_OBS, THETA_VOL)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, VOL_RAYS), **f32)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, VOL_RAYS), **f32)
    print(f"extras kernel vs plain version (f32 'fast', {VOL_RAYS} random "
          f"rays, max_steps {VOL_STEPS}, sat_window 2048):", flush=True)
    g11, gap11, plain64 = {}, {}, {}
    for label, (riaf, freqs) in volumetric_forms().items():
        probe = {}
        ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al, th, VOL_STEPS, True, sat_window=2048,
            probe=probe), 3)
        plain_ms, rp = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al, th, VOL_STEPS, False, sat_window=2048),
            1)
        g = extras_compare(rk, rp)
        g.update(ms=ms, plain_ms=plain_ms, n_steps_kernel=int(rk[0].n_steps),
                 n_steps_plain=int(rp[0].n_steps),
                 kernel_attempts=grinders(probe, VOL_RAYS)["slowest"][:2])
        g.update(attempts_stats(probe["attempts"], lambda i: extras_trace(
            kerr, riaf, freqs, al[i:i + 1], th[i:i + 1], VOL_STEPS, True,
            sat_window=2048)))
        gap11[label], plain64[label] = f32_gap(
            kerr, riaf, freqs, al, th, VOL_STEPS, rp, sat_window=2048)
        g11[label] = g
        extras_gate(f"phase 11 {label}", g, gap11[label])
        print(f"  {label}: {json.dumps(g)}", flush=True)
        g["attempts"] = probe["attempts"]

    # -- 12. the 1024^2 scene: single pass vs drivers --------------------
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS, theta_obs=THETA_VOL,
                        vertical_fov_deg=16.0)
    dim = VOL_DIM
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al12 = camera.build_alpha_lookup(dim, fov, **f32).reshape(-1)
    th12 = camera.build_theta_lookup(dim, fov, **f32).reshape(-1)
    forms12 = {"thin": scene_forms()["volumetric thin"],
               "spectral 3-band": scene_forms()["spectral 3-band"]}
    print(f"{dim[0]}^2 scene (a=0.9, theta_obs 80 deg, FOV 16 deg), kernel "
          f"single pass vs two-pass driver:", flush=True)
    g12 = {}
    for label, (riaf, freqs) in forms12.items():
        probe = {}
        kw = dict(sat_window=2048)
        one_ms, one = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al12, th12, 200000, True, **kw), 3)
        extras_trace(kerr, riaf, freqs, al12, th12, 200000, True, probe=probe,
                     **kw)
        two_ms, two = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al12, th12, 200000, True, driver=True, **kw),
            3)
        row = dict(single_ms=one_ms, two_pass_ms=two_ms,
                   bitwise_equal=extras_bitwise(one, two),
                   n_steps_single=int(one[0].n_steps),
                   n_steps_two_pass=int(two[0].n_steps),
                   over_4096_attempts=int(probe["attempts"].gt(4096).sum()))
        row.update(grinders(probe, dim[1]))
        if label == "thin":
            thin_exited = (probe["flags"] & 6).ne(0).cpu().numpy()
        p256 = {}
        extras_trace(kerr, riaf, freqs, al12, th12, 256, True, probe=p256,
                     **kw)
        n_unc = int((p256["flags"] & 1).sum())
        two256 = extras_trace(kerr, riaf, freqs, al12, th12, 200000, True,
                              driver=True, pass1_steps=256, **kw)
        row.update(unconverged_256=n_unc,
                   bitwise_equal_pass1_256=extras_bitwise(one, two256))
        g12[label] = row
        print(f"  {label}: {json.dumps(row)}", flush=True)
        require(row["bitwise_equal"] and (row["bitwise_equal_pass1_256"]
                                          or n_unc > 1024),
                f"phase 12 {label}: the driver differs from the single pass")
        del one, two, two256
    # The plain loop against the kernel on the 256^2 grid of the scene,
    # for each of phase 13's four paths, both capped at GRID_STEPS
    # attempts, below the exits' ~2,150 (the plain loop costs 10-50 ms an
    # iteration, so it never runs the 1024^2 grid in full; phase 11 and
    # the drivers check the exits).
    d256 = VOL_PLAIN_DIM
    fov256 = camera.fov_from_vertical(scene.vertical_fov, d256)
    al256 = camera.build_alpha_lookup(d256, fov256, **f32).reshape(-1)
    th256 = camera.build_theta_lookup(d256, fov256, **f32).reshape(-1)
    g256 = {}
    for label, (riaf, freqs) in scene_forms().items():
        ms256, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al256, th256, GRID_STEPS, True,
            sat_window=2048), 3)
        plain256, rp = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al256, th256, GRID_STEPS, False,
            sat_window=2048), 1)
        g = extras_compare(rk, rp)
        g.update(ms=ms256, plain_ms=plain256,
                 n_steps_kernel=int(rk[0].n_steps),
                 n_steps_plain=int(rp[0].n_steps))
        g256[label] = g
        # The float64 run only where a bar needs it: the 3-band form.
        gap = (f32_gap(kerr, riaf, freqs, al256, th256, GRID_STEPS, rp,
                       sat_window=2048)[0] if freqs else None)
        extras_gate(f"phase 12 256^2 {label}", g, gap)
        print(f"  {label}, {d256[0]}^2 grid, both capped at {GRID_STEPS}: "
              f"{json.dumps(g)}", flush=True)
    # Both drivers over the kernel and over the plain loop, on phase
    # 11's 4,096 rays with a 64-attempt first pass, capped at 2,500
    # attempts (the plain loop costs ~10 ms an iteration).
    drv = {}
    for label in ("thin", "spectral 3-band"):
        riaf, freqs = volumetric_forms()[label]
        k_ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al, th, DRIVER_STEPS, True, driver=True,
            pass1_steps=64), 3)
        p_ms, rp = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al, th, DRIVER_STEPS, False, driver=True,
            pass1_steps=64), 1)
        probe = {}
        single = extras_trace(kerr, riaf, freqs, al, th, DRIVER_STEPS, True,
                              probe=probe)
        g = extras_compare(rk, rp)
        g.update(ms=k_ms, plain_ms=p_ms, bitwise_equal=extras_bitwise(
            single, rk), attempts_sum=driver_attempts(probe["attempts"],
                                                      64))
        drv[label] = g
        extras_gate(f"phase 12 {label} driver", g, gap11[label])
        print(f"  {label} driver, {VOL_RAYS} random rays, pass1_steps 64, "
              f"kernel vs plain loop: {json.dumps(g)}", flush=True)
        require(g["bitwise_equal"], f"phase 12 {label} driver differs "
                f"from the single pass")
    del al12, th12, rk, rp

    # -- 13. the four paths through the entry points ----------------------
    cfg = RenderConfig()
    paths = {label: riaf for label, (riaf, _f) in scene_forms().items()}
    freqs3 = scene_forms()["spectral 3-band"][1]
    counters = (vk.trace_rays_volumetric_cuda, vk.trace_rays_aux_cuda,
                kk.trace_rays_volumetric_two_pass,
                kk.trace_rays_spectral_two_pass,
                kerr_trace.trace_rays_volumetric,
                kerr_trace.trace_rays_spectral, kerr_trace.trace_rays_aux)
    launches = {"volumetric": 0, "spectral": 0, "vol_driver": 0,
                "spec_driver": 0}
    totals = {}
    for label, riaf in paths.items():
        spectral = label.startswith("spectral")
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)

        def render():
            if spectral:
                return volumetric.render_volumetric_spectrum(
                    scene, dim, freqs3, cfg, riaf, device="cuda")
            return volumetric.render_volumetric(scene, dim, cfg, riaf,
                                                device="cuda")
        img, st = render()                                   # warmup
        runs = []
        for _ in range(3):
            img, st = render()
            runs.append(dict(st["timings"]))
        best = max(st["traced_rays"] / t["precompute"] for t in runs)
        n_kernel = (vk.trace_rays_aux_cuda if spectral
                    else vk.trace_rays_volumetric_cuda).launches
        n_driver = (kk.trace_rays_spectral_two_pass if spectral
                    else kk.trace_rays_volumetric_two_pass).launches
        n_plain = sum(c.launches for c in counters[4:])
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        launches["spectral" if spectral else "volumetric"] += n_kernel
        launches["spec_driver" if spectral else "vol_driver"] += n_driver
        row = dict(kernel_launches=n_kernel, driver_calls=n_driver,
                   plain_loop_calls=n_plain, best_rays_per_s=best,
                   peak_mib=peak, captured=st["captured"],
                   integrator_steps=st["integrator_steps"],
                   timings=runs)
        require(n_kernel == 8 and n_driver == 4 and n_plain == 0,
                f"{label}: {n_kernel} kernel launches, {n_driver} driver "
                f"calls, {n_plain} plain calls")
        require(st["traced_rays"] == dim[0] * dim[1]
                and bool(torch.isfinite(img).all())
                and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                f"{label}: bad image")
        em = st["emission"]
        if spectral:
            flux, rad = st["flux"], st["mean_radius_rad"]
            row.update(flux=flux.tolist(), mean_radius_rad=rad.tolist())
            require(flux[1] > 2.0 * flux[0] and flux[1] > 2.0 * flux[2]
                    and rad[0] > rad[1] > rad[2],
                    f"{label}: no SSA turnover: flux {flux}, radii {rad}")
        else:
            h = dim[1] // 2
            left, right = em[:, 1:h].sum(), em[:, h + 1:].sum()
            row.update(emission_total=st["emission_total"],
                       half_ratio=float(max(left, right)
                                        / max(min(left, right), 1e-30)),
                       tau_max=st["tau_max"])
            totals[label] = st["emission_total"]
            require(np.isfinite(em).all() and st["emission_total"] > 0,
                    f"{label}: emission not finite and positive")
            if label == "volumetric thin":
                thin_map = em
        print(f"{label} {dim[0]}^2: {json.dumps(row)}; best {best:,.0f} "
              f"rays/s on {card}", flush=True)
        if label == "volumetric thin":
            require(row["half_ratio"] > 2.0,
                    f"no Doppler crescent: half ratio {row['half_ratio']}")
    require(totals["volumetric absorbed"] < totals["volumetric thin"],
            f"absorbed emission {totals['volumetric absorbed']} is not "
            f"below the thin {totals['volumetric thin']}")

    d64 = VOL_CHECK_DIM
    og, sg = volumetric.render_volumetric(scene, d64, cfg, device="cuda")
    oc, sc = volumetric.render_volumetric(scene, d64, cfg, device="cpu")
    mask_agree = float(((sg["emission"] > 0) == (sc["emission"] > 0)).mean())
    d = float((og.cpu() - oc).abs().median())
    print(f"volumetric check, 64^2 card vs CPU: emission masks agree "
          f"{mask_agree:.4f}, median |d image| {d:.3e}", flush=True)
    require(mask_agree >= 0.99 and d < 1e-4,
            f"64^2 volumetric card vs CPU: masks {mask_agree}, median {d}")
    riaf3 = paths["spectral 3-band"]
    og, sg = volumetric.render_volumetric_spectrum(scene, d64, freqs3, cfg,
                                                   riaf3, device="cuda")
    oc, sc = volumetric.render_volumetric_spectrum(scene, d64, freqs3, cfg,
                                                   riaf3, device="cpu")
    masks = [float(((sg["emission"][b] > 0) == (sc["emission"][b] > 0))
                   .mean()) for b in range(len(freqs3))]
    meds = [float((og[b].cpu() - oc[b]).abs().median())
            for b in range(len(freqs3))]
    print(f"spectral check, 64^2 card vs CPU, per band: emission masks "
          f"agree {masks}, median |d image| {meds}", flush=True)
    require(min(masks) >= 0.99 and max(meds) < 1e-4,
            f"64^2 spectral card vs CPU: masks {masks}, medians {meds}")

    thin, spec = g11["thin"], g11["spectral 3-band"]
    n_bands = len(freqs3)
    thin_work = extras_work("thin")
    spec_work = extras_work("spectral", n_bands)
    thin_inst = "kerr_dp45_extras<VolThin<float>>"
    spec_inst = f"kerr_dp45_extras<Spectral<{n_bands},float>>"
    state = dict(kerr=kerr, al=al, th=th, scene=scene, cfg=cfg,
                 thin_emission=thin_map, thin_exited=thin_exited,
                 plain64_11=plain64)
    return [
        kernel_entry("kerr_dp45_extras", VOL_SOURCE, f"{VOL_JAX}:53",
                     launches["volumetric"], thin["max_abs_em"], thin["ms"],
                     thin["plain_ms"], VOL_RAYS, 8 + 4 * 5,
                     thin["attempts_sum"] * thin_work, thin, thin_inst),
        kernel_entry("trace_rays_volumetric_two_pass", VOL_DRIVERS,
                     f"{VOL_JAX}:209", launches["vol_driver"],
                     drv["thin"]["max_abs_em"], drv["thin"]["ms"],
                     drv["thin"]["plain_ms"], VOL_RAYS, 8 + 4 * 5,
                     drv["thin"]["attempts_sum"] * thin_work,
                     instance=thin_inst),
        kernel_entry("kerr_dp45_extras_spectral", VOL_SOURCE,
                     f"{VOL_JAX}:276", launches["spectral"],
                     spec["max_abs_em"], spec["ms"], spec["plain_ms"],
                     VOL_RAYS, 8 + 4 * (5 + n_bands),
                     spec["attempts_sum"] * spec_work, spec, spec_inst),
        kernel_entry("trace_rays_spectral_two_pass", VOL_DRIVERS,
                     f"{VOL_JAX}:476", launches["spec_driver"],
                     drv["spectral 3-band"]["max_abs_em"],
                     drv["spectral 3-band"]["ms"],
                     drv["spectral 3-band"]["plain_ms"], VOL_RAYS,
                     8 + 4 * (5 + n_bands),
                     drv["spectral 3-band"]["attempts_sum"] * spec_work,
                     instance=spec_inst)
    ], state


STOKES_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_stokes.cu"
MOVIE_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_movie_{}.cu"
ORDER_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45_orders.cu"
PROBE_SOURCE = "light_path_tracer_tpu_torch/csrc/peak_probe.cu"
# Phase 14's depth: the plain loop costs ~10 ms an iteration whatever the
# batch, so its runs are capped here and the exits' window is short.
AUX_STEPS = 1500
AUX_WINDOW = 512
# The 256^2 grid's forms with (attempt cap, sat_window): the main path's
# window with the cap at 2,048, except the movie and thin order forms,
# whose plain loops cost 30-50 ms an iteration (60-105 s at 2,048 on an
# H100's host).
GRID_FORMS = {"stokes toroidal": (2048, 2048), "movie thin": (1024, 512),
              "movie absorbed": (1024, 512), "order thin": (1024, 512),
              "order absorbed": (2048, 2048)}
N_FRAMES = 8
N_ORDERS = 3
P0 = 0.7


def aux_forms(metric, al, th):
    """Phase 14's forms on rays (al, th): label -> (transfer_fn, n_extras,
    aux, sat_monitor, the form as bounds.extras_work takes it)."""
    from light_path_tracer_tpu_torch import polarization, volumetric
    from light_path_tracer_tpu_torch.disk import keplerian_omega
    period = 2.0 * np.pi / abs(keplerian_omega(1.0, 0.9, 6.0, True))
    times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
    forms = {}
    aux = polarization.camera_constants(metric, R_OBS, THETA_VOL, al, th)
    for field in ("toroidal", "vertical"):
        forms[f"stokes {field}"] = (
            polarization.make_polarized_volumetric_transfer(
                metric, volumetric.RIAFConfig(), field, P0), 3, aux,
            (0, 1, 2), dict(kind="stokes", field=field))
    for a0 in (0.0, 0.3):
        ab = int(a0 > 0)
        riaf = volumetric.RIAFConfig(spot_amp=8.0, alpha0=a0)
        name = "absorbed" if ab else "thin"
        forms[f"movie {name}"] = (
            volumetric.make_movie_transfer(metric, riaf, times),
            1 + ab + N_FRAMES, (),
            tuple(range(1 + ab, 1 + ab + N_FRAMES)),
            dict(kind="movie", width=N_FRAMES, absorbing=bool(ab)))
        riaf = volumetric.RIAFConfig(alpha0=a0)
        forms[f"order {name}"] = (
            volumetric.make_order_transfer(metric, riaf, N_ORDERS),
            1 + ab + N_ORDERS, (),
            tuple(range(1 + ab, 1 + ab + N_ORDERS)),
            dict(kind="order", width=N_ORDERS, absorbing=bool(ab)))
    return forms


def extras_label(desc, real="float"):
    """The extras instance (as kernel_label names it) of a phase-14 form's
    bounds description."""
    kind, width = desc["kind"], desc.get("width", 0)
    ab = int(desc.get("absorbing", False))
    args = {"stokes": "", "movie": f"{width},absorbing={ab},",
            "order": f"{width},absorbing={ab},"}[kind]
    return f"kerr_dp45_extras<{kind.capitalize()}<{args}{real}>>"


def aux_trace(metric, form, al, th, max_steps, kernel, **kw):
    """One trace of a phase-14 form through the kernel wrapper
    (kernel=True), the plain loop (False) or the aux two-pass driver (kw
    `driver`) on rays of either precision; returns ExtrasResult."""
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    tf, n_extras, aux, monitor, _work = form
    driver = kw.pop("driver", False)
    aux = tuple(a.to(al.dtype) for a in aux)
    plain_tf = tf if aux else (lambda y, pt, pp, _aux: tf(y, pt, pp))
    fn = vk.trace_rays_aux_cuda if kernel else kerr_trace.trace_rays_aux
    use = tf if kernel else plain_tf
    if driver:
        kw["trace_fn"] = fn
        fn = kk.trace_rays_aux_two_pass
    return fn(metric, R_OBS, al, th, THETA_VOL, use, n_extras, aux,
              LAMBDA_MAX, max_steps, sat_monitor=monitor, **kw)


def aux_compare(rk, rp, label, width=N_ORDERS):
    """Kernel result rk against plain result rp: status agreement and,
    per extra, p99 |d| / max |plain| on rays of equal status (the Stokes
    Q and U against max |I|). For the order forms (`width` buckets, the
    last extras) also: p99 of the
    buckets' sum per ray against the largest sum; each order's flux
    against its own plain flux (flux_rel) and the largest move against
    the total (flux_shift); and, per order, of the rays that carry it in
    the plain loop (that bucket above 5 % of the ray's sum, the sum above
    1e-3 of the largest) the share whose kernel bucket sits within 1 % of
    the ray's sum (bucket_match, of `carriers` rays)."""
    ok = (rk.status == rp.status).cpu().numpy()
    xk = np.stack([e.double().cpu().numpy() for e in rk.extras])
    xp = np.stack([e.double().cpu().numpy() for e in rp.extras])
    scales = np.maximum(np.abs(xp).max(axis=1), 1e-30)
    if label.startswith("stokes"):
        scales[:] = scales[0]
    d = np.abs(xk - xp)[:, ok]
    out = dict(status_agree=float(ok.mean()),
               p99=(np.percentile(d, 99, axis=1) / scales).tolist(),
               max_abs=float(d.max()))
    if label.startswith("order"):
        out.update(order_numbers(xk[-width:][:, ok], xp[-width:][:, ok]))
        out["p95_m"] = float(np.percentile(d[0], 95))
    return out


def order_numbers(bk, bp):
    """aux_compare's numbers of the order buckets bk (kernel) against bp
    (plain), each (orders, rays)."""
    sk, sp = bk.sum(axis=0), bp.sum(axis=0)
    fk, fp = bk.sum(axis=1), bp.sum(axis=1)
    carry = (sp > 1e-3 * sp.max()) & (bp > 0.05 * sp)
    near = np.abs(bk - bp) < 0.01 * sp
    carriers = carry.sum(axis=1)
    return dict(
        p99_sum=float(np.percentile(np.abs(sk - sp), 99)
                      / max(sp.max(), 1e-30)),
        flux_kernel=fk.tolist(), flux_plain=fp.tolist(),
        flux_rel=(np.abs(fk - fp) / fp).tolist(),
        flux_shift=float(np.abs(fk - fp).max() / fp.sum()),
        carriers=carriers.tolist(),
        bucket_match=((near & carry).sum(axis=1)
                      / np.maximum(carriers, 1)).tolist())


def order_gate(g):
    """The order buckets' gates on order_numbers g. After a crossing m
    sits within rounding of an integer, so floor(m) puts the stretch of
    path up to the next crossing in either neighbour: a coin flip per ray
    and crossing, and single rays differ. Every order is still held on
    its own, with bars that follow the coin flips' 1 / sqrt(rays)
    (neighbouring rays flip alike, so the factors are 2.5-3x the largest
    readings on the H100): its flux within max(3 %, 3 / sqrt(carriers))
    of its own plain flux, at least 20 carriers, of which more than 40 %
    have the same bucket value; the flux moved between orders at most
    max(1 %, 1 / sqrt(carriers of order 0)) of the total; the buckets'
    sum per ray within 1e-3 of the largest (p99)."""
    n = np.maximum(np.asarray(g["carriers"], dtype=np.float64), 1.0)
    g["flux_bars"] = np.maximum(0.03, 3.0 / np.sqrt(n)).tolist()
    g["flux_shift_bar"] = float(max(0.01, 1.0 / np.sqrt(n[0])))
    return (g["p99_sum"] < 1e-3 and g["flux_shift"] < g["flux_shift_bar"]
            and all(r < b for r, b in zip(g["flux_rel"], g["flux_bars"]))
            and min(g["carriers"]) >= 20 and min(g["bucket_match"]) > 0.4)


def aux_gate(what, g, gap=None):
    """Phase 14's gates on kernel-vs-plain numbers g; gap: the plain
    loop's own float32-vs-float64 numbers on the same rays, which raise a
    bar of 1e-3 to twice the gap where given. The order forms' buckets
    are held by order_gate, their winding by its p95."""
    if "p99_sum" in g:
        if gap:
            g["f32_gap_flux_rel"] = gap["flux_rel"]
            g["f32_gap_flux_shift"] = gap["flux_shift"]
        require(g["status_agree"] > 0.99 and order_gate(g)
                and g["p95_m"] < 5e-3, f"{what} gate: {g}")
        return
    n = len(g["p99"])
    g["bars"] = [max(1e-3, 2.0 * e) for e in (gap["p99"] if gap
                                              else [0.0] * n)]
    if gap:
        g["f32_gap"] = gap["p99"]
    require(g["status_agree"] > 0.99
            and all(p < b for p, b in zip(g["p99"], g["bars"])),
            f"{what} gate: {g}")


def aux_both(what, metric, label, form, al, th, max_steps, window,
             f64=True, repeats=3):
    """Kernel and plain loop (float32, and with f64 the float64 run that
    sets the bars) of one form on the same rays; prints and gates;
    returns the numbers with the kernel's per-ray attempts."""
    kw = dict(sat_window=window)
    probe = {}
    ms, rk = cuda_ms(lambda: aux_trace(metric, form, al, th, max_steps, True,
                                       probe=probe, **kw), repeats)
    plain_ms, rp = cuda_ms(lambda: aux_trace(metric, form, al, th, max_steps,
                                             False, **kw), 1)
    width = len(form[3])
    g = aux_compare(rk, rp, label, width)
    g.update(ms=ms, plain_ms=plain_ms, n_steps_kernel=int(rk.n_steps),
             n_steps_plain=int(rp.n_steps),
             exits=int((probe["flags"] & 6).ne(0).sum()))
    g.update(attempts_stats(probe["attempts"], lambda i: aux_trace(
        metric, (form[0], form[1], tuple(a[i:i + 1] for a in form[2]),
                 form[3], form[4]), al[i:i + 1], th[i:i + 1], max_steps,
        True, **kw)))
    gap = plain64 = None
    if f64:
        plain64 = cuda_ms(lambda: aux_trace(metric, form, al.double(),
                                            th.double(), max_steps, False,
                                            **kw), 1)
        gap = aux_compare(rp, plain64[1], label, width)
    aux_gate(f"{what} {label}", g, gap)
    print(f"  {label}: {json.dumps(g)}", flush=True)
    g["attempts"] = probe["attempts"]
    g["plain64"] = plain64
    return g


def aux_exits(metric, label, form, al, th, lanes):
    """The lanes of a capped run that reached the cap, again with the
    exits' window at AUX_WINDOW and twice that as the cap, in the kernel
    and in the plain loop: the exits must end every lane in both. (The
    status may differ: a lane that freezes in the kernel need not freeze
    in the plain loop, whose products are not contracted to FMA.)"""
    if lanes.numel() == 0:
        print(f"  {label}: no lane reached the cap", flush=True)
        return
    sub = (form[0], form[1], tuple(a[lanes] for a in form[2]), form[3],
           form[4])
    probe = {}
    kw = dict(sat_window=AUX_WINDOW, return_unconverged=True)
    rk, uk = aux_trace(metric, sub, al[lanes], th[lanes], 2 * AUX_WINDOW,
                       True, probe=probe, **kw)
    rp, up = aux_trace(metric, sub, al[lanes], th[lanes], 2 * AUX_WINDOW,
                       False, **kw)
    row = dict(lanes=int(lanes.numel()),
               kernel_exits=int((probe["flags"] & 6).ne(0).sum()),
               kernel_attempts=[int(probe["attempts"].min()),
                                int(probe["attempts"].max())],
               kernel_capped=int(uk.sum()), plain_capped=int(up.sum()),
               status_agree=float((rk.status == rp.status).float().mean()))
    print(f"  {label}, the {row['lanes']} lanes at the cap, sat_window "
          f"{AUX_WINDOW}, capped at {2 * AUX_WINDOW}: {json.dumps(row)}",
          flush=True)
    require(row["kernel_exits"] > 0 and row["kernel_capped"] == 0
            and row["plain_capped"] == 0,
            f"phase 14 {label}: the exits do not end the frozen lanes")


def aux_scene(metric, label, form, al, th, width):
    """A form's single pass on the 1024^2 scene's rays at the main path's
    depth and window, with the exits' counts and the slowest rays, and
    its two-pass driver bitwise against it; prints; returns the row, the
    single-pass result and the probe."""
    import torch
    kw = dict(sat_window=2048)
    one_ms, one = cuda_ms(lambda: aux_trace(metric, form, al, th, 200000,
                                            True, **kw), 3)
    probe = {}
    aux_trace(metric, form, al, th, 200000, True, probe=probe, **kw)
    two_ms, two = cuda_ms(lambda: aux_trace(metric, form, al, th, 200000,
                                            True, driver=True, **kw), 3)
    same = all(same_bits(a, b) for a, b in zip(
        (one.status, one.final_alpha, *one.extras),
        (two.status, two.final_alpha, *two.extras)))
    two256 = aux_trace(metric, form, al, th, 200000, True, driver=True,
                       pass1_steps=256, **kw)
    same256 = all(same_bits(a, b) for a, b in zip(
        (one.status, one.final_alpha, *one.extras),
        (two256.status, two256.final_alpha, *two256.extras)))
    n_unc = int(probe["attempts"].gt(256).sum())
    row = dict(single_ms=one_ms, two_pass_ms=two_ms, bitwise_equal=same,
               over_256_attempts=n_unc, bitwise_equal_pass1_256=same256,
               n_steps_single=int(one.n_steps),
               attempts_sum=int(probe["attempts"].to(torch.int64).sum()))
    row.update(grinders(probe, width))
    print(f"  {label}: {json.dumps(row)}", flush=True)
    require(same and (same256 or n_unc > 1024),
            f"phase 14 {label}: the driver differs from the single pass on "
            f"the scene")
    return row, one, probe


def new_mode_phases(dev, card, state):
    """Phases 14 and 15; returns the kernels-line entries of the Stokes,
    movie and order forms and of the aux driver."""
    import torch
    from light_path_tracer_tpu_torch import (camera, polarization,
                                             volumetric)
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.utils.config import SceneConfig

    kerr, al, th = state["kerr"], state["al"], state["th"]
    scene, cfg = state["scene"], state["cfg"]
    f32 = dict(dtype=torch.float32, device=dev)

    # -- 14. Stokes, movie and order forms vs the plain loop -------------
    print(f"aux, movie and order forms vs plain version (f32 'fast', "
          f"{VOL_RAYS} random rays, max_steps {AUX_STEPS}, sat_window "
          f"{AUX_WINDOW}):", flush=True)
    forms = aux_forms(kerr, al, th)
    g14 = {label: aux_both("phase 14", kerr, label, form, al, th, AUX_STEPS,
                           AUX_WINDOW, f64=not label.startswith("order"))
           for label, form in forms.items()}
    state.update(g14=g14, forms14=forms)
    # Two orders: the open-ended last bucket takes every later crossing
    # (2 % of the flux), so a last bucket that is closed breaks the sum.
    aux_both("phase 14", kerr, "order x2 thin", (
        volumetric.make_order_transfer(kerr, volumetric.RIAFConfig(), 2),
        3, (), (1, 2), dict(kind="order", width=2)),
        al, th, AUX_STEPS, AUX_WINDOW, f64=False)
    d256 = VOL_PLAIN_DIM
    fov256 = camera.fov_from_vertical(scene.vertical_fov, d256)
    al256 = camera.build_alpha_lookup(d256, fov256, **f32).reshape(-1)
    th256 = camera.build_theta_lookup(d256, fov256, **f32).reshape(-1)
    forms256 = aux_forms(kerr, al256, th256)
    print(f"  the scene's {d256[0]}^2 grid, kernel and plain loop capped "
          f"alike (attempt cap, sat_window): {json.dumps(GRID_FORMS)}",
          flush=True)
    for label, (cap, window) in GRID_FORMS.items():
        g = aux_both(f"phase 14 {d256[0]}^2", kerr, label, forms256[label],
                     al256, th256, cap, window, f64=False)
        if window > AUX_WINDOW:
            aux_exits(kerr, label, forms256[label], al256, th256,
                      g["attempts"].ge(cap).nonzero().reshape(-1))
    # Each form's single pass on the 1024^2 scene, as phase 12 has it for
    # the thin and 3-band forms: the kernel time that sets phase 15's
    # frames, and who sets it.
    dim = VOL_DIM
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al15 = camera.build_alpha_lookup(dim, fov, **f32).reshape(-1)
    th15 = camera.build_theta_lookup(dim, fov, **f32).reshape(-1)
    forms15 = aux_forms(kerr, al15, th15)
    print(f"  {dim[0]}^2 scene, kernel single pass (max_steps 200000, "
          f"sat_window 2048) vs two-pass driver:", flush=True)
    scene14 = {}
    for label in GRID_FORMS:
        row, one, probe = aux_scene(kerr, label, forms15[label], al15, th15,
                                    dim[1])
        scene14[label] = row
        if label == "order thin":
            order_one = dict(
                exited=(probe["flags"] & 6).ne(0).cpu().numpy(),
                status=one.status.cpu().numpy(),
                winding=one.extras[0].cpu().numpy())
        del one, probe
    del al15, th15, forms15
    # The Mosaic reject limit cycle of ROADMAP Queue 3: the 256^2 order
    # decomposition's pixel (171, 129), in the kernel and the plain loop.
    lane = 171 * d256[1] + 129
    probe = {}
    sl = slice(lane, lane + 1)
    order = forms256["order thin"]
    aux_trace(kerr, order, al256[sl], th256[sl], 200000, True,
              sat_window=2048, probe=probe)
    res_p, unconv_p = aux_trace(kerr, order, al256[sl].cpu(),
                                th256[sl].cpu(), 6000, False,
                                sat_window=2048, return_unconverged=True)
    print(f"  order decomposition, {d256[0]}^2 pixel (171, 129), alpha "
          f"{float(al256[lane]):.6f}: kernel attempts "
          f"{int(probe['attempts'][0])}, flags {int(probe['flags'][0])} "
          f"(2 saturation exit, 4 frozen-state exit); plain loop on the "
          f"CPU n_steps {int(res_p.n_steps)} of 6000, status "
          f"{int(res_p.status[0])}, step-capped {bool(unconv_p[0])}",
          flush=True)
    # The aux driver over the kernel and over the plain loop, bitwise
    # against the single pass, with a 64-attempt first pass.
    stokes = forms["stokes toroidal"]
    k_ms, rk = cuda_ms(lambda: aux_trace(kerr, stokes, al, th, AUX_STEPS,
                                         True, driver=True, pass1_steps=64),
                       3)
    p_ms, rp = cuda_ms(lambda: aux_trace(kerr, stokes, al, th, AUX_STEPS,
                                         False, driver=True, pass1_steps=64),
                       1)
    probe = {}
    single = aux_trace(kerr, stokes, al, th, AUX_STEPS, True, probe=probe)
    _r, unc = aux_trace(kerr, stokes, al, th, 64, True,
                        return_unconverged=True)
    same = all(same_bits(a, b) for a, b in zip(
        (single.status, single.final_alpha, *single.extras),
        (rk.status, rk.final_alpha, *rk.extras)))
    g_drv = aux_compare(rk, rp, "stokes toroidal")
    g_drv.update(ms=k_ms, plain_ms=p_ms, bitwise_equal=same,
                 unconverged_64=int(unc.sum()),
                 attempts_sum=driver_attempts(probe["attempts"], 64))
    print(f"  aux driver (Stokes), {VOL_RAYS} random rays, pass1_steps 64, "
          f"kernel vs plain loop: {json.dumps(g_drv)}", flush=True)
    require(same and 0 < g_drv["unconverged_64"] <= 1024,
            "the aux driver differs from the single pass")
    require(g_drv["status_agree"] > 0.99 and max(g_drv["p99"]) < 1e-3,
            f"aux driver kernel vs plain gate: {g_drv}")

    # -- 15. the three renders through their entry points -----------------
    dim = VOL_DIM
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                           True))
    times = tuple(period * k / N_FRAMES for k in range(N_FRAMES))
    blob = volumetric.RIAFConfig(spot_amp=8.0)
    paths = {
        "polarized": lambda d, device: (
            polarization.render_polarized_volumetric(
                scene, d, cfg, volumetric.RIAFConfig(), p0=P0,
                device=device)),
        "movie 8-frame": lambda d, device: (
            volumetric.render_volumetric_movie(scene, d, times, cfg, blob,
                                               device=device)),
        "movie 8-frame absorbed": lambda d, device: (
            volumetric.render_volumetric_movie(
                scene, d, times, cfg,
                volumetric.RIAFConfig(spot_amp=8.0, alpha0=0.3),
                device=device)),
        "decomposed x3": lambda d, device: (
            volumetric.render_volumetric_decomposed(
                scene, d, cfg, volumetric.RIAFConfig(), n_orders=N_ORDERS,
                device=device))}
    drivers = (kk.trace_rays_aux_two_pass, kk.trace_rays_spectral_two_pass)
    plains = (kerr_trace.trace_rays_aux, kerr_trace.trace_rays_spectral)
    launches, outs = {}, {}
    for label, render in paths.items():
        for c in (vk.trace_rays_aux_cuda, *drivers, *plains):
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        out = render(dim, "cuda")                            # warmup
        runs = []
        for _ in range(3):
            out = render(dim, "cuda")
            runs.append(dict(out[-1]["timings"]))
        st = out[-1]
        best = max(st["total_rays"] / t["precompute"] for t in runs)
        n_kernel = vk.trace_rays_aux_cuda.launches
        n_driver = sum(c.launches for c in drivers)
        n_plain = sum(c.launches for c in plains)
        launches[label] = n_kernel
        launches[label + " driver"] = drivers[0].launches
        outs[label] = out
        row = dict(kernel_launches=n_kernel, driver_calls=n_driver,
                   plain_loop_calls=n_plain, best_rays_per_s=best,
                   peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                   captured=st["captured"],
                   integrator_steps=st["integrator_steps"], timings=runs)
        require(n_kernel == 8 and n_driver == 4 and n_plain == 0,
                f"{label}: {n_kernel} kernel launches, {n_driver} driver "
                f"calls, {n_plain} plain calls")
        require(st["total_rays"] == dim[0] * dim[1]
                and st["integrator_steps"] > 0, f"{label}: bad stats")
        if label == "polarized":
            _evpa, frac, inten, _st = out
            bright = inten > 1e-3 * inten.max()
            row.update(pol_frac_max=float(frac[bright].max()),
                       pol_frac_mean=float(frac[bright].mean()),
                       q_over_i=float(np.abs(st["Q"]).max() / inten.max()))
            require(np.isfinite(inten).all() and inten.max() > 0
                    and row["pol_frac_max"] <= P0 + 1e-4
                    and row["q_over_i"] > 0.05,
                    f"polarized: {row}")
        elif label.startswith("movie"):
            frames = out[0]
            lc = st["light_curve"]
            row.update(light_curve=lc.tolist(), t_max=st["t_max"],
                       modulation=float((lc.max() - lc.min())
                                        / (lc.max() + lc.min())))
            require(tuple(frames.shape) == (N_FRAMES, *dim)
                    and bool(torch.isfinite(frames).all())
                    and float(frames.min()) >= 0.0
                    and float(frames.max()) <= 1.0
                    and row["modulation"] > 0.01, f"{label}: {row}")
        else:
            layers = out[0]
            flux = st["flux_per_order"]
            total = layers.sum(dim=0).cpu().numpy()
            thin = state["thin_emission"]
            # The two traces carry other states (6 and 9 components), so
            # their error norms and steps differ. The pixels above the
            # bar are placed: on the near-axis lanes that either trace's
            # saturation or frozen-state exit ended (they leave at
            # another point of their path), within two pixels of a
            # captured ray, or by the ray's plane crossings.
            err = np.abs(total - thin) / thin.max()
            over = err > 1e-3
            exited = (state["thin_exited"] | order_one["exited"]).reshape(dim)
            shadow = (order_one["status"] != 1).reshape(dim)
            rim = np.zeros(dim, dtype=bool)
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    rim |= np.roll(shadow, (dy, dx), axis=(0, 1))
            crossings = np.rint(order_one["winding"]).reshape(dim)
            rest = over & ~exited & ~rim
            where = {"exit lanes": over & exited,
                     "shadow rim": over & ~exited & rim,
                     "three or more crossings": rest & (crossings >= 3),
                     "two crossings": rest & (crossings == 2),
                     "fewer crossings": rest & (crossings < 2)}
            placed = {}
            for name, mask in where.items():
                rows, cols = np.nonzero(mask)
                placed[name] = dict(
                    pixels=int(mask.sum()),
                    rows=[int(rows.min()), int(rows.max())] if rows.size
                    else [],
                    cols=[int(cols.min()), int(cols.max())] if cols.size
                    else [],
                    max=float(err[mask].max()) if rows.size else 0.0)
            row.update(flux_per_order=flux, gamma=st["gamma_estimates"],
                       partition_p999=float(np.percentile(err, 99.9)),
                       partition_p9999=float(np.percentile(err, 99.99)),
                       partition_over_1e3=int(over.sum()),
                       partition_over_1e3_placed=placed,
                       exit_lanes=int(exited.sum()),
                       rim_pixels=int(rim.sum()),
                       pixels_by_crossings=[int((crossings == k).sum())
                                            for k in range(4)],
                       partition_max=float(err.max()),
                       flux_total_rel=float(abs(total.sum() / thin.sum()
                                                - 1.0)))
            require(bool(torch.isfinite(layers).all())
                    and flux[0] > flux[1] > flux[2] > 0
                    and row["partition_p999"] < 1e-3
                    and row["partition_over_1e3"] < 1e-3 * over.size
                    and row["flux_total_rel"] < 1e-4, f"{label}: {row}")
        print(f"{label} {dim[0]}^2: {json.dumps(row)}; best {best:,.0f} "
              f"rays/s on {card}", flush=True)
    require(all(a < b for a, b in zip(
        outs["movie 8-frame absorbed"][1]["light_curve"],
        outs["movie 8-frame"][1]["light_curve"])),
        "absorption does not dim every movie frame")
    _f, st0 = volumetric.render_volumetric_movie(
        scene, dim, times, cfg, volumetric.RIAFConfig(spot_amp=0.0),
        device="cuda")
    lc0 = st0["light_curve"]
    flat = float((lc0.max() - lc0.min()) / lc0.max())
    print(f"movie with spot_amp 0: light curve spread {flat:.3e}",
          flush=True)
    require(flat == 0.0, f"a stationary flow's light curve varies: {flat}")
    scene90 = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                          vertical_fov_deg=16.0)
    _e, _p, i90, s90 = polarization.render_polarized_volumetric(
        scene90, VOL_PLAIN_DIM, cfg, device="cuda")
    h = VOL_PLAIN_DIM[0]
    top, bottom = slice(1, h // 2), slice(h - 1, h // 2, -1)
    sym = {k: float(np.abs(s90[k][top] - sign * s90[k][bottom]).max()
                    / i90.max())
           for k, sign in (("I", 1.0), ("Q", 1.0), ("U", -1.0))}
    print(f"polarized {h}^2 at theta_obs 90 deg, mirror residuals / peak: "
          f"{json.dumps(sym)}", flush=True)
    require(max(sym.values()) < 0.02, f"no mirror symmetry: {sym}")

    d64 = VOL_CHECK_DIM
    checks = {}
    paths["decomposed x3 absorbed"] = lambda d, device: (
        volumetric.render_volumetric_decomposed(
            scene, d, cfg, volumetric.RIAFConfig(alpha0=0.3),
            n_orders=N_ORDERS, device=device))
    for label, render in paths.items():
        og, oc = render(d64, "cuda"), render(d64, "cpu")
        if label == "polarized":
            peak = oc[2].max()
            checks[label] = {k: float(np.median(np.abs(og[3][k] - oc[3][k]))
                                      / peak) for k in "IQU"}
            ok = max(checks[label].values()) < 1e-5
        elif label.startswith("movie"):
            checks[label] = dict(median=float(
                (og[0].cpu() - oc[0]).abs().median()))
            ok = checks[label]["median"] < 1e-4
        else:
            # Every order on its own, by phase 14's gates.
            checks[label] = order_numbers(
                og[0].cpu().numpy().astype(np.float64).reshape(N_ORDERS, -1),
                oc[0].numpy().astype(np.float64).reshape(N_ORDERS, -1))
            ok = order_gate(checks[label])
        require(ok, f"64^2 {label} card vs CPU: {checks[label]}")
    print(f"new modes check, 64^2 card vs CPU: {json.dumps(checks)}",
          flush=True)

    jax_file = VOL_JAX
    entries = []
    for label, name, source, path in (
            ("stokes toroidal", "kerr_dp45_stokes", STOKES_SOURCE,
             "polarized"),
            ("movie thin", "kerr_dp45_movie_thin",
             MOVIE_SOURCE.format("thin"), "movie 8-frame"),
            ("movie absorbed", "kerr_dp45_movie_absorbed",
             MOVIE_SOURCE.format("absorbed"), "movie 8-frame absorbed"),
            ("order thin", "kerr_dp45_orders", ORDER_SOURCE,
             "decomposed x3")):
        g, form = g14[label], forms[label]
        entries.append(kernel_entry(
            name, source, f"{jax_file}:276", launches[path], g["max_abs"],
            g["ms"], g["plain_ms"], VOL_RAYS,
            8 + 4 * len(form[2]) + 4 * (form[1] + 4),
            g["attempts_sum"] * extras_work(**form[4]), g,
            extras_label(form[4])))
        row = scene14[label]
        entries[-1].update(scene_single_ms=row["single_ms"],
                           scene_attempts_max=row["attempts_max"],
                           scene_exited=row["exited"])
    entries.append(kernel_entry(
        "trace_rays_aux_two_pass", VOL_DRIVERS, f"{jax_file}:421",
        launches["polarized driver"], g_drv["max_abs"], g_drv["ms"],
        g_drv["plain_ms"], VOL_RAYS, 8 + 16 + 4 * 7,
        g_drv["attempts_sum"] * extras_work(**stokes[4]),
        instance=extras_label(stokes[4])))
    return entries


def probe_phase(dev, card):
    """Phase 16; returns (the probe's kernels-line entry, the measured
    rates)."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda import peak_probe
    print("peak probe, kernel vs the same recurrence in torch (k = 64, "
          "4,097 elements):", flush=True)
    worst = {}
    for form, (_index, dtype, _ops) in peak_probe.FORMS.items():
        x = torch.linspace(0.1, 0.9, 4097, dtype=dtype, device=dev)
        got = peak_probe.chain_cuda(x, 64, form)
        want = peak_probe.chain_plain(x, 64, form)
        ulp = torch.finfo(dtype).eps
        bar = (4 * ulp if form == "sin"
               else 4 * 64 * ulp * float(want.abs().max()))
        worst[form] = float((got - want).abs().max())
        require(worst[form] <= bar, f"probe {form}: |d| {worst[form]} > "
                f"{bar}")
    print(f"  max |d|: {json.dumps(worst)}", flush=True)
    peak_probe.chain_cuda.launches = 0
    rates = peak_probe.measure_rates(dev)
    n_launch = peak_probe.chain_cuda.launches
    tera = {f: r["rate"] / 1e12 for f, r in rates.items()}
    library = ", ".join(f"{f[:-2]} {tera[f] * 1e3:.1f}" for f in rates
                        if f[:-4] in peak_probe.LIBRARY_FORMS)
    print(f"peak rates on {card} (marginal between two chain lengths, "
          f"{peak_probe.N_ELEMENTS} elements): FP32 FMA "
          f"{tera['fma32']:.2f} TFLOP/s (one chain a thread), "
          f"{tera['fma32x8']:.2f} TFLOP/s (eight), FP64 FMA "
          f"{tera['fma64']:.2f} TFLOP/s, mixed {tera['mix']:.2f} TFLOP/s, "
          f"sinf {tera['sin'] * 1e3:.1f} Gsin/s; library calls (eight "
          f"chains a thread, G calls/s): {library}; {json.dumps(rates)}",
          flush=True)
    require(n_launch == 12 * len(rates), f"probe launches {n_launch}")
    require(rates["fma32x8"]["rate"] > rates["fma64"]["rate"] > 1e12
            and all(tera[f] > 1e-3 for f in rates),
            f"implausible rates: {tera}")
    # The plain version at the timed shape, with a short chain.
    x = torch.full((peak_probe.N_ELEMENTS,), 0.5, device=dev)
    k_plain = 64
    plain_ms, _ = cuda_ms(lambda: peak_probe.chain_plain(x, k_plain,
                                                         "fma32x8"), 1)
    kernel_ms, _ = cuda_ms(lambda: peak_probe.chain_cuda(x, k_plain,
                                                         "fma32x8"), 5)
    entry = kernel_entry(
        "peak_probe", PROBE_SOURCE, "scripts/roofline.py:80", n_launch,
        worst["fma32x8"], kernel_ms, plain_ms, peak_probe.N_ELEMENTS, 8,
        bounds.Work(16 * k_plain * peak_probe.N_ELEMENTS,
                    {"flop": 8 * k_plain * peak_probe.N_ELEMENTS}))
    return entry, rates


F64_RAYS = 1024
F64_SOURCE = "light_path_tracer_tpu_torch/csrc/{}_f64.cu"


def f64_extras_gate(what, g, tau_scale=1.0):
    """Phase 17's gates on float64 kernel-vs-plain extras numbers g:
    status agreement > 0.999, every extra's p99 |d| / max < 1e-6 (tau
    against max(1, max |tau|))."""
    p99 = g.get("p99_em_bands", g.get("p99"))
    tau = g.get("p99_tau", 0.0) / max(tau_scale, 1.0)
    require(g["status_agree"] > 0.999 and max(p99) < 1e-6 and tau < 1e-6,
            f"phase 17 {what} gate: {g}")


def f64_counters():
    """Every kernel wrapper and plain loop whose counts phase 17 reads."""
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace as st
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    kernels = dict(kerr=kk.trace_rays_kerr_cuda, disk=kk.trace_disk_rays_cuda,
                   orbit=schwarzschild_kernel.trace_rays_schwarzschild_cuda,
                   volumetric=vk.trace_rays_volumetric_cuda,
                   aux=vk.trace_rays_aux_cuda)
    plains = (tk.trace_rays_kerr, tk.trace_disk_rays_kerr, tk.trace_rays_aux,
              tk.trace_rays_volumetric, tk.trace_rays_spectral,
              st.trace_rays_schwarzschild)
    return kernels, plains


def float64_phase(dev, card, ctx):
    """Phase 17: every float64 kernel instance against the plain float64
    loop, the float64 renders of every entry-point family on the card
    against the CPU (the float64 path: its launches are the f64 entries'
    counts), and the float32 kernel against the float64 one on the main
    path's rays. Returns the kernels-line entries of the float64
    instances."""
    import torch
    from light_path_tracer_tpu_torch import (camera, disk, pipeline,
                                             polarization, volumetric)
    from light_path_tracer_tpu_torch.models import (Kerr, ReissnerNordstrom,
                                                    Schwarzschild)
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    kerr = Kerr(M=1.0, a=0.9)
    n = F64_RAYS
    rows = {}
    print(f"float64 kernel instances vs the plain float64 loop (gates: "
          f"status > 0.999; p99 |d final_alpha| < 1e-6 rad, orbit 1e-8; "
          f"extras p99 |d| / max < 1e-6; disk median |d r_hits[0]| < 1e-6 "
          f"M; orders by flux):", flush=True)
    al, th, rf = (x[:n] for x in ctx["kerr_rays"])
    g = both_versions(f"Kerr, {n} random rays", kerr, al.double(),
                      th.double(), rf, GATE_STEPS, 5)
    require(g["status_agree"] > 0.999 and g["p99"] < 1e-6,
            f"phase 17 Kerr gate: {g}")
    rows["kerr"] = g
    al_d, th_d = (x[:n].double() for x in ctx["disk_rays"])
    g = disk_both(f"disk, {n} random rays, opaque", kerr, al_d, th_d,
                  GATE_STEPS, ctx["opaque"], 2, 5)
    require(g["status_agree"] > 0.999 and g["nhits_agree"] > 0.999
            and g["median_dr"] < 1e-6, f"phase 17 disk gate: {g}")
    rows["disk"] = g
    for metric in (Schwarzschild(M=1.0), ReissnerNordstrom(M=1.0, Q=0.6)):
        ac_o = metric.alpha_crit(R_OBS)
        rng = np.random.default_rng(1)
        al_o = torch.tensor(np.concatenate(
            [[0.0], rng.uniform(0.2 * ac_o, 4 * ac_o, n)]),
            dtype=torch.float64, device=dev)
        label = type(metric).__name__
        g, rk = orbit_both(f"{label} {n + 1} rays", metric, al_o, 20)
        require(g["status_agree"] > 0.999 and g["p99"] < 1e-8
                and int(rk.status[0]) == 0, f"phase 17 {label} gate: {g}")
        rows.setdefault("orbit", g)

    # The extras forms on phase 11's and phase 14's rays, against the
    # plain float64 runs those phases made.
    st = ctx["state"]
    al_v, th_v = st["al"].double(), st["th"].double()
    for label, (riaf, freqs) in volumetric_forms().items():
        rp64, plain_ms = st["plain64_11"][label]
        probe = {}
        ms, rk = cuda_ms(lambda: extras_trace(
            kerr, riaf, freqs, al_v, th_v, VOL_STEPS, True, sat_window=2048,
            probe=probe), 3)
        g = extras_compare(rk, rp64)
        g.update(ms=ms, plain_ms=plain_ms,
                 attempts_sum=int(probe["attempts"].to(torch.int64).sum()),
                 slowest_attempts=int(probe["attempts"].max()))
        tau = max((float(t.abs().max()) for t in rp64[2]), default=1.0)
        print(f"  {label}, {VOL_RAYS} rays: {json.dumps(g)}", flush=True)
        f64_extras_gate(label, g, tau)
        rows[label] = g
    forms = ctx["state"]["forms14"]
    for label, form in forms.items():
        form = (form[0], form[1], tuple(a.double() for a in form[2]),
                *form[3:])
        width = len(form[3])
        kw = dict(sat_window=AUX_WINDOW)
        plain64 = st["g14"][label]["plain64"]
        if plain64 is None:
            plain64 = cuda_ms(lambda: aux_trace(kerr, form, al_v, th_v,
                                                AUX_STEPS, False, **kw), 1)
        plain_ms, rp64 = plain64
        probe = {}
        ms, rk = cuda_ms(lambda: aux_trace(kerr, form, al_v, th_v, AUX_STEPS,
                                           True, probe=probe, **kw), 3)
        g = aux_compare(rk, rp64, label, width)
        g.update(ms=ms, plain_ms=plain_ms,
                 attempts_sum=int(probe["attempts"].to(torch.int64).sum()),
                 slowest_attempts=int(probe["attempts"].max()))
        print(f"  {label}, {VOL_RAYS} rays: {json.dumps(g)}", flush=True)
        if label.startswith("order"):
            require(g["status_agree"] > 0.999 and order_gate(g)
                    and g["p95_m"] < 5e-3, f"phase 17 {label} gate: {g}")
        else:
            f64_extras_gate(label, g)
        rows[label] = g

    # The entry points in float64 at 64^2, on the card and on the CPU:
    # the card's renders launch only float64 instances and no plain loop.
    kernels, plains = f64_counters()
    cfg = RenderConfig(dtype="float64")
    d64 = (64, 64)
    scene_k = SceneConfig(M=1.0, a=0.9, vertical_fov_deg=12.0)
    scene_s = SceneConfig(M=1.0, r_obs_mult=R_OBS, vertical_fov_deg=12.0)
    scene_d = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                          theta_obs=THETA_DISK)
    scene_v = st["scene"]
    src = np.random.default_rng(4).random((64, 64, 3)).astype(np.float32)
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                           True))
    times = tuple(period * k / 3 for k in range(3))
    riaf3, freqs3 = scene_forms()["spectral 3-band"]
    blob = volumetric.RIAFConfig(spot_amp=8.0)
    families = {
        "shadow": ("kerr", lambda device: pipeline.render_shadow(
            scene_k, d64, cfg, device=device)),
        "lensed": ("orbit", lambda device: pipeline.render_scene(
            scene_s, src, RenderConfig(dtype="float64",
                                       sampling="bilinear"),
            device=device)),
        "disk": ("disk", lambda device: disk.render_disk(
            scene_d, d64, cfg, device=device)),
        "volumetric": ("volumetric", lambda device: (
            volumetric.render_volumetric(scene_v, d64, cfg, device=device))),
        "spectrum": ("aux", lambda device: (
            volumetric.render_volumetric_spectrum(
                scene_v, d64, freqs3, cfg, riaf3, device=device))),
        "movie": ("aux", lambda device: volumetric.render_volumetric_movie(
            scene_v, d64, times, cfg, blob, device=device)),
        "movie absorbed": ("aux", lambda device: (
            volumetric.render_volumetric_movie(
                scene_v, d64, times, cfg,
                volumetric.RIAFConfig(spot_amp=8.0, alpha0=0.3),
                device=device))),
        "decomposed": ("aux", lambda device: (
            volumetric.render_volumetric_decomposed(
                scene_v, d64, cfg, n_orders=N_ORDERS, device=device))),
        "polarized": ("aux", lambda device: (
            polarization.render_polarized_volumetric(
                scene_v, d64, cfg, device=device)))}
    f64_launches, checks = {}, {}
    for label, (kernel, render) in families.items():
        for c in (*kernels.values(), *plains):
            c.launches = 0
            if hasattr(c, "launches_f64"):
                c.launches_f64 = 0
        og = render("cuda")
        torch.cuda.synchronize()
        n64 = kernels[kernel].launches_f64
        n32 = sum(c.launches for c in kernels.values())
        n_plain = sum(c.launches for c in plains)
        f64_launches[label] = n64
        require(n64 > 0 and n32 == 0 and n_plain == 0,
                f"phase 17 {label} float64 render: {n64} float64 launches, "
                f"{n32} float32, {n_plain} plain")
        oc = render("cpu")
        if label == "shadow":
            c = dict(pixels_equal=float((og[0].cpu() == oc[0]).float()
                                        .mean()))
            ok = c["pixels_equal"] >= 0.999
        elif label == "lensed":
            calm = ((og.precompute.winding.cpu().to(torch.int32) < 2)
                    & (oc.precompute.winding.to(torch.int32) < 2))
            masks = (torch.isnan(og.precompute.final_alpha).cpu()
                     == torch.isnan(oc.precompute.final_alpha))
            c = dict(mask_agree=float(masks.float().mean()),
                     rmse=float(((og.image.cpu() - oc.image)[calm] ** 2)
                                .mean().sqrt()))
            ok = c["mask_agree"] >= 0.999 and c["rmse"] < 1e-6
        elif label == "disk":
            mg, mc = og[0].cpu() > 0, oc[0] > 0
            both = mg & mc
            c = dict(mask_agree=float((mg == mc).float().mean()),
                     median=float((og[0].cpu() - oc[0]).abs()[both]
                                  .median()))
            ok = c["mask_agree"] >= 0.999 and c["median"] < 1e-6
        elif label == "decomposed":
            c = order_numbers(
                og[0].cpu().numpy().astype(np.float64).reshape(N_ORDERS, -1),
                oc[0].numpy().astype(np.float64).reshape(N_ORDERS, -1))
            ok = order_gate(c)
        elif label == "polarized":
            peak = oc[2].max()
            c = {k: float(np.median(np.abs(og[3][k] - oc[3][k])) / peak)
                 for k in "IQU"}
            ok = max(c.values()) < 1e-8
        else:
            c = dict(median=float((og[0].cpu() - oc[0]).abs().median()),
                     max=float((og[0].cpu() - oc[0]).abs().max()))
            ok = c["median"] < 1e-6
        c["float64_launches"] = n64
        checks[label] = c
        require(ok, f"phase 17 64^2 float64 {label} card vs CPU: {c}")
    print(f"float64 renders, 64^2 card vs CPU: {json.dumps(checks)}",
          flush=True)

    # The float32 kernel against the float64 one on the main path's rays:
    # the north star's final-alpha bar (1e-3 rad RMSE).
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    dim = ctx["main_dim"]
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    res = {}
    for dtype in ("float32", "float64"):
        al_m, th_m, rf_m, _rows = pipeline.trace_inputs(
            scene, RenderConfig(dtype=dtype), dim, fov, dev)
        ms, r = cuda_ms(lambda: kk.trace_rays_kerr_cuda(
            kerr, R_OBS, al_m, th_m, np.pi / 2, rf_m, LAMBDA_MAX, 200000), 3)
        probe = {}
        kk.trace_rays_kerr_cuda(kerr, R_OBS, al_m, th_m, np.pi / 2, rf_m,
                                LAMBDA_MAX, 200000, probe=probe)
        res[dtype] = (r, ms, probe["attempts"])
    (r32, ms32, a32), (r64, ms64, a64) = res["float32"], res["float64"]
    s32, s64 = r32.status.cpu().numpy(), r64.status.cpu().numpy()
    esc = (s32 == 1) & (s64 == 1)
    d = (r32.final_alpha.double() - r64.final_alpha).cpu().numpy()[esc]
    main = dict(rays=int(s32.size), status_agree=float((s32 == s64).mean()),
                escaped_both=int(esc.sum()),
                final_alpha_rmse=float(np.sqrt(np.mean(d * d))),
                final_alpha_max=float(np.abs(d).max()),
                ms_float32=ms32, ms_float64=ms64, ratio=ms64 / ms32,
                attempts_sum_float32=int(a32.to(torch.int64).sum()),
                attempts_sum_float64=int(a64.to(torch.int64).sum()),
                slowest_float64=int(a64.max()))
    main["meets_1e-3_rad"] = main["final_alpha_rmse"] < 1e-3
    print(f"float32 vs float64 kernel, {dim[0]}^2 main-path rays: "
          f"{json.dumps(main)} on {card}", flush=True)
    require(main["status_agree"] > 0.99
            and np.isfinite(main["final_alpha_rmse"]),
            f"float32 vs float64 on the main path: {main}")

    # The float64 instances' kernels-line entries: the launches of the
    # float64 renders, the times of the comparisons above, the bounds in
    # float64.
    shadow_work = kerr_work("float64")
    k, dk, ok_ = rows["kerr"], rows["disk"], rows["orbit"]
    jv = f"{VOL_JAX}"
    entries = [
        kernel_entry("kerr_dp45_f64", F64_SOURCE.format("kerr_dp45"),
                     REPLACES, f64_launches["shadow"], k["max_abs"], k["ms"],
                     k["plain_ms"], k["n"], 17 + 16,
                     k["attempts_sum"] * shadow_work, k),
        kernel_entry("kerr_dp45_disk_f64", F64_SOURCE.format("kerr_dp45"),
                     f"{JAX_KERNELS}:316", f64_launches["disk"],
                     dk["max_dr"], dk["ms"], dk["plain_ms"], dk["n"],
                     16 + 28 + 32, dk["attempts_sum"] * shadow_work, dk),
        kernel_entry("schwarzschild_rk4_f64",
                     F64_SOURCE.format("schwarzschild_rk4"), ORBIT_REPLACES,
                     f64_launches["lensed"], ok_["max_abs"], ok_["ms"],
                     ok_["plain_ms"], ok_["n"], 8 + 20,
                     ok_["attempts_sum"] * orbit_work(dtype="float64"),
                     ok_)]
    n_bands = len(freqs3)
    for label, name, fam, desc, nbytes in (
            ("thin", "kerr_dp45_extras_f64", "volumetric",
             dict(kind="thin"), 16 + 8 + 13),
            ("spectral 3-band", "kerr_dp45_extras_spectral_f64", "spectrum",
             dict(kind="spectral", width=n_bands),
             16 + 8 * (1 + n_bands) + 13)):
        g = rows[label]
        inst = ("kerr_dp45_extras<VolThin<double>>" if label == "thin" else
                f"kerr_dp45_extras<Spectral<{n_bands},double>>")
        entries.append(kernel_entry(
            name, F64_SOURCE.format("kerr_dp45_extras"), f"{jv}:53"
            if label == "thin" else f"{jv}:276", f64_launches[fam],
            g["max_abs_em"], g["ms"], g["plain_ms"], VOL_RAYS, nbytes,
            g["attempts_sum"] * extras_work(**desc, dtype="float64"), g,
            inst))
    for label, name, fam in (
            ("stokes toroidal", "kerr_dp45_stokes", "polarized"),
            ("movie thin", "kerr_dp45_movie_thin", "movie"),
            ("movie absorbed", "kerr_dp45_movie_absorbed", "movie absorbed"),
            ("order thin", "kerr_dp45_orders", "decomposed")):
        g, form = rows[label], forms[label]
        entries.append(kernel_entry(
            f"{name}_f64", F64_SOURCE.format(name), f"{jv}:276",
            f64_launches[fam], g["max_abs"], g["ms"], g["plain_ms"],
            VOL_RAYS, 16 + 8 * len(form[2]) + 8 * form[1] + 13,
            g["attempts_sum"] * extras_work(**form[4], dtype="float64"), g,
            extras_label(form[4], "double")))
    return entries


def cycle_phase(card):
    """Phase 18: the exact-cycle exit bitwise against the run with the
    exit off, and the lanes counted by kind, on the config-4 grids, the
    1024^2 Kerr shadow, the volumetric scene's 1024^2 and 256^2 grids for
    every form of phases 12 and 14, and the 256^2 order lane (171, 129)
    (scripts/torch_cycle_census.py). Returns the census rows."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    from torch_cycle_census import census
    print(f"exact-cycle exit vs exit off, bitwise, on {card}:", flush=True)
    rows = census(torch.device("cuda", 0))
    bad = [k for k, r in rows.items() if not r.get("bitwise_equal", True)]
    require(not bad, f"the cycle exit changed the outputs of {bad}")
    return rows


# The rays that nvcc's contraction of a*b + c into FMA ended otherwise
# than the reference (ROADMAP Queue 3 #1, #4), now built without it: row
# 959 of config 4's aligned grid, pinned to JAX's (status, n_hits,
# attempts) by tests/test_torch_config4_ray.py; the quarter-offset grid's
# lanes that froze on the card with contraction and the 256^2 order
# decomposition's lane (171, 129) (Order<3>, thin), each held to the plain
# loop on the CPU, which tests/test_torch_config4_ray.py and
# tests/test_torch_orders.py pin to JAX.
ALIGNED_PINS = {(959, 511): (1, 0, 51), (959, 510): (1, 0, 51),
                (959, 512): (1, 0, 17)}
# The quarter-offset lanes, capped at QUARTER_CAP attempts in both (three
# run to the cap in the plain loop and in JAX). OPEN_LANES end otherwise
# on the card than in the plain loop (ROADMAP Queue 3 #1): printed, not
# gated; so is the order lane's attempt count (captured in 148 on the
# card, 144 in the plain loop, 150 in JAX: Queue 3 #4, #6).
QUARTER_LANES = ((181, 512), (233, 512), (447, 512), (450, 512),
                 (798, 512), (950, 511), (978, 511))
OPEN_LANES = ((233, 512), (447, 512))
QUARTER_CAP = 1000
ORDER_LANE = (171, 129)


def reference_phase(dev, card):
    """Phase 19: the rays of ALIGNED_PINS, QUARTER_LANES and ORDER_LANE on
    the card against their pins; the in-kernel extraction against
    finalize_angles on the main path's final states; the Kerr kernel's
    warp step sum and unconverged flags against torch's from the probe,
    on the main path's 524,288 rays (float32 and float64) and on the
    aligned and quarter-offset config-4 grids, with the wrapper's time."""
    import torch
    from light_path_tracer_tpu_torch import camera, disk, volumetric
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.pipeline import trace_inputs
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    kerr = Kerr(M=1.0, a=0.9)
    dim = (1024, 1024)
    f32 = dict(dtype=torch.float32, device=dev)
    plane = (disk.r_isco(1.0, 0.9), disk.DiskConfig().r_out,
             float(np.pi / 2), True)
    fov4 = camera.fov_from_vertical(np.radians(40.0), dim)
    grids = {}
    for label, off in (("aligned", (0.0, 0.0)), ("quarter-offset",
                                                 (0.25, 0.25))):
        grids[label] = (
            camera.build_alpha_lookup(dim, fov4, pixel_offset=off,
                                      **f32).reshape(-1),
            camera.build_theta_lookup(dim, fov4, pixel_offset=off,
                                      **f32).reshape(-1))
    print(f"the reference's rays on the card, and the Kerr kernel's "
          f"booking, on {card}:", flush=True)

    def disk_ray(label, r, c, max_steps, plain):
        al, th = grids[label]
        i = r * dim[1] + c
        pr = {}
        rk = kk.trace_disk_rays_cuda(kerr, R_OBS, al[i:i + 1], th[i:i + 1],
                                     THETA_DISK, LAMBDA_MAX, max_steps,
                                     plane, 2, probe=pr)
        row = dict(grid=label, ray=(r, c), max_steps=max_steps,
                   status=int(rk.status[0]), n_hits=int(rk.n_hits[0]),
                   attempts=int(pr["attempts"][0]))
        if plain:
            rp = kerr_trace.trace_disk_rays_kerr(
                kerr, R_OBS, al[i:i + 1].cpu(), th[i:i + 1].cpu(),
                THETA_DISK, LAMBDA_MAX, max_steps, plane, 2)
            row["plain"] = (int(rp.status[0]), int(rp.n_hits[0]),
                            int(rp.n_steps))
            row["open"] = (r, c) in OPEN_LANES
        print(f"  {json.dumps(row)}", flush=True)
        return row

    for (r, c), pin in ALIGNED_PINS.items():
        row = disk_ray("aligned", r, c, 200000, False)
        require((row["status"], row["n_hits"], row["attempts"]) == pin,
                f"phase 19: config-4 ray ({r}, {c}) ends as {row}, not as "
                f"JAX's (status, n_hits, attempts) {pin}")
    for r, c in QUARTER_LANES:
        row = disk_ray("quarter-offset", r, c, QUARTER_CAP, True)
        require(row["open"] or (row["status"], row["n_hits"],
                                row["attempts"]) == tuple(row["plain"]),
                f"phase 19: quarter-offset lane ({r}, {c}) ends as {row}, "
                f"not as the plain loop")
    d = (256, 256)
    fov = camera.fov_from_vertical(np.radians(16.0), d)
    lane = ORDER_LANE[0] * d[1] + ORDER_LANE[1]
    al = camera.build_alpha_lookup(d, fov, **f32).reshape(-1)[lane:lane + 1]
    th = camera.build_theta_lookup(d, fov, **f32).reshape(-1)[lane:lane + 1]
    order = volumetric.make_order_transfer(kerr, volumetric.RIAFConfig(), 3)
    form = (order, 4, (), (1, 2, 3), 0)
    probe = {}
    rk = aux_trace(kerr, form, al, th, 200000, True, sat_window=2048,
                   probe=probe)
    rp = aux_trace(kerr, form, al.cpu(), th.cpu(), 6000, False,
                   sat_window=2048)
    row = dict(ray=ORDER_LANE, status=int(rk.status[0]),
               attempts=int(probe["attempts"][0]),
               flags=int(probe["flags"][0]),
               plain=(int(rp.status[0]), int(rp.n_steps)))
    print(f"  256^2 order decomposition lane: {json.dumps(row)}", flush=True)
    require(row["status"] == row["plain"][0] == -1,
            f"phase 19: the order lane {ORDER_LANE} ends as {row}, not "
            f"captured as in the plain loop")

    # The in-kernel extraction against finalize_angles on the kernel's own
    # final states (the probe's raw state, status and p_phi).
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    cfg = RenderConfig()
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = trace_inputs(scene, cfg, dim, fov, dev)
    for dtype in (torch.float32, torch.float64):
        a, t = al.to(dtype), th.to(dtype)
        probe = {}
        res = kk.trace_rays_kerr_cuda(kerr, R_OBS, a, t, np.pi / 2, rf,
                                      LAMBDA_MAX, cfg.max_steps,
                                      probe=probe)
        fa, nh, st = kerr_trace.finalize_angles(
            kerr, probe["state"], torch.full_like(a, -1.0), probe["p_phi"],
            probe["raw_status"])
        both = torch.isfinite(fa) & torch.isfinite(res.final_alpha)
        d_alpha = float((fa - res.final_alpha)[both].abs().max())
        row = dict(dtype=str(dtype), status_equal=bool(torch.equal(
                       st, res.status)),
                   n_half_equal=bool(torch.equal(
                       nh, res.n_half_orbits)),
                   nan_equal=bool(torch.equal(torch.isnan(fa), torch.isnan(
                       res.final_alpha))),
                   bitwise=same_bits(fa, res.final_alpha),
                   max_abs_d_alpha=d_alpha)
        print(f"  in-kernel extraction vs finalize_angles, main-path rays: "
              f"{json.dumps(row)}", flush=True)
        bar = 1e-6 if dtype == torch.float32 else 1e-13
        require(row["status_equal"] and row["n_half_equal"]
                and row["nan_equal"] and d_alpha <= bar,
                f"phase 19: the in-kernel extraction differs from "
                f"finalize_angles: {row}")

    # The kernel's warp step sum and flags against torch's from the probe.
    cases = [(f"main-path rays {tag}", lambda pr, dt=dt: (
        kk.trace_rays_kerr_cuda(kerr, R_OBS, al.to(dt), th.to(dt), np.pi / 2,
                                rf, LAMBDA_MAX, cfg.max_steps, probe=pr,
                                return_unconverged=True)))
             for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64"))]
    for label, (ga, gt) in grids.items():
        cases.append((f"config-4 {label} grid f32",
                      lambda pr, ga=ga, gt=gt: kk.trace_disk_rays_cuda(
                          kerr, R_OBS, ga, gt, THETA_DISK, LAMBDA_MAX,
                          200000, plane, 2, return_unconverged=True,
                          probe=pr)))
    rows = {}
    for label, run in cases:
        pr = {}
        res, unc = run(pr)
        ms, _ = cuda_ms(lambda: run(None), 3)
        row = dict(wrapper_ms=ms, warp_step_sum=int(res.n_steps),
                   warp_step_sum_torch=int(kerr_trace.warp_step_sum(
                       pr["attempts"])),
                   flags_equal=bool(torch.equal(
                       unc, pr["raw_status"] == kerr_trace.RUNNING)))
        rows[label] = row
        print(f"  Kerr kernel's booking, {label}: {json.dumps(row)}",
              flush=True)
        require(row["flags_equal"] and row["warp_step_sum"]
                == row["warp_step_sum_torch"],
                f"phase 19: the Kerr kernel's warp step sum or flags differ "
                f"from torch's on {label}: {row}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from light_path_tracer_tpu_torch.models import (Kerr, ReissnerNordstrom,
                                                    Schwarzschild)
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops import schwarzschild_trace
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel
    from light_path_tracer_tpu_torch.ops.cuda import schwarzschild_kernel
    from light_path_tracer_tpu_torch.pipeline import (render_scene,
                                                      render_shadow,
                                                      trace_inputs)
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. machine ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    nvcc_ver = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
    print(f"machine: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda}); nvcc: "
          f"{nvcc_ver}", flush=True)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s -> {_build.library_path().name}",
          flush=True)
    extras_resources(ptxas_report(lib.build_log))
    for name, regs, spill in ptxas_report(lib.build_log):
        r = RESOURCES.get(name)
        more = (f"; {r['blocks_per_sm']} blocks an SM (block bound "
                f"{r['min_blocks']})" if r else "")
        print(f"  ptxas: {name}: {regs} registers; {spill}{more}",
              flush=True)

    # -- 3. kernel vs plain version ---------------------------------------
    metric = Kerr(M=1.0, a=0.9)
    ac = metric.alpha_crit(R_OBS)
    rng = np.random.default_rng(0)
    n = 4096
    f32 = dict(dtype=torch.float32, device=dev)
    alphas = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, n), **f32)
    thetas = torch.tensor(rng.uniform(-np.pi, np.pi, n), **f32)
    refine = torch.tensor(rng.random(n) < 0.2, device=dev)
    print("kernel vs plain version (f32 'fast'):", flush=True)
    g4k = both_versions("4096 random rays", metric, alphas, thetas, refine,
                        GATE_STEPS, 5)
    require(g4k["status_agree"] > 0.99 and g4k["p99"] < 2e-3,
            f"4096-ray gate: {g4k}")

    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    cfg20k = RenderConfig(max_steps=GATE_STEPS)
    dim128 = (128, 128)
    fov128 = camera.fov_from_vertical(scene.vertical_fov, dim128)
    al, th, rf, _rows = trace_inputs(scene, cfg20k, dim128, fov128, dev)
    g128 = both_versions("128^2 image", metric, al, th, rf, GATE_STEPS, 5)
    require(g128["mask_agree"] >= 0.995,
            f"128^2 shadow masks agree on {g128['mask_agree']:.4f} < 0.995")

    cfg = RenderConfig()
    dim = (1024, 1024)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = trace_inputs(scene, cfg, dim, fov, dev)
    gmain = both_versions("1024^2 main-path rays", metric, al, th, rf,
                          cfg.max_steps, 3)
    require(gmain["status_agree"] > 0.99 and gmain["p99"] < 2e-3
            and gmain["mask_agree"] >= 0.995, f"1024^2 gate: {gmain}")
    del al, th, rf

    # -- 4. main path ------------------------------------------------------
    kerr_trace_kernel.trace_rays_kerr_cuda.launches = 0
    kerr_trace.trace_rays_kerr.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    img, stats = render_shadow(scene, dim, cfg, device="cuda")   # warmup
    best = None
    for _ in range(3):
        img, stats = render_shadow(scene, dim, cfg, device="cuda")
        rps = stats["traced_rays"] / stats["timings"]["precompute"]
        best = rps if best is None else max(best, rps)
    launches = kerr_trace_kernel.trace_rays_kerr_cuda.launches
    plain_calls = kerr_trace.trace_rays_kerr.launches
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"main path: kernel launches {launches}, plain-loop calls "
          f"{plain_calls}, traced_rays {stats['traced_rays']}, "
          f"integrator_steps {stats['integrator_steps']}, "
          f"timings {json.dumps(stats['timings'])}, peak device memory "
          f"{peak_mib:.1f} MiB", flush=True)
    require(launches >= 4, f"kernel launch counter is {launches} after "
            f"4 renders")
    require(plain_calls == 0, f"plain loop ran {plain_calls} times on the "
            f"main path")
    require(stats["traced_rays"] == 524288,
            f"traced_rays {stats['traced_rays']} != 524288")
    require(stats["integrator_steps"] > 0, "integrator_steps is 0")
    require(img.shape == dim and img.dtype == torch.float32
            and bool(torch.isfinite(img).all()), "bad image")

    analytic, _ = render_shadow(scene, dim, cfg, analytic=True,
                                device="cuda")
    captured = img == 0.0
    n_cap = int(captured.sum())
    n_disk = int((analytic == 0.0).sum())
    alpha = camera.build_alpha_lookup(dim, fov, device=dev)
    outside = int((captured & (alpha >= 1.01 * ac)).sum())
    ratio = n_cap / max(n_disk, 1)
    print(f"shadow: {n_cap} captured px, alpha_crit disk {n_disk} px, "
          f"ratio {ratio:.4f}, captured outside 1.01 alpha_crit: "
          f"{outside}", flush=True)
    require(0.45 <= ratio <= 0.65, f"captured/analytic ratio {ratio:.4f}")
    require(outside == 0, f"{outside} captured pixels outside the "
            f"1.01 alpha_crit circle")
    print(f"main path 1024^2 Kerr a=0.9 shadow: best {best:,.0f} rays/s "
          f"on {card}", flush=True)
    frame = device_profile(lambda: render_shadow(scene, dim, cfg,
                                                 device="cuda"), 3,
                           "kerr_dp45")
    print(f"main path frame under torch.profiler (3 frames): "
          f"{json.dumps(frame)}", flush=True)

    # -- 5. orbit kernel vs plain version --------------------------------
    orbit_launch = schwarzschild_kernel.trace_rays_schwarzschild_cuda
    orbit_plain = schwarzschild_trace.trace_rays_schwarzschild
    print("orbit kernel vs plain version (f32):", flush=True)
    schw = Schwarzschild(M=1.0)
    for metric in (schw, ReissnerNordstrom(M=1.0, Q=0.6)):
        ac_o = metric.alpha_crit(R_OBS)
        rng = np.random.default_rng(1)
        al_o = torch.tensor(np.concatenate(
            [[0.0], rng.uniform(0.2 * ac_o, 4 * ac_o, 4096)]), **f32)
        g, rk = orbit_both(f"{type(metric).__name__} 4097 rays", metric,
                           al_o, 20)
        require(g["status_agree"] > 0.999 and g["p99"] < 1e-4,
                f"{type(metric).__name__} 4097-ray gate: {g}")
        require(int(rk.status[0]) == 0, "the alpha = 0 lane is not INVALID")
    dim1 = (1024, 1024)
    fov1 = camera.fov_from_vertical(np.radians(40.0), dim1)
    al_grid = camera.build_alpha_lookup(dim1, fov1, device=dev).reshape(-1)
    gorb, _ = orbit_both("Schwarzschild 1024^2 grid", schw, al_grid, 10)
    require(gorb["status_agree"] > 0.999 and gorb["p99"] < 1e-4,
            f"1024^2 orbit gate: {gorb}")
    del al_grid

    # -- 6. config 1: 1024^2 Schwarzschild shadow ---------------------------
    scene1 = SceneConfig(M=1.0, r_obs_mult=R_OBS)
    orbit_launch.launches = 0
    orbit_plain.launches = 0
    img1, st1 = render_shadow(scene1, dim1, cfg, device="cuda")   # warmup
    best1 = None
    for _ in range(3):
        img1, st1 = render_shadow(scene1, dim1, cfg, device="cuda")
        rps = st1["traced_rays"] / st1["timings"]["precompute"]
        best1 = rps if best1 is None else max(best1, rps)
    launches1, plain1 = orbit_launch.launches, orbit_plain.launches
    print(f"config 1: orbit kernel launches {launches1}, plain-loop calls "
          f"{plain1}, traced_rays {st1['traced_rays']}, integrator_steps "
          f"{st1['integrator_steps']}, timings "
          f"{json.dumps(st1['timings'])}", flush=True)
    require(launches1 >= 4 and plain1 == 0,
            f"config 1: {launches1} kernel launches, {plain1} plain calls")
    require(st1["traced_rays"] == 1024 * 1024,
            f"config 1 traced_rays {st1['traced_rays']}")
    require(img1.shape == dim1 and bool(torch.isfinite(img1).all()),
            "config 1: bad image")
    ac1 = schw.alpha_crit(R_OBS)
    alpha1 = camera.build_alpha_lookup(dim1, fov1, device=dev)
    cap1 = img1 == 0.0
    n_cap1, n_disk1 = int(cap1.sum()), int((alpha1 < ac1).sum())
    out1 = int((cap1 & (alpha1 >= 1.01 * ac1)).sum())
    ratio1 = n_cap1 / max(n_disk1, 1)
    print(f"config 1 shadow: {n_cap1} captured px, alpha_crit disk "
          f"{n_disk1} px, ratio {ratio1:.4f}, captured outside 1.01 "
          f"alpha_crit: {out1}; best {best1:,.0f} rays/s on {card}",
          flush=True)
    require(0.98 <= ratio1 <= 1.02, f"config 1 ratio {ratio1:.4f}")
    require(out1 == 0, f"config 1: {out1} captured px outside 1.01 "
            f"alpha_crit")
    del img1, alpha1, cap1

    # -- 7. config 2: 512^2 Schwarzschild lensed render ---------------------
    src = np.random.default_rng(3).random((512, 512, 3)).astype(np.float32)
    orbit_launch.launches = 0
    orbit_plain.launches = 0
    out2 = render_scene(scene1, src, cfg, device="cuda")        # warmup
    runs = []
    for _ in range(3):
        out2 = render_scene(scene1, src, cfg, device="cuda")
        runs.append(dict(out2.timings))
    launches2, plain2 = orbit_launch.launches, orbit_plain.launches
    best2 = min(runs, key=lambda t: t["total"])
    rps2 = max(out2.precompute.traced_rays / t["precompute"] for t in runs)
    img2 = out2.image
    black = (img2 == 0.0).all(dim=2)
    captured2 = torch.isnan(out2.precompute.final_alpha)
    magenta = torch.tensor([1.0, 0.0, 1.0], device=dev)
    n_magenta = int((img2 == magenta).all(dim=2).sum())
    print(f"config 2: orbit kernel launches {launches2}, plain-loop calls "
          f"{plain2}, traced_rays {out2.precompute.traced_rays}, best "
          f"frame {best2['total'] * 1e3:.3f} ms, precompute {rps2:,.0f} "
          f"rays/s, stages of the best frame (s) {json.dumps(best2)}, "
          f"black px {int(black.sum())}, captured rays "
          f"{int(captured2.sum())}, magenta px {n_magenta} on {card}",
          flush=True)
    require(launches2 >= 4 and plain2 == 0,
            f"config 2: {launches2} kernel launches, {plain2} plain calls")
    require(tuple(img2.shape) == (512, 512, 3)
            and img2.dtype == torch.float32
            and bool(torch.isfinite(img2).all()), "config 2: bad image")
    require(out2.precompute.traced_rays == 512 * 512,
            f"config 2 traced_rays {out2.precompute.traced_rays}")
    require(bool((black == captured2).all()),
            "config 2: black pixels are not the captured rays")

    small = np.random.default_rng(4).random((64, 64, 3)).astype(np.float32)
    cfg_bl = RenderConfig(sampling="bilinear")
    scene_s = SceneConfig(M=1.0, r_obs_mult=R_OBS, vertical_fov_deg=12.0)
    og = render_scene(scene_s, small, cfg_bl, device="cuda")
    oc = render_scene(scene_s, small, cfg_bl, device="cpu")
    mg = torch.isnan(og.precompute.final_alpha).cpu()
    mc = torch.isnan(oc.precompute.final_alpha)
    calm = ((og.precompute.winding.cpu().to(torch.int32) < 2)
            & (oc.precompute.winding.to(torch.int32) < 2))
    rmse = float(((og.image.cpu() - oc.image)[calm] ** 2).mean().sqrt())
    mask_agree = float((mg == mc).float().mean())
    print(f"config 2 check, 64^2 card vs CPU: shadow masks agree "
          f"{mask_agree:.4f}, bilinear RMSE (winding < 2) {rmse:.3e}",
          flush=True)
    require(mask_agree >= 0.99 and rmse < 1e-3,
            f"64^2 card vs CPU: masks {mask_agree:.4f}, RMSE {rmse:.3e}")

    # -- 8. disk kernel vs plain version ---------------------------------
    from light_path_tracer_tpu_torch import disk as disk_mod
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_cuda, trace_disk_rays_plain, trace_disk_rays_two_pass,
        trace_rays_kerr_plain, trace_rays_kerr_two_pass)
    kerr = Kerr(M=1.0, a=0.9)
    disk_cfg = disk_mod.DiskConfig()
    r_in = disk_mod.r_isco(1.0, 0.9)
    opaque = (r_in, disk_cfg.r_out, float(np.pi / 2), True)
    translucent = (r_in, disk_cfg.r_out, float(np.pi / 2), False)
    print("disk kernel vs plain version (f32 'fast'):", flush=True)
    rng = np.random.default_rng(0)
    al_d = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    th_d = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    disk_both("4096 random rays, opaque", kerr, al_d, th_d, GATE_STEPS,
              opaque, 2, 5)
    disk_both("4096 random rays, translucent, momenta", kerr, al_d, th_d,
              GATE_STEPS, translucent, 2, 5, record_momentum=True)
    scene4 = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS,
                         theta_obs=THETA_DISK)
    fov4 = camera.fov_from_vertical(scene4.vertical_fov, dim)
    grid4 = dict(dtype=torch.float32, device=dev)
    al4 = camera.build_alpha_lookup(dim, fov4, **grid4).reshape(-1)
    th4 = camera.build_theta_lookup(dim, fov4, **grid4).reshape(-1)
    # Capped at the first pass's 512 attempts, for both versions: a
    # near-axis ray of this grid can grind the whole 200,000-attempt
    # budget, and the plain loop costs ~10 ms an iteration at 1M rays.
    gdisk = disk_both("1024^2 config-4 grid, max_steps 512", kerr, al4,
                      th4, 512, opaque, 2, 3)

    # -- 9. two-pass drivers -----------------------------------------------
    print("two-pass drivers (pass1_steps 512, slots 8192 unless stated):",
          flush=True)
    drv = {}
    for label, offset in (("aligned", (0.0, 0.0)), ("quarter-pixel offset",
                                                    (0.25, 0.25))):
        al_o = camera.build_alpha_lookup(dim, fov4, pixel_offset=offset,
                                         **grid4).reshape(-1)
        th_o = camera.build_theta_lookup(dim, fov4, pixel_offset=offset,
                                         **grid4).reshape(-1)
        o_args = (kerr, R_OBS, al_o, th_o, THETA_DISK, LAMBDA_MAX,
                  cfg.max_steps, opaque, 2)
        one_ms, r1 = cuda_ms(lambda: trace_disk_rays_cuda(*o_args), 3)
        two_ms, r2 = cuda_ms(lambda: trace_disk_rays_two_pass(*o_args), 3)
        _, unc = trace_disk_rays_cuda(*o_args[:6], 512, opaque, 2,
                                      return_unconverged=True)
        n_unc = int(unc.sum())
        same = disk_bitwise(r1, r2)
        row = dict(single_ms=one_ms, two_pass_ms=two_ms, unconverged=n_unc,
                   bitwise_equal=same, n_steps_single=int(r1.n_steps),
                   n_steps_two_pass=int(r2.n_steps))
        drv[label] = row
        print(f"  disk 1024^2 {label}: {json.dumps(row)}", flush=True)
        require(same or n_unc > 8192, f"disk two-pass {label} differs from "
                f"the single pass with {n_unc} <= 8192 unconverged rays")
    # The driver over the kernel and over the plain loop, on phase 8's
    # 4,096 rays (max_steps 20,000, pass1_steps 64).
    r_args = (kerr, R_OBS, al_d, th_d, THETA_DISK, LAMBDA_MAX, GATE_STEPS,
              opaque, 2)
    two_ms_k, r2k = cuda_ms(lambda: trace_disk_rays_two_pass(
        *r_args, pass1_steps=64), 5)
    two_ms_p, r2p = cuda_ms(lambda: trace_disk_rays_two_pass(
        *r_args, pass1_steps=64, trace_fn=trace_disk_rays_plain), 1)
    probe_d = {}
    same = disk_bitwise(trace_disk_rays_cuda(*r_args, probe=probe_d), r2k)
    g_drv = disk_compare(r2k, r2p)
    g_drv.update(ms=two_ms_k, plain_ms=two_ms_p, bitwise_equal=same,
                 attempts_sum=driver_attempts(probe_d["attempts"], 64))
    print(f"  disk driver, 4096 random rays, pass1_steps 64, kernel vs "
          f"plain loop: {json.dumps(g_drv)}", flush=True)
    require(same, "disk two-pass differs from the single pass at 4096 rays")
    require(g_drv["status_agree"] > 0.99 and g_drv["nhits_agree"] > 0.99
            and g_drv["median_dr"] < 1e-3 and g_drv["p99_dr"] < 0.1,
            f"disk driver gate: {g_drv}")

    al3, th3, rf3, _rows = trace_inputs(scene, cfg, dim, fov, dev)
    k_args = (kerr, R_OBS, al3, th3, np.pi / 2, rf3, LAMBDA_MAX,
              cfg.max_steps)
    one_ms, k1 = cuda_ms(lambda: kerr_trace_kernel.trace_rays_kerr_cuda(
        *k_args), 3)
    two_ms, k2 = cuda_ms(lambda: trace_rays_kerr_two_pass(
        *k_args, pass1_steps=64), 3)
    _, unc = kerr_trace_kernel.trace_rays_kerr_cuda(
        *k_args[:7], 64, return_unconverged=True)
    n_unc = int(unc.sum())
    same = all(same_bits(a, b) for a, b in zip(k1[:3], k2[:3]))
    plain2_ms, k2p = cuda_ms(lambda: trace_rays_kerr_two_pass(
        *k_args, pass1_steps=64, trace_fn=trace_rays_kerr_plain), 1)
    g_k2 = compare(k2, k2p, al3, ac)
    kerr_row = dict(attempts_sum=driver_attempts(gmain["attempts"], 64),
                    single_ms=one_ms, two_pass_ms=two_ms, unconverged=n_unc,
                    bitwise_equal=same, n_steps_single=int(k1.n_steps),
                    n_steps_two_pass=int(k2.n_steps), plain_ms=plain2_ms,
                    kernel_vs_plain=g_k2)
    print(f"  Kerr shadow 1024^2 main-path rays, pass1_steps 64: "
          f"{json.dumps(kerr_row)}", flush=True)
    require(same or n_unc > 8192, f"Kerr two-pass differs from the single "
            f"pass with {n_unc} <= 8192 unconverged rays")
    require(g_k2["status_agree"] > 0.99 and g_k2["p99"] < 2e-3,
            f"Kerr driver kernel vs plain gate: {g_k2}")
    del al3, th3, rf3, k1, k2, k2p, r2k, r2p

    trace_rays_kerr_two_pass.launches = 0
    kerr_trace_kernel.trace_rays_kerr_cuda.launches = 0
    kerr_trace.trace_rays_kerr.launches = 0
    img_tp, st_tp = render_shadow(scene, dim, RenderConfig(
        two_pass=True, pass1_steps=64), device="cuda")
    launches_k2 = trace_rays_kerr_two_pass.launches
    print(f"  render_shadow two_pass=True: driver calls {launches_k2}, "
          f"kernel launches {kerr_trace_kernel.trace_rays_kerr_cuda.launches},"
          f" plain-loop calls {kerr_trace.trace_rays_kerr.launches}, "
          f"precompute {st_tp['timings']['precompute'] * 1e3:.3f} ms",
          flush=True)
    require(launches_k2 == 1 and kerr_trace.trace_rays_kerr.launches == 0
            and kerr_trace_kernel.trace_rays_kerr_cuda.launches == 2,
            "render_shadow two_pass=True did not run the driver over the "
            "kernel")
    require(bool(torch.equal(img_tp, img)) or n_unc > 8192,
            "render_shadow two_pass=True differs from the single pass")

    # -- 10. config 4: 1024^2 thin-disk render ------------------------------
    trace_disk_rays_cuda.launches = 0
    trace_disk_rays_two_pass.launches = 0
    kerr_trace.trace_disk_rays_kerr.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    img4, st4 = disk_mod.render_disk(scene4, dim, cfg, disk_cfg,
                                     device="cuda")          # warmup
    best4, runs4 = None, []
    for _ in range(3):
        img4, st4 = disk_mod.render_disk(scene4, dim, cfg, disk_cfg,
                                         device="cuda")
        runs4.append(dict(st4["timings"]))
        rps = st4["traced_rays"] / st4["timings"]["precompute"]
        best4 = rps if best4 is None else max(best4, rps)
    launches4 = trace_disk_rays_cuda.launches
    driver4 = trace_disk_rays_two_pass.launches
    plain4 = kerr_trace.trace_disk_rays_kerr.launches
    peak4 = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"config 4: disk kernel launches {launches4}, two-pass driver "
          f"calls {driver4}, plain-loop calls {plain4}, disk_pixels "
          f"{st4['disk_pixels']}, captured {st4['captured']}, "
          f"integrator_steps {st4['integrator_steps']}, stages of each run "
          f"(s) {json.dumps(runs4)}, peak device memory {peak4:.1f} MiB",
          flush=True)
    require(launches4 >= 8 and driver4 >= 4 and plain4 == 0,
            f"config 4: {launches4} kernel launches, {driver4} driver calls,"
            f" {plain4} plain calls")
    require(st4["traced_rays"] == 1024 * 1024,
            f"config 4 traced_rays {st4['traced_rays']}")
    require(tuple(img4.shape) == dim and img4.dtype == torch.float32
            and bool(torch.isfinite(img4).all())
            and float(img4.min()) >= 0.0 and float(img4.max()) <= 1.0,
            "config 4: bad image")
    require(st4["disk_pixels"] > 0 and st4["captured"] > 0,
            f"config 4: disk_pixels {st4['disk_pixels']}, captured "
            f"{st4['captured']}")
    left = float(img4[:, :512].double().sum())
    right = float(img4[:, 512:].double().sum())
    beaming = max(left, right) / max(min(left, right), 1e-9)
    print(f"config 4 image: halves {left:.1f} / {right:.1f}, ratio "
          f"{beaming:.3f}; best {best4:,.0f} rays/s on {card}", flush=True)
    require(beaming > 2.0, f"config 4: Doppler half ratio {beaming:.3f}")

    dim64 = (64, 64)
    og, _ = disk_mod.render_disk(scene4, dim64, cfg, disk_cfg, device="cuda")
    oc, _ = disk_mod.render_disk(scene4, dim64, cfg, disk_cfg, device="cpu")
    fov64 = camera.fov_from_vertical(scene4.vertical_fov, dim64)
    masks = []
    for device in ("cuda", "cpu"):
        g64 = dict(dtype=torch.float32, device=device)
        res64 = disk_mod.trace_disk_rays(
            kerr, R_OBS,
            camera.build_alpha_lookup(dim64, fov64, **g64).reshape(-1),
            camera.build_theta_lookup(dim64, fov64, **g64).reshape(-1),
            THETA_DISK, LAMBDA_MAX, cfg.max_steps, disk_cfg)
        masks.append((res64.n_hits > 0).cpu().reshape(dim64))
    mask_agree = float((masks[0] == masks[1]).float().mean())
    both = masks[0] & masks[1]
    d64 = float((og.cpu() - oc).abs()[both].median())
    print(f"config 4 check, 64^2 card vs CPU: disk masks agree "
          f"{mask_agree:.4f}, median |d image| on disk pixels {d64:.3e}",
          flush=True)
    require(mask_agree >= 0.99 and d64 < 1e-3,
            f"64^2 disk card vs CPU: masks {mask_agree:.4f}, median {d64}")

    # -- 11-13. the volumetric and spectral paths ------------------------
    vol_kernels, state = volumetric_phases(dev, card)

    # -- 14-15. the Stokes, movie and order forms and their renders -------
    new_kernels = new_mode_phases(dev, card, state)

    # -- 16. the peak probe ------------------------------------------------
    probe_kernel, rates = probe_phase(dev, card)

    # -- 17. the float64 instances ----------------------------------------
    f64_kernels = float64_phase(dev, card, dict(
        kerr_rays=(alphas, thetas, refine), disk_rays=(al_d, th_d),
        opaque=opaque, state=state, main_dim=dim))

    # -- 18. the exact-cycle exit -------------------------------------------
    cycle_phase(card)

    # -- 19. the rays of the reference; the Kerr kernel's booking --------
    reference_phase(dev, card)

    shadow_work = kerr_work()
    # Bytes a ray: alpha, theta (and the refine byte) in; final_alpha,
    # n_half and the status out, plus p_phi, n_hits and two slots of
    # (r, phi) hits in the disk variant.
    kernels = [
        kernel_entry("kerr_dp45", KERNEL_SOURCE, REPLACES, launches,
                     gmain["max_abs"], gmain["ms"], gmain["plain_ms"],
                     gmain["n"], 9 + 12,
                     gmain["attempts_sum"] * shadow_work, gmain),
        kernel_entry("schwarzschild_rk4", ORBIT_SOURCE, ORBIT_REPLACES,
                     launches1 + launches2, gorb["max_abs"], gorb["ms"],
                     gorb["plain_ms"], gorb["n"], 4 + 13,
                     gorb["attempts_sum"] * orbit_work(), gorb),
        kernel_entry("kerr_dp45_disk", KERNEL_SOURCE, f"{JAX_KERNELS}:316",
                     launches4, gdisk["max_dr"], gdisk["ms"],
                     gdisk["plain_ms"], gdisk["n"], 8 + 20 + 16,
                     gdisk["attempts_sum"] * shadow_work, gdisk),
        kernel_entry("trace_disk_rays_two_pass", DRIVER_SOURCE,
                     f"{JAX_KERNELS}:416", driver4, g_drv["max_dr"],
                     two_ms_k, two_ms_p, int(al_d.numel()), 8 + 20 + 16,
                     g_drv["attempts_sum"] * shadow_work),
        kernel_entry("trace_rays_kerr_two_pass", DRIVER_SOURCE,
                     f"{JAX_KERNELS}:257", launches_k2, g_k2["max_abs"],
                     kerr_row["two_pass_ms"], plain2_ms, gmain["n"], 9 + 12,
                     kerr_row["attempts_sum"] * shadow_work)]
    kernels += vol_kernels + new_kernels + [probe_kernel] + f64_kernels
    # The counted bound: every operation by kind at the rate phase 16
    # measured for it (a flop at no less than the published rate).
    for k in kernels:
        ms, by, parts = bounds.counted_bound_ms(
            bounds.Work(k["flops"], k["ops"], k["flops_type"]), k["bytes"],
            rates)
        k.update(bound_counted_ms=ms, bound_counted_by=by,
                 bound_counted_ms_by_kind=parts)
    require(all(k["launches"] > 0 for k in kernels),
            f"a kernel was not launched on its path: "
            f"{[k['name'] for k in kernels if k['launches'] <= 0]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
