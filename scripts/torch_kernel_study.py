#!/usr/bin/env python3
"""What building without FMA contraction costs and changes, and where the
main path's Kerr kernel loses its time, on one NVIDIA GPU.

  python3 scripts/torch_kernel_study.py [--out study.json] [--turns 4]
                                        [--sections ab,rays,main,regs]
                                        [--blocks 7,0]
  python3 scripts/torch_kernel_study.py --sections extras --parent DIR
                                        [--extras-blocks 3,4,5,6]
  python3 scripts/torch_kernel_study.py --sections kerr --parent DIR
  python3 scripts/torch_kernel_study.py --sections planes --parent DIR

ab: builds the kernel library twice from the same sources, as the package
    builds it (ops/cuda/_build.py NVCC_FLAGS, with -fmad=false) and with
    nvcc's default contraction of a*b + c into FMA (the flag taken out),
    then times every ray kernel at its main-path shape in turns
    (contracted, not, not, contracted, ...): each call by CUDA events
    (mean of 3 after a warm-up; a Kerr call is a memset and the kernel)
    and torch.profiler's device time a launch, each beside its bound (this
    run's flops over the published FP32 or FP64 rate; bytes are
    negligible beside them). Kernels: the Kerr shadow on the 524,288
    main-path rays (float32 and float64), the disk variant on config 4's
    aligned and quarter-offset 1024^2 grids (and float64 aligned), the
    orbit kernel on the 1024^2 Schwarzschild grid (both types), and the
    extras kernel's forms on the 1024^2 volumetric scene (a = 0.9,
    theta_obs 80 deg, FOV 16 deg, sat_window 2,048): thin (both types),
    absorbed, jet, 3-band, Stokes, movie thin and absorbed, orders thin
    and absorbed; and the peak probe's eight-chain float32 and float64
    FMA chains.
rays: in each build, config 4's rays (959, 510..512) of the aligned grid,
    every lane of the aligned and quarter-offset grids that ends frozen in
    an exact cycle (the census word of csrc/kerr_dp45_common.cuh
    CycleWatch), each beside the plain loop on the CPU (capped at 6,000
    attempts), and the 256^2
    order decomposition's lane (171, 129) under Order<3> beside the plain
    loop: status, attempts, hits, flags.
main: the Kerr kernel as the package builds it, on the main path's
    524,288 rays and on config 4's aligned 1024^2 grid: the wrapper by
    CUDA events and the kernel alone by torch.profiler, per-ray attempts
    (mean, max), lane efficiency sum(attempts) / (32 x warp step sum);
    the main path's slowest ray alone, and one frame of render_shadow
    and of config 4's render_disk under torch.profiler (device ms,
    kernel launches, busy share).
regs: the Kerr kernel against its register budget. For each count in
    --blocks of 128-thread blocks an SM must hold at once (the kernel's
    kBlocksPerSm, the second bound of its __launch_bounds__, which caps
    a thread at 65,536 / (128 x blocks) registers; 0 drops the bound),
    builds csrc/kerr_dp45.cu and csrc/kerr_dp45_f64.cu alone from a copy
    of csrc/ with that count, prints ptxas's registers and spills for
    each instance, and times the wrapper (CUDA events, mean of 5 after a
    warm-up) on the main path's rays and config 4's aligned grid, in
    float32 and float64, each output held bitwise against the package
    build's (a register budget may change the speed, never a result).
extras: the extras kernel (csrc/kerr_dp45_extras.cuh) against an earlier
    commit's. DIR holds that commit's csrc/ (unpacked from `git archive
    <commit> light_path_tracer_tpu_torch/csrc` into a git-ignored
    directory of the checkout, so it travels with the call). Builds the
    extras sources of DIR, of the package (every functor with its own
    block bound, kMinBlocks), and of one copy of the package's csrc/ for
    each --extras-blocks count (every instance built with that block
    bound), at most 12 nvcc processes at once; prints each build's
    registers and spills and, for the package and the copies, the
    runtime's blocks an SM of every instance, and the sin/cos range
    reductions in each float32 instance's SASS (cuobjdump). Then, in
    turns (the order reversed every other turn), after one untimed turn
    of every build on every scene, runs every build on the scenes: the
    1024^2 volumetric scene in float32 (thin, absorbed, jet, 3-band,
    Stokes, movie thin and absorbed, orders thin and absorbed, and more
    widths: 5 and 8 bands, movie thin and absorbed in 3 and 5 frames;
    max_steps 200000, sat_window 2048) and in float64, and phase 11's
    4,096 random rays (32 blocks: the size of a two-pass driver's second
    pass or a small render) in float32 and float64; times each call (CUDA
    events, mean of 3 after a warm-up; the summary gives the median over
    turns) and holds every output (extras, final alpha, half-orbits,
    status, flags, per-ray attempts, warp step sum) bitwise against the
    earlier commit's. The DOP853 sources (kerr_dop853_*.cu) of DIR and of
    the package build into a second library each and run the forms on the
    4,096 random rays (float32 and float64) and the 1024^2 thin and
    movie-absorbed scenes in float32 with method="dop853", held the same
    way. An earlier commit whose ExtrasCall lacks the metric family and
    Q^2 is launched through a mirror without them. A third DP45 build,
    "runtime family", is the package's csrc/ with the Kerr-Newman flow's
    compile-time branches turned into one branch on Q^2 at run time
    (RUNTIME_FAMILY), the design the package did not keep: it runs every
    Kerr scene beside the others, and on the 1024^2 thin and
    movie-absorbed scenes with a = 0.6, Q = 0.6 (float32) it is timed in
    turns against the package's template family (its *_kn instances),
    the two held bitwise (family_designs).
kerr: the Kerr kernel (csrc/kerr_dp45.cu, shadow and disk variants)
    against an earlier commit's, DIR as for extras. Builds
    kerr_dp45.cu and kerr_dp45_f64.cu of DIR and of the package into a
    library each (the earlier commit's KerrCall, which may lack the
    family fields, is mirrored from the wrapper's by dropping them),
    then in turns (the order reversed every other turn) after one
    untimed turn runs both on the Kerr a = 0.9 cases: the main path's
    524,288 rays and config 4's aligned 1024^2 grid (float32 and
    float64), and every disk instance (1-4 hits, with and without
    momenta) on 4,096 random rays in both types. Each call is timed by
    CUDA events (mean of 3 after a warm-up; the summary gives the median
    over turns) and the main-path and config-4 calls also alone (CUDA
    events with a spin kernel queued ahead, chip_smoke.kernel_alone_ms) and
    every output (status, final alpha, half-orbits, hits, the final
    state, per-ray attempts, warp step sum) is held bitwise against the
    earlier commit's; the DOP853 sources (kerr_dop853.cu and its f64
    sibling) of both build into a second library each and run the main
    path's rays and config 4's grid (float32 and float64) and the
    two-hit disk instances on the random rays with method="dop853", held
    the same way; with the package's Kerr-Newman and Johannsen-Psaltis
    shadow instances, and the mu chart's Kerr and Kerr-Newman instances
    (the main path's rays with the hybrid's poison mask, DP45 and DOP853,
    float32 and float64), timed beside them.
planes: the disk kernel's plane recorder (csrc/kerr_planes.cuh) against
    an earlier commit's, DIR as for extras. Builds kerr_dp45_planes.cu,
    kerr_dop853_planes.cu and their float64 siblings of DIR and of the
    package into a library each (8 nvcc processes at once) and prints
    each instance's registers and spills; then in turns (the order
    reversed every other turn) after one untimed turn runs both on
    chip_smoke's phase-25 plane sets (a flat tilted opaque plane; an
    equatorial opaque disk and a tilted opaque ring with the time
    recorder; a warped and a tilted translucent plane with the time
    recorder and momenta, 6 slots): config 4's 1024^2 grid with the
    float32 Kerr instances of both pairs (capped at 512 attempts, as
    phase 25), and 4,096 random rays with every instance (Kerr and
    Kerr-Newman, float32 and float64, DP45 and DOP853; capped at 400).
    Each call is timed alone (chip_smoke.kernel_alone_ms, mean of 3; the
    summary gives the median over turns), and every output of every
    plane, the per-ray attempts and accepted attempts are held bitwise
    against the earlier commit's.

The first line is the card's name and power limit. Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

R_OBS = 100.0
LAMBDA_MAX = 5000.0
THETA = float(np.radians(80.0))
# The plain loop on the CPU costs about a millisecond an attempt for one
# ray: a lane that reaches this cap there reads as still running.
PLAIN_CAP = 6000


def timed(fn, key, reps=3):
    """fn's mean time by CUDA events over `reps` calls after a warm-up,
    beside torch.profiler's mean device ms a launch of the kernels whose
    name holds `key` and the launches it kept a call."""
    from chip_smoke import cuda_ms, device_profile
    fn()
    ms, _ = cuda_ms(fn, reps)
    prof = device_profile(fn, reps, key)
    return dict(ms=ms, profiler_kernel_ms=prof["kernel_ms"],
                profiler_launches=prof["kernel_launches"])


class Builds:
    """The package's build and the contracted one, switched in place;
    each is built on first use."""

    def __init__(self):
        from light_path_tracer_tpu_torch.ops.cuda import _build
        self.b = _build
        own = tuple(_build.NVCC_FLAGS)
        self.flags = {"no contraction": own,
                      "contracted": tuple(f for f in own
                                          if f != "-fmad=false")}
        self.build_s = {}

    def use(self, name):
        self.b.NVCC_FLAGS = self.flags[name]
        self.b.load_library.cache_clear()
        t0 = time.perf_counter()
        lib = self.b.load_library()
        if name not in self.build_s:
            self.build_s[name] = time.perf_counter() - t0
            from chip_smoke import ptxas_report
            for kname, regs, spill in ptxas_report(lib.build_log):
                if "peak_probe" not in kname:
                    print(f"  ptxas [{name}]: {kname}: {regs} registers; "
                          f"{spill}", flush=True)
        return lib


def inputs(dev):
    import torch
    from light_path_tracer_tpu_torch import camera, disk, polarization
    from light_path_tracer_tpu_torch.pipeline import trace_inputs
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    f32 = dict(dtype=torch.float32, device=dev)
    dim = (1024, 1024)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = trace_inputs(scene, RenderConfig(), dim, fov, dev)
    out = dict(main=(al, th, rf))
    fov40 = camera.fov_from_vertical(np.radians(40.0), dim)
    for label, off in (("aligned", (0.0, 0.0)),
                       ("quarter", (0.25, 0.25))):
        out[label] = (
            camera.build_alpha_lookup(dim, fov40, pixel_offset=off,
                                      **f32).reshape(-1),
            camera.build_theta_lookup(dim, fov40, pixel_offset=off,
                                      **f32).reshape(-1))
    out["orbit"] = camera.build_alpha_lookup(dim, fov40,
                                             **f32).reshape(-1)
    fov16 = camera.fov_from_vertical(np.radians(16.0), dim)
    al_v = camera.build_alpha_lookup(dim, fov16, **f32).reshape(-1)
    th_v = camera.build_theta_lookup(dim, fov16, **f32).reshape(-1)
    out["vol"] = (al_v, th_v)
    out["plane"] = (disk.r_isco(1.0, 0.9), disk.DiskConfig().r_out,
                    float(np.pi / 2), True)
    from light_path_tracer_tpu_torch.models import Kerr
    out["aux"] = polarization.camera_constants(Kerr(M=1.0, a=0.9), R_OBS,
                                               THETA, al_v, th_v)
    return out


def volumetric_forms(kerr, aux):
    """(label, kind, args) of the extras kernel's forms, as
    scripts/torch_cycle_census.py has them."""
    from light_path_tracer_tpu_torch import polarization, volumetric
    R = volumetric.RIAFConfig
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                          True))
    times = tuple(period * k / 8 for k in range(8))
    forms = {}
    for name, riaf in (("thin", R()), ("absorbed", R(alpha0=0.3)),
                       ("jet", R(profile="jet", jet_beta=0.6,
                                 index=-1.0))):
        forms[name] = ("vol", volumetric.make_transfer_fns(kerr, riaf))
    forms["spectral 3-band"] = ("aux", (volumetric.make_spectral_transfer(
        kerr, R(g_power=4.0, alpha0=1.0, opacity_index=3.0),
        (0.1, 1.0, 10.0)), 4, (), (1, 2, 3)))
    forms["stokes toroidal"] = ("aux", (
        polarization.make_polarized_volumetric_transfer(
            kerr, R(), "toroidal", 0.7), 3, aux, (0, 1, 2)))
    for a0, tag in ((0.0, "thin"), (0.3, "absorbed")):
        ab = int(a0 > 0)
        forms[f"movie {tag}"] = ("aux", (volumetric.make_movie_transfer(
            kerr, R(spot_amp=8.0, alpha0=a0), times), 9 + ab, (),
            tuple(range(1 + ab, 9 + ab))))
        forms[f"order {tag}"] = ("aux", (volumetric.make_order_transfer(
            kerr, R(alpha0=a0), 3), 4 + ab, (),
            tuple(range(1 + ab, 4 + ab))))
    return forms


def vol_call(kerr, kind, args, al, th, max_steps=200000, **kw):
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    if kind == "vol":
        em, ab = args
        return vk.trace_rays_volumetric_cuda(
            kerr, R_OBS, al, th, THETA, em, LAMBDA_MAX, max_steps,
            absorption_fn=ab, sat_window=2048, **kw)
    tf, n_extras, aux, mon = args
    aux = tuple(a.to(al.dtype) for a in aux)
    return vk.trace_rays_aux_cuda(
        kerr, R_OBS, al, th, THETA, tf, n_extras, aux, LAMBDA_MAX,
        max_steps, sat_window=2048, sat_monitor=mon, **kw)


def attempts_sum(run):
    """Sum of one call's per-ray attempts (the wrapper's probe)."""
    probe = {}
    run(probe=probe)
    return int(probe["attempts"].double().sum())


def kernel_table(dev, X):
    """(label, profiler key, fn, flops, peak) of every timed kernel: fn
    takes the wrapper's keywords; flops() counts the operations this run's
    inputs need (per-ray attempts times chip_smoke.py's count of one
    attempt, transcendentals left out) at the published rate `peak` of
    their type."""
    import torch
    from light_path_tracer_tpu_torch.ops.cuda.bounds import (
        ORBIT_STEP_FLOPS, PEAK_FP32, PEAK_FP64, attempt_flops, form_flops)
    from light_path_tracer_tpu_torch.models import Kerr, Schwarzschild
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import peak_probe
    from light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel import (
        trace_rays_schwarzschild_cuda)
    kerr, schw = Kerr(M=1.0, a=0.9), Schwarzschild(M=1.0)
    al, th, rf = X["main"]
    peaks = {torch.float32: ("f32", PEAK_FP32),
             torch.float64: ("f64", PEAK_FP64)}
    rows = []

    def dp45(run, per_attempt):
        return lambda: attempts_sum(run) * per_attempt
    for dt in (torch.float32, torch.float64):
        a, t = al.to(dt), th.to(dt)
        run = (lambda a=a, t=t, **kw: kk.trace_rays_kerr_cuda(
            kerr, R_OBS, a, t, np.pi / 2, rf, LAMBDA_MAX, 200000, **kw))
        rows.append((f"kerr_dp45 shadow {peaks[dt][0]}, 524,288 main-path "
                     f"rays", "kerr_dp45_kernel", run,
                     dp45(run, attempt_flops(5)), peaks[dt][1]))
    for label, dt in (("aligned", torch.float32), ("quarter", torch.float32),
                      ("aligned", torch.float64)):
        a, t = (x.to(dt) for x in X[label])
        run = (lambda a=a, t=t, **kw: kk.trace_disk_rays_cuda(
            kerr, R_OBS, a, t, THETA, LAMBDA_MAX, 200000, X["plane"], 2,
            **kw))
        rows.append((f"kerr_dp45 disk {peaks[dt][0]}, config-4 {label} "
                     f"1024^2", "kerr_dp45_kernel", run,
                     dp45(run, attempt_flops(5)), peaks[dt][1]))
    for dt in (torch.float32, torch.float64):
        a = X["orbit"].to(dt)
        rows.append((f"orbit_rk4 {peaks[dt][0]}, 1024^2 Schwarzschild grid",
                     "orbit_rk4_kernel",
                     lambda a=a: trace_rays_schwarzschild_cuda(
                         schw, R_OBS, a),
                     lambda a=a: ORBIT_STEP_FLOPS * int(
                         trace_rays_schwarzschild_cuda(
                             schw, R_OBS, a, return_steps=True)[1]
                         .to(torch.int64).sum()), peaks[dt][1]))
    # Components and the extras' flops of one RHS, as chip_smoke.py counts
    # them (the jet as the thin form).
    per_form = {"thin": (6, "thin", 0, 0), "absorbed": (7, "absorbed", 0, 0),
                "jet": (6, "thin", 0, 0),
                "spectral 3-band": (9, "spectral", 3, 0),
                "stokes toroidal": (8, "stokes", 0, 0),
                "movie thin": (14, "movie", 8, 0),
                "movie absorbed": (15, "movie", 8, 1),
                "order thin": (9, "order", 3, 0),
                "order absorbed": (10, "order", 3, 1)}
    al_v, th_v = X["vol"]
    for name, (kind, args) in volumetric_forms(kerr, X["aux"]).items():
        comps, fk, width, ab = per_form[name]
        per_attempt = attempt_flops(comps, form_flops(fk, width, bool(ab)))
        for dt in ((torch.float32, torch.float64) if name == "thin"
                   else (torch.float32,)):
            a, t = al_v.to(dt), th_v.to(dt)
            run = (lambda a=a, t=t, kind=kind, args=args, **kw: vol_call(
                kerr, kind, args, a, t, **kw))
            rows.append((f"extras {name} {peaks[dt][0]}, 1024^2 volumetric "
                         f"scene", "kerr_dp45_extras_kernel", run,
                         dp45(run, per_attempt), peaks[dt][1]))
    for form in ("fma32x8", "fma64"):
        _index, dtype, ops = peak_probe.FORMS[form]
        x = torch.full((peak_probe.N_ELEMENTS,), 0.5, dtype=dtype,
                       device=dev)
        rows.append((f"peak_probe {form}, k 8192", "chain_kernel",
                     lambda x=x, form=form: peak_probe.chain_cuda(
                         x, 8192, form),
                     lambda ops=ops: ops * 8192 * peak_probe.N_ELEMENTS,
                     peaks[dtype][1]))
    return rows


def ab_section(dev, builds, X, turns):
    order = ["contracted", "no contraction"]
    seq = [order[(i + i // 2) % 2] for i in range(turns)]
    table = kernel_table(dev, X)
    out = {label: {v: [] for v in order} for label, *_rest in table}
    for turn, variant in enumerate(seq):
        builds.use(variant)
        for label, key, fn, _flops, _peak in table:
            row = timed(fn, key)
            out[label][variant].append(row)
            print(f"turn {turn} [{variant}] {label}: {json.dumps(row)}",
                  flush=True)
    # The bound of each row from the package build's per-ray attempts.
    builds.use("no contraction")
    bounds = {label: 1e3 * flops() / peak
              for label, _key, _fn, flops, peak in table}
    summary = {}
    for label, by in out.items():
        k = {v: float(np.mean([r["ms"] for r in by[v]])) for v in order}
        summary[label] = dict(
            ms_contracted=k["contracted"],
            ms_no_contraction=k["no contraction"],
            ratio=k["no contraction"] / k["contracted"],
            bound_ms=bounds[label])
        print(f"ab {label}: {json.dumps(summary[label])}", flush=True)
    return dict(turns=out, summary=summary)


def census_lanes(probe, width):
    from torch_cycle_census import decode
    period, streak, _moved = decode(probe["cycles"])
    idx = np.nonzero(period > 0)[0]
    return [(int(i // width), int(i % width)) for i in idx]


_PLAIN = {}


def disk_rays(dev, X, label, lanes):
    """The kernel's and the CPU plain loop's record of each lane (the
    plain loop's once a lane)."""
    import torch
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = Kerr(M=1.0, a=0.9)
    al, th = X[label]
    rows = []
    for r, c in lanes:
        i = r * 1024 + c
        pr = {}
        res = kk.trace_disk_rays_cuda(kerr, R_OBS, al[i:i + 1], th[i:i + 1],
                                      THETA, LAMBDA_MAX, 200000, X["plane"],
                                      2, probe=pr)
        if (label, i) not in _PLAIN:
            _PLAIN[(label, i)] = kerr_trace.trace_disk_rays_kerr(
                kerr, R_OBS, al[i:i + 1].cpu(), th[i:i + 1].cpu(), THETA,
                LAMBDA_MAX, PLAIN_CAP, X["plane"], 2)
        rp = _PLAIN[(label, i)]
        rows.append(dict(
            grid=label, row=r, col=c, alpha=float(al[i]),
            theta=float(th[i]), kernel_status=int(res.status[0]),
            kernel_attempts=int(pr["attempts"][0]),
            kernel_hits=int(res.n_hits[0]), plain_status=int(rp.status[0]),
            plain_attempts=int(rp.n_steps), plain_hits=int(rp.n_hits[0])))
    return rows


def rays_section(dev, builds, X):
    import torch
    from light_path_tracer_tpu_torch import camera
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch import volumetric
    kerr = Kerr(M=1.0, a=0.9)
    out = {}
    frozen = {}
    for variant in ("contracted", "no contraction"):
        builds.use(variant)
        for label in ("aligned", "quarter"):
            pr = {}
            al, th = X[label]
            kk.trace_disk_rays_cuda(kerr, R_OBS, al, th, THETA, LAMBDA_MAX,
                                    200000, X["plane"], 2, probe=pr)
            frozen[(variant, label)] = census_lanes(pr, 1024)
            print(f"[{variant}] config-4 {label}: frozen lanes "
                  f"{frozen[(variant, label)]}", flush=True)
    for variant in ("contracted", "no contraction"):
        builds.use(variant)
        rows = disk_rays(dev, X, "aligned", [(959, 510), (959, 511),
                                             (959, 512)])
        for label in ("aligned", "quarter"):
            lanes = sorted(set(frozen[("contracted", label)])
                           | set(frozen[("no contraction", label)]))
            lanes = [x for x in lanes if not (label == "aligned"
                                              and x[0] == 959
                                              and 510 <= x[1] <= 512)]
            rows += disk_rays(dev, X, label, lanes)
        # The 256^2 order decomposition's lane (171, 129), Order<3> thin.
        d = (256, 256)
        fov = camera.fov_from_vertical(np.radians(16.0), d)
        f32 = dict(dtype=torch.float32, device=dev)
        i = 171 * 256 + 129
        al = camera.build_alpha_lookup(d, fov, **f32).reshape(-1)[i:i + 1]
        th = camera.build_theta_lookup(d, fov, **f32).reshape(-1)[i:i + 1]
        tf = volumetric.make_order_transfer(kerr, volumetric.RIAFConfig(), 3)
        pr = {}
        res = vk.trace_rays_aux_cuda(kerr, R_OBS, al, th, THETA, tf, 4, (),
                                     LAMBDA_MAX, 200000, sat_window=2048,
                                     sat_monitor=(1, 2, 3), probe=pr)
        from light_path_tracer_tpu_torch.ops import kerr_trace
        rp = kerr_trace.trace_rays_aux(kerr, R_OBS, al.cpu(), th.cpu(),
                                       THETA, lambda y, pt, pp, _aux: tf(
                                           y, pt, pp), 4, (), LAMBDA_MAX,
                                       PLAIN_CAP,
                                       sat_window=2048,
                                       sat_monitor=(1, 2, 3))
        rows.append(dict(
            grid="order 256^2", row=171, col=129, alpha=float(al[0]),
            theta=float(th[0]), kernel_status=int(res.status[0]),
            kernel_attempts=int(pr["attempts"][0]),
            kernel_flags=int(pr["flags"][0]), plain_status=int(rp.status[0]),
            plain_attempts=int(rp.n_steps)))
        out[variant] = rows
        for row in rows:
            print(f"ray [{variant}]: {json.dumps(row)}", flush=True)
    out["frozen"] = {f"{v} {g}": lanes for (v, g), lanes in frozen.items()}
    return out


def main_section(dev, builds, X):
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from torch_profile_paths import paths, profile
    builds.use("no contraction")
    kerr = Kerr(M=1.0, a=0.9)
    al, th, rf = X["main"]

    def shadow(a, t, r, **kw):
        return kk.trace_rays_kerr_cuda(kerr, R_OBS, a, t, np.pi / 2, r,
                                       LAMBDA_MAX, 200000, **kw)

    ga, gt = X["aligned"]
    out = {}
    for name, run in (
            ("main path", lambda **kw: shadow(al, th, rf, **kw)),
            ("config-4 aligned", lambda **kw: kk.trace_disk_rays_cuda(
                kerr, R_OBS, ga, gt, THETA, LAMBDA_MAX, 200000, X["plane"],
                2, **kw))):
        pr = {}
        res = run(probe=pr)
        att = pr["attempts"].double()
        w = int(res.n_steps)
        row = dict(wrapper=timed(run, "kerr_dp45"),
                   attempts_mean=float(att.mean()),
                   attempts_max=int(att.max()), attempts_sum=int(att.sum()),
                   warp_step_sum=w,
                   lane_efficiency=float(att.sum()) / (32 * w))
        out[name] = row
        print(f"Kerr kernel, {name}: {json.dumps(row)}", flush=True)
    pr = {}
    shadow(al, th, rf, probe=pr)
    i = int(pr["attempts"].argmax())
    out["main path, slowest ray alone"] = dict(timed(
        lambda: shadow(al[i:i + 1], th[i:i + 1], rf[i:i + 1]), "kerr_dp45"),
        ray=i, attempts=int(pr["attempts"][i]))
    print(f"main path, slowest ray alone: "
          f"{json.dumps(out['main path, slowest ray alone'])}", flush=True)
    table = paths(1024)
    for name in ("shadow", "disk"):
        row = profile(table[name], 3)
        out[f"frame {name}"] = row
        print(f"frame {name} 1024^2: {json.dumps(row)}", flush=True)
    return out


def declare_kerr(lib, library="dp45"):
    """Declare the Kerr kernel's two entries (float32, float64) of a
    library built from kerr_dp45.cu and kerr_dp45_f64.cu alone (or, for
    library "dop853", from kerr_dop853.cu and kerr_dop853_f64.cu)."""
    import ctypes
    from light_path_tracer_tpu_torch.ops.cuda import _build
    pair = "_dop853" if library == "dop853" else ""
    for suffix in (pair, pair + "_f64"):
        fn = getattr(lib, "lpt_kerr_dp45" + suffix)
        fn.argtypes = [_build._P, _build._I]
        fn.restype = _build._I
    lib.lpt_cuda_error_string.argtypes = [_build._I]
    lib.lpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kerr_build(blocks):
    """Build (or load) csrc/kerr_dp45.cu and its float64 sibling alone,
    from a copy of csrc/ whose Kerr kernel asks for `blocks` blocks an SM
    (0: no second bound), and make it the library the wrappers call.
    Returns the build's seconds and ptxas's report."""
    from chip_smoke import ptxas_report
    from light_path_tracer_tpu_torch.ops.cuda import _build
    src = _build.CSRC
    text = (src / "kerr_dp45.cu").read_text()
    const = "constexpr int kBlocksPerSm = 7;"
    bound = "__launch_bounds__(kThreads, kBlocksPerSm)"
    if const not in text or bound not in text:
        raise RuntimeError("csrc/kerr_dp45.cu no longer states its block "
                           "bound as this study expects")
    text = (text.replace(const, f"constexpr int kBlocksPerSm = {blocks};")
            if blocks else text.replace(bound, "__launch_bounds__(kThreads)"))
    tmp = _build.BUILD_DIR / f"kerr_blocks_{blocks}"
    tmp.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cuh"):
        (tmp / f.name).write_text(f.read_text())
    (tmp / "kerr_dp45.cu").write_text(text)
    (tmp / "kerr_dp45_f64.cu").write_text(
        (src / "kerr_dp45_f64.cu").read_text())
    _build.CSRC = tmp
    _build._sources = lambda _library="dp45": [tmp / "kerr_dp45.cu",
                                               tmp / "kerr_dp45_f64.cu"]
    _build._declare = declare_kerr
    _build.load_library.cache_clear()
    t0 = time.perf_counter()
    lib = _build.load_library()
    return time.perf_counter() - t0, [
        dict(kernel=k, registers=r, spill=sp)
        for k, r, sp in ptxas_report(lib.build_log)]


def regs_section(dev, builds, X, blocks_list):
    import torch
    from chip_smoke import cuda_ms, same_bits
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = Kerr(M=1.0, a=0.9)
    al, th, rf = X["main"]
    ga, gt = X["aligned"]
    cases = {}
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        cases[f"main path {tag}"] = (
            lambda a=al.to(dt), t=th.to(dt): kk.trace_rays_kerr_cuda(
                kerr, R_OBS, a, t, np.pi / 2, rf, LAMBDA_MAX, 200000))
        cases[f"config-4 aligned {tag}"] = (
            lambda a=ga.to(dt), t=gt.to(dt): kk.trace_disk_rays_cuda(
                kerr, R_OBS, a, t, THETA, LAMBDA_MAX, 200000, X["plane"], 2))

    def flat(res):
        return [y for x in res for y in (x if isinstance(x, tuple) else (x,))]
    builds.use("no contraction")
    want = {label: flat(run()) for label, run in cases.items()}
    saved = (_build.CSRC, _build._sources, _build._declare)
    out = {}
    try:
        for blocks in blocks_list:
            build_s, report = kerr_build(blocks)
            for row in report:
                print(f"  blocks {blocks}: {row['kernel']}: "
                      f"{row['registers']} registers; {row['spill']}",
                      flush=True)
            rows = {}
            for label, run in cases.items():
                got = flat(run())
                ms, _ = cuda_ms(run, 5)
                rows[label] = dict(ms=ms, bitwise_equal=all(
                    same_bits(x, y) for x, y in zip(got, want[label])))
                print(f"blocks {blocks}, {label}: {json.dumps(rows[label])}",
                      flush=True)
            out[str(blocks)] = dict(build_s=build_s, ptxas=report,
                                    calls=rows)
    finally:
        _build.CSRC, _build._sources, _build._declare = saved
        _build.load_library.cache_clear()
    return out


# The extras kernel's family sources (float32, then their float64
# siblings), and the expression of csrc/kerr_dp45_extras.cuh that gives
# every instance its functor's block bound (in the kernel's
# __launch_bounds__ and in what describe() reports).
EXTRAS_SOURCES = ("kerr_dp45_extras", "kerr_dp45_stokes",
                  "kerr_dp45_movie_thin", "kerr_dp45_movie_absorbed",
                  "kerr_dp45_orders")
BOUND_EXPR = "F::kMinBlocks"
# The scenes' forms and the instance each launches (float32 names).
SCENE_INSTANCES = {
    "thin": "VolThin<{}>", "absorbed": "VolAbsorbed<{}>",
    "jet": "VolThin<{}>", "spectral 3-band": "Spectral<3,{}>",
    "stokes toroidal": "Stokes<{}>",
    "movie thin": "Movie<8,absorbing=0,{}>",
    "movie absorbed": "Movie<8,absorbing=1,{}>",
    "order thin": "Order<3,absorbing=0,{}>",
    "order absorbed": "Order<3,absorbing=1,{}>"}


def parallel_builds(study, dirs, sources, declare, jobs=12):
    """Compile `sources` (file names without .cu) of each csrc directory of
    `dirs` ({build: directory}), at most `jobs` nvcc processes at a time,
    link each build's objects into a library under the build directory's
    `study` folder and load it; declare(lib, build, directory) declares
    its entries and returns what the build keeps beside them. A directory
    that holds csrc/lpt_pow_f64.cu builds its float64 extras sources as
    the package does (relocatable, with that pow, device-linked). Returns
    {build: (library, nvcc log, object directory, declared)}."""
    import concurrent.futures
    import ctypes
    from light_path_tracer_tpu_torch.ops.cuda import _build
    root = _build.BUILD_DIR / study
    cmds = []
    for name, d in dirs.items():
        out = root / name.replace(":", "_")
        out.mkdir(parents=True, exist_ok=True)
        rdc = (d / _build.POW_SOURCE).exists()
        srcs = [(src, _build.NVCC_FLAGS + (
            _build.RDC_FLAGS if rdc and _build._rdc_source(src + ".cu")
            else ())) for src in sources]
        if any(_build.RDC_FLAGS[0] in f for _s, f in srcs):
            srcs.append((_build.POW_SOURCE[:-len(".cu")], _build.POW_FLAGS))
        for src, flags in srcs:
            cmds.append((name, out / f"{src}.o", [
                _build._nvcc(), *flags, "-c", "-o",
                str(out / f"{src}.o"), str(d / f"{src}.cu")]))

    def run(cmd):
        return subprocess.run(cmd, capture_output=True, text=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        done = list(pool.map(run, [c for _n, _o, c in cmds]))
    logs = {name: "" for name in dirs}
    for (name, _obj, cmd), proc in zip(cmds, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        logs[name] += proc.stdout + proc.stderr
    builds = {}
    for name, d in dirs.items():
        out = root / name.replace(":", "_")
        so = out / f"lpt_{study}.so"
        objs = [str(o) for n, o, _c in cmds if n == name]
        rdc = [str(o) for n, o, c in cmds if n == name and "-rdc=true" in c]
        if rdc:
            objs.append(str(out / "dlink.o"))
            subprocess.run([_build._nvcc(), *_build.DLINK_FLAGS, "-o",
                            objs[-1], *rdc], check=True, capture_output=True)
        subprocess.run([_build._nvcc(), *_build.LINK_FLAGS, "-o", str(so),
                        *objs], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        builds[name] = (lib, logs[name], out, declare(lib, name, d))
    print(f"{study} builds ({len(dirs)} x {len(sources)} sources, {jobs} "
          f"at a time): {time.perf_counter() - t0:.1f} s", flush=True)
    return builds


# The runtime-branch variant of the extras kernel's metric family: the
# package's csrc/ with the family's compile-time branches turned into one
# branch on Q^2 at run time, so the Kerr instances serve Kerr-Newman too
# (the design the package did not keep: it builds the family as a
# template argument, *_kn.cu). (file, text, replacement) of each rewrite.
RUNTIME_FAMILY = (
    ("kerr_dp45_common.cuh", "constexpr bool kCharged = F == kKerrNewman;",
     "const bool kCharged = F == kKerrNewman || P.q2 != T(0.0);"),
    ("kerr_dp45_common.cuh", "if constexpr (kCharged)", "if (kCharged)"),
    ("kerr_dp45_extras.cuh", "if constexpr (Fam == kKerrNewman)",
     "if (P.q2 != T(0.0))"),
    ("kerr_dp45_extras.cuh", "C.family != kExtrasFamily",
     "C.family != kExtrasFamily && C.family != kKerrNewman"),
    ("kerr_dp45_movie.cuh", "if constexpr (Fam == kKerrNewman)",
     "if (P.q2 != T(0.0))"),
)


def runtime_family_csrc(root):
    """A copy of the package's csrc/ under `root` with RUNTIME_FAMILY's
    rewrites; raises if a rewritten text is gone from the sources."""
    import shutil
    from light_path_tracer_tpu_torch.ops.cuda import _build
    d = root / "runtime_family" / "csrc"
    d.mkdir(parents=True, exist_ok=True)
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        shutil.copyfile(f, d / f.name)
    for name, old, new in RUNTIME_FAMILY:
        text = (d / name).read_text()
        if old not in text:
            raise RuntimeError(f"csrc/{name} no longer holds {old!r}")
        (d / name).write_text(text.replace(old, new))
    return d


def extras_builds(parent, blocks, jobs=12):
    """Build the extras sources of the earlier commit's csrc/ (`parent`),
    of the package's, and of one copy of the package's for each count in
    `blocks` with every instance built with that block bound; at most
    `jobs` nvcc processes at a time. Returns {build: (library, nvcc log,
    object directory)} with each library's extras entries declared."""
    import shutil
    from pathlib import Path
    from light_path_tracer_tpu_torch.ops.cuda import _build
    root = _build.BUILD_DIR / "extras_study"
    dirs = {"parent": Path(parent), "package": _build.CSRC,
            "runtime family": runtime_family_csrc(root)}
    for count in blocks:
        name = f"blocks:{count}"
        d = root / name.replace(":", "_") / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        for f in list(_build.CSRC.glob("*.cu")) + list(
                _build.CSRC.glob("*.cuh")):
            shutil.copyfile(f, d / f.name)
        text = (d / "kerr_dp45_extras.cuh").read_text()
        if f"__launch_bounds__(kThreads, {BOUND_EXPR})" not in text:
            raise RuntimeError("csrc/kerr_dp45_extras.cuh no longer states "
                               "its block bounds as this study expects")
        (d / "kerr_dp45_extras.cuh").write_text(text.replace(
            BOUND_EXPR, str(count)))
        dirs[name] = d

    def declare(lib, _name, _d, pair=""):
        for entry in _build.EXTRAS_ENTRIES:
            for suffix in (pair, pair + "_f64"):
                fn = getattr(lib, entry + suffix)
                fn.argtypes = [_build._P, _build._P]
                fn.restype = _build._I
                if hasattr(lib, f"{entry}_describe{suffix}"):
                    fn = getattr(lib, f"{entry}_describe{suffix}")
                    fn.argtypes = [_build._I, _build._I, _build._P]
                    fn.restype = _build._I
        lib.lpt_cuda_error_string = lambda rc: b"see cudaError_t"
    sources = [src + suffix for src in EXTRAS_SOURCES
               for suffix in ("", "_f64")]
    builds = {name: (lib, log, out) for name, (lib, log, out, _) in
              parallel_builds("extras_study", dirs, sources, declare,
                              jobs).items()}
    # The DOP853 instances of the parent and the package, a second
    # library each.
    d853 = [src.replace("kerr_dp45", "kerr_dop853") + suffix
            for src in EXTRAS_SOURCES for suffix in ("", "_f64")]
    d853_dirs = {name: dirs[name] for name in ("parent", "package")}
    for name, (lib, log, out, _) in parallel_builds(
            "extras_dop853_study", d853_dirs, d853,
            lambda lib, n, d: declare(lib, n, d, "_dop853"), jobs).items():
        builds[name + ":dop853"] = (lib, log, out)
    return builds


def extras_mirrors(parent):
    """The ExtrasCall mirrors an earlier commit's extras kernel takes: the
    package's without the metric family and Q^2 where its
    csrc/kerr_dp45_extras.cuh has neither (its float scalars then start 4
    bytes sooner), else None."""
    import ctypes
    from pathlib import Path
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    text = (Path(parent) / "kerr_dp45_extras.cuh").read_text()
    if "cycle_exit, family" in text:
        return None
    return tuple(type(f"Old{c.__name__}", (ctypes.Structure,), {
        "_fields_": [f for f in vk._call_fields(real)
                     if f[0] not in ("family", "q2")]})
        for c, real in ((vk.ExtrasCall, ctypes.c_float),
                        (vk.ExtrasCall64, ctypes.c_double)))


class use_extras_build:
    """Within the block the extras wrappers launch the library `lib` of a
    build (its pair's library for every name), through `mirrors` (the
    ExtrasCall mirrors of an earlier commit) when given."""

    def __init__(self, lib, mirrors=None):
        self.lib, self.mirrors = lib, mirrors

    def __enter__(self):
        from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel
        vk = self.vk = volumetric_kernel
        self.saved = (vk.load_library, vk.ExtrasCall, vk.ExtrasCall64)
        vk.load_library = lambda _library="dp45", lib=self.lib: lib
        if self.mirrors:
            vk.ExtrasCall, vk.ExtrasCall64 = self.mirrors

    def __exit__(self, *exc):
        (self.vk.load_library, self.vk.ExtrasCall,
         self.vk.ExtrasCall64) = self.saved


def trig_reductions(obj_dir):
    """How many sin/cos range reductions (a product by 2/pi, the first
    step of every sinf and cosf sequence) each float32 extras kernel of a
    build's objects holds, by cuobjdump's SASS: {label: count}, or {}
    where the toolkit has no cuobjdump."""
    import re
    import shutil
    from chip_smoke import kernel_label
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    counts = {}
    for obj in sorted(obj_dir.glob("*.o")):
        sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                              text=True).stdout
        for part in sass.split("Function : ")[1:]:
            name = kernel_label(part.split()[0])
            if name.startswith("kerr_dp45_extras") and name.endswith(
                    "float>>"):
                counts[name] = len(re.findall(
                    r"0\.6366197[0-9]*|6\.366197[0-9]*e-01", part))
    return counts


def extras_scenes(dev, X):
    """(label, kind, args, alphas, thetas) of the extras section's runs:
    the 1024^2 volumetric scene and phase 11's 4,096 random rays, each in
    float32 and float64."""
    import torch
    from light_path_tracer_tpu_torch import polarization, volumetric
    from light_path_tracer_tpu_torch.models import Kerr
    kerr = Kerr(M=1.0, a=0.9)
    al_v, th_v = X["vol"]
    rng = np.random.default_rng(0)
    ac = kerr.alpha_crit(R_OBS, THETA)
    f64 = dict(dtype=torch.float64, device=dev)
    al_r = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, 4096), **f64)
    th_r = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f64)
    aux_r = polarization.camera_constants(kerr, R_OBS, THETA, al_r, th_r)
    al_r32, th_r32 = al_r.float(), th_r.float()
    aux_r32 = polarization.camera_constants(kerr, R_OBS, THETA, al_r32,
                                            th_r32)
    # More widths on the 1024^2 scene: five and eight bands, movie thin
    # and absorbed in three and five frames.
    R = volumetric.RIAFConfig
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                          True))
    wider = {}
    for b in (5, 8):
        wider[f"spectral {b}-band"] = ("aux", (
            volumetric.make_spectral_transfer(
                kerr, R(g_power=4.0, alpha0=1.0, opacity_index=3.0),
                tuple(np.geomspace(0.1, 10.0, b))), 1 + b, (),
            tuple(range(1, 1 + b))), f"Spectral<{b},{{}}>")
    for ab, name in ((0, "thin"), (1, "absorbed")):
        for f in (3, 5):
            wider[f"movie {name} {f}-frame"] = ("aux", (
                volumetric.make_movie_transfer(
                    kerr, R(spot_amp=8.0, alpha0=0.3 * ab),
                    tuple(period * k / f for k in range(f))), 1 + ab + f,
                (), tuple(range(1 + ab, 1 + ab + f))),
                f"Movie<{f},absorbing={ab},{{}}>")
    rows = []
    for tag, al, th, aux in (
            ("f32 1024^2", al_v, th_v, X["aux"]),
            ("f64 1024^2", al_v.double(), th_v.double(), X["aux"]),
            ("f32 4,096 rays", al_r32, th_r32, aux_r32),
            ("f64 4,096 rays", al_r, th_r, aux_r)):
        real = "double" if al.dtype == torch.float64 else "float"
        forms = {name: (kind, args, SCENE_INSTANCES[name])
                 for name, (kind, args) in volumetric_forms(kerr,
                                                            aux).items()}
        if "1024" in tag:
            forms.update(wider)
        for name, (kind, args, inst) in forms.items():
            rows.append((f"{name}, {tag}", kind, args, al, th,
                         f"kerr_dp45_extras<{inst.format(real)}>"))
            # DOP853: every form on the random rays, the thin and
            # movie-absorbed forms on the float32 1024^2 scene
            if "4,096" in tag or (tag == "f32 1024^2" and name in (
                    "thin", "movie absorbed")):
                rows.append((f"{name}, {tag}, dop853", kind, args, al, th,
                             f"kerr_dop853_extras<{inst.format(real)}>"))
    return kerr, rows


def scene_method(label):
    """The embedded pair of an extras scene row, by its label."""
    return "dop853" if label.endswith(", dop853") else "dp45"


def scene_work(name, dtype):
    """One attempt's work (bounds.extras_work) of an extras scene's form,
    by its name in extras_scenes."""
    from light_path_tracer_tpu_torch.ops.cuda.bounds import extras_work
    words = name.split()
    kind = {"jet": "thin", "stokes": "stokes"}.get(words[0], words[0])
    width = next((int(w.split("-")[0]) for w in words[1:] if "-" in w),
                 {"spectral": 3, "movie": 8, "order": 3}.get(kind, 0))
    return extras_work(kind, width, "absorbed" in words[1:],
                       "jet" if words[0] == "jet" else "torus",
                       dtype=str(dtype).replace("torch.", ""),
                       method="dop853" if "dop853" in words else "dp45")


def extras_outputs(res, probe):
    """Every output of one call, flattened: the result's tensors (extras,
    final alpha, half-orbits, status, warp step sum), the flags and the
    per-ray attempts."""
    import torch
    out = []
    for v in res:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(v)
    return out + [probe["flags"], probe["attempts"]]


def extras_section(dev, X, parent, blocks, turns):
    import torch
    from chip_smoke import cuda_ms, ptxas_report, same_bits
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    builds = extras_builds(parent, blocks)
    mirrors = extras_mirrors(parent)
    kerr, scenes = extras_scenes(dev, X)
    report = dict(builds={}, scenes={})

    def use(name):
        lib = builds[name][0]
        return use_extras_build(lib, mirrors if name.startswith("parent")
                                else None)

    def runs(name):
        """The scene rows a build runs: its pair's."""
        d853 = name.endswith(":dop853")
        return [row for row in scenes
                if (scene_method(row[0]) == "dop853") == d853]

    for name, (lib, log, obj_dir) in builds.items():
        rows = {}
        for mangled_label, regs, spill in ptxas_report(log):
            rows[mangled_label] = dict(registers=regs, spill=spill)
        for label, count in trig_reductions(obj_dir).items():
            rows.setdefault(label, {})["trig_reductions"] = count
        if not name.startswith("parent"):
            method = "dop853" if name.endswith(":dop853") else "dp45"
            with use(name):
                for label, entry, form, variant, dtype in (
                        vk.extras_instances(method)):
                    rows.setdefault(label, {}).update(vk.describe_instance(
                        entry, form, variant, dtype, method))
        report["builds"][name] = rows
        for label, row in rows.items():
            if label.startswith(("kerr_dp45_extras", "kerr_dop853_extras")):
                print(f"  [{name}] {label}: {json.dumps(row)}", flush=True)
    want = {}
    names = list(builds)
    # One untimed turn first: the card settles its clocks and the
    # allocator its cache before any reading counts.
    for name in names:
        with use(name):
            for label, kind, args, al, th, _inst in runs(name):
                vol_call(kerr, kind, args, al, th,
                         method=scene_method(label))
    torch.cuda.synchronize()
    for turn in range(turns):
        order = names if turn % 2 == 0 else names[::-1]
        for name in order:
            with use(name):
                for label, kind, args, al, th, inst in runs(name):
                    def call(**kw):
                        return vol_call(kerr, kind, args, al, th,
                                        method=scene_method(label), **kw)
                    probe = {}
                    got = extras_outputs(call(probe=probe), probe)
                    if name.startswith("parent") and label not in want:
                        want[label] = got
                    ms, _ = cuda_ms(call, 3)
                    key = name.replace(":dop853", "")
                    row = report["scenes"].setdefault(label, dict(
                        instance=inst)).setdefault(key, dict(ms=[]))
                    row["ms"].append(ms)
                    if label in want:
                        row["bitwise_equal"] = row.get(
                            "bitwise_equal", True) and len(got) == len(
                                want[label]) and all(
                            same_bits(a, b) for a, b in zip(got,
                                                            want[label]))
                    print(f"turn {turn} [{name}] {label}: {ms:.3f} ms, "
                          f"bitwise {row.get('bitwise_equal')}",
                          flush=True)
    report["family_designs"] = family_designs(dev, X, builds, turns)
    # Both bounds of every scene, from its per-ray attempts (the same in
    # every build: the outputs are bitwise equal) and this card's rates.
    from light_path_tracer_tpu_torch.ops.cuda import bounds, peak_probe
    rates = peak_probe.measure_rates(dev)
    report["rates"] = rates
    for label, kind, args, al, _th, _inst in scenes:
        attempts = int(want[label][-1].sum())
        work = attempts * scene_work(
            label.split(", ")[0] + (" dop853" if scene_method(label) ==
                                    "dop853" else ""), al.dtype)
        n_aux = 0 if kind == "vol" else len(args[2])
        n_extras = (2 if args[1] is not None else 1) if kind == "vol" \
            else args[1]
        size = al.element_size()
        n_bytes = al.numel() * (size * (3 + n_aux + n_extras) + 9)
        report["scenes"][label].update(
            attempts=attempts,
            bound_ms=bounds.flops_bound_ms(work, n_bytes)[0],
            bound_counted_ms=bounds.counted_bound_ms(work, n_bytes,
                                                     rates)[0])
    for label, by in report["scenes"].items():
        summary = {name: dict(ms=float(np.median(r["ms"])),
                              bitwise_equal=r.get("bitwise_equal"))
                   for name, r in by.items() if isinstance(r, dict)}
        bound = {k: by[k] for k in ("attempts", "bound_ms",
                                    "bound_counted_ms")}
        print(f"extras {label} ({by['instance']}): {json.dumps(bound)} "
              f"{json.dumps(summary)}", flush=True)
    return report


def family_designs(dev, X, builds, turns):
    """The two designs of the extras kernel's Kerr-Newman flow on the
    1024^2 thin and movie-absorbed scenes with a = 0.6, Q = 0.6, float32:
    the package's template family (the *_kn instances of its "more"
    library) against the
    runtime-branch variant (the "runtime family" build's Kerr instances
    launched with the charge), in turns; each call timed by CUDA events
    (mean of 3 after a warm-up; the median over turns) and the two held
    bitwise. Returns {scene: {design: {ms, bitwise_equal}}}."""
    import torch
    from chip_smoke import cuda_ms, same_bits
    from light_path_tracer_tpu_torch.models import KerrNewman
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch import volumetric
    kn = KerrNewman(M=1.0, a=0.6, Q=0.6)
    al, th = X["vol"]
    R = volumetric.RIAFConfig
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(
        1.0, 0.6, 6.0, True, Q=0.6))
    times = tuple(period * k / 8 for k in range(8))
    rows = {"thin": ("vol", volumetric.make_transfer_fns(kn, R())),
            "movie absorbed": ("aux", (volumetric.make_movie_transfer(
                kn, R(spot_amp=8.0, alpha0=0.3), times), 10, (),
                tuple(range(2, 10))))}
    designs = {"template": (vk.load_library("more"), False),
               "runtime": (builds["runtime family"][0], True)}
    out = {}
    saved = vk.family_infix
    try:
        for turn in range(turns + 1):
            order = list(designs) if turn % 2 == 0 else list(designs)[::-1]
            for design in order:
                lib, runtime = designs[design]
                if runtime:
                    vk.family_infix = lambda _m: ""
                with use_extras_build(lib):
                    for name, (kind, args) in rows.items():
                        def call(**kw):
                            return vol_call(kn, kind, args, al, th, **kw)
                        probe = {}
                        got = extras_outputs(call(probe=probe), probe)
                        ms, _ = cuda_ms(call, 3)
                        if turn == 0:        # the untimed turn
                            out.setdefault(name, {})[design] = dict(
                                ms=[], got=got)
                            continue
                        row = out[name][design]
                        row["ms"].append(ms)
                vk.family_infix = saved
        torch.cuda.synchronize()
    finally:
        vk.family_infix = saved
    for name, by in out.items():
        same = all(same_bits(a, b) for a, b in zip(by["template"]["got"],
                                                   by["runtime"]["got"]))
        for design, row in by.items():
            row.pop("got")
            row["ms"] = float(np.median(row["ms"]))
            row["bitwise_equal_designs"] = same
        print(f"family design, {name} 1024^2 f32 Kerr-Newman: "
              f"{json.dumps(by)}", flush=True)
    return out


# KerrCall's fields that an earlier commit's kernel may not have, keyed by
# the word whose absence from its csrc/kerr_dp45.cu shows it: the metric
# family and its scalars, and the event interpolant (which took what was
# padding after the ints, so without it the float scalars start 4 bytes
# sooner).
NEWER_FIELDS = {"family": ("family", "q2", "r_pro", "eps3", "r_freeze"),
                "event_interp": ("event_interp",),
                "force_invalid": ("force_invalid", "chart")}


def kerr_builds(parent):
    """Build kerr_dp45.cu and kerr_dp45_f64.cu of the earlier commit's
    csrc/ (`parent`) and of the package, four nvcc processes at once, a
    library each, and kerr_dop853.cu and its f64 sibling likewise.
    Returns {build: ({"dp45": library, "dop853": library}, KerrCall
    mirrors or None)}: the earlier commit's mirrors drop the NEWER_FIELDS
    its source lacks."""
    import ctypes
    from pathlib import Path
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk

    def declare(lib, _name, d, library="dp45"):
        declare_kerr(lib, library)
        text = (d / "kerr_dp45.cu").read_text()
        drop = {f for word, fields in NEWER_FIELDS.items()
                if word not in text for f in fields}
        if not drop:
            return None
        return tuple(type(f"Old{c.__name__}", (ctypes.Structure,), {
            "_fields_": [f for f in kk._kerr_call_fields(real)
                         if f[0] not in drop]})
            for c, real in ((kk.KerrCall, ctypes.c_float),
                            (kk.KerrCall64, ctypes.c_double)))
    dirs = {"parent": Path(parent), "package": _build.CSRC}
    dp45 = parallel_builds("kerr_study", dirs, ("kerr_dp45",
                                                "kerr_dp45_f64"),
                           declare, jobs=4)
    dop853 = parallel_builds(
        "kerr_dop853_study", dirs, ("kerr_dop853", "kerr_dop853_f64"),
        lambda lib, n, d: declare(lib, n, d, "dop853"), jobs=4)
    return {name: (dict(dp45=lib, dop853=dop853[name][0]), mirrors)
            for name, (lib, _log, _out, mirrors) in dp45.items()}


class use_kerr_build:
    """Within the block the wrappers of ops/cuda/kerr_trace_kernel.py
    launch `build` (kerr_builds), through its own KerrCall mirrors."""

    def __init__(self, build):
        self.libs, self.mirrors = build

    def __enter__(self):
        from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel
        kk = self.kk = kerr_trace_kernel
        self.saved = (kk.load_library, kk.KerrCall, kk.KerrCall64,
                      kk.family_scalars)
        kk.load_library = lambda library="dp45": self.libs[library]
        if self.mirrors:
            kk.KerrCall, kk.KerrCall64 = self.mirrors
            names = {f for f, _t in kk.KerrCall._fields_}
            if "family" not in names:
                kk.family_scalars = lambda metric: {}

    def __exit__(self, *exc):
        (self.kk.load_library, self.kk.KerrCall, self.kk.KerrCall64,
         self.kk.family_scalars) = self.saved


def kerr_cases(dev, X):
    """label -> (fn(probe=None) -> outputs, profiler key): the Kerr
    shadow and disk calls of the kerr section."""
    import torch
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = Kerr(M=1.0, a=0.9)
    al, th, rf = X["main"]
    ga, gt = X["aligned"]
    rng = np.random.default_rng(8)
    f64 = dict(dtype=torch.float64, device=dev)
    ra = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f64)
    rt = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f64)
    cases = {}
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        cases[f"main path {tag}"] = (
            lambda a=al.to(dt), t=th.to(dt), **kw: kk.trace_rays_kerr_cuda(
                kerr, R_OBS, a, t, np.pi / 2, rf, LAMBDA_MAX, 200000, **kw))
        cases[f"config-4 aligned {tag}"] = (
            lambda a=ga.to(dt), t=gt.to(dt), **kw: kk.trace_disk_rays_cuda(
                kerr, R_OBS, a, t, THETA, LAMBDA_MAX, 200000, X["plane"], 2,
                **kw))
        for hits in (1, 2, 3, 4):
            for mom in (False, True):
                plane = X["plane"][:3] + (not mom,)
                cases[f"disk {hits} hits{' momenta' if mom else ''} "
                      f"4096 rays {tag}"] = (
                    lambda a=ra.to(dt), t=rt.to(dt), h=hits, m=mom,
                    pl=plane, **kw: kk.trace_disk_rays_cuda(
                        kerr, R_OBS, a, t, THETA, LAMBDA_MAX, 200000, pl, h,
                        record_momentum=m, **kw))
        # the DOP853 instances (the second library of each build)
        d = dict(method="dop853")
        cases[f"main path {tag} dop853"] = (
            lambda a=al.to(dt), t=th.to(dt), **kw: kk.trace_rays_kerr_cuda(
                kerr, R_OBS, a, t, np.pi / 2, rf, LAMBDA_MAX, 200000, **d,
                **kw))
        cases[f"config-4 aligned {tag} dop853"] = (
            lambda a=ga.to(dt), t=gt.to(dt), **kw: kk.trace_disk_rays_cuda(
                kerr, R_OBS, a, t, THETA, LAMBDA_MAX, 200000, X["plane"], 2,
                **d, **kw))
        for mom in (False, True):
            plane = X["plane"][:3] + (not mom,)
            cases[f"disk 2 hits{' momenta' if mom else ''} 4096 rays {tag}"
                  f" dop853"] = (
                lambda a=ra.to(dt), t=rt.to(dt), m=mom, pl=plane,
                **kw: kk.trace_disk_rays_cuda(
                    kerr, R_OBS, a, t, THETA, LAMBDA_MAX, 200000, pl, 2,
                    record_momentum=m, **d, **kw))
    return cases


def flat_outputs(res, probe):
    return [y for x in res for y in (x if isinstance(x, tuple) else (x,))
            ] + [probe["state"], probe["attempts"], probe["raw_status"]]


def kerr_section(dev, X, parent, turns):
    import torch
    from chip_smoke import cuda_ms, kernel_alone_ms, same_bits
    from light_path_tracer_tpu_torch.models import (JohannsenPsaltis,
                                                    KerrNewman)
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    builds = kerr_builds(parent)
    cases = kerr_cases(dev, X)
    names = list(builds)
    report = dict(cases={})
    want = {}
    for name in names:                     # one untimed turn
        with use_kerr_build(builds[name]):
            for fn in cases.values():
                fn()
    torch.cuda.synchronize()
    for turn in range(turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            with use_kerr_build(builds[name]):
                for label, fn in cases.items():
                    probe = {}
                    got = flat_outputs(fn(probe=probe), probe)
                    if name == "parent" and label not in want:
                        want[label] = got
                    ms, _ = cuda_ms(fn, 3)
                    row = report["cases"].setdefault(label, {}).setdefault(
                        name, dict(ms=[], kernel_ms=[]))
                    row["ms"].append(ms)
                    if label.startswith(("main", "config-4")):
                        row["kernel_ms"].append(kernel_alone_ms(fn, 3))
                    if label in want:
                        row["bitwise_equal"] = row.get(
                            "bitwise_equal", True) and len(got) == len(
                                want[label]) and all(
                            same_bits(a, b) for a, b in zip(
                                got, want[label]))
                    print(f"turn {turn} [{name}] {label}: {ms:.3f} ms, "
                          f"bitwise {row.get('bitwise_equal')}", flush=True)
    # The other families' shadow instances on the main path's rays, in
    # the package's build only.
    al, th, rf = X["main"]
    for metric in (KerrNewman(M=1.0, a=0.6, Q=0.6),
                   JohannsenPsaltis(M=1.0, a=0.9, eps3=2.0)):
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            def fn(a=al.to(dt), t=th.to(dt), m=metric, **kw):
                return kk.trace_rays_kerr_cuda(m, R_OBS, a, t, np.pi / 2, rf,
                                               LAMBDA_MAX, 200000, **kw)
            rows = dict(ms=[cuda_ms(fn, 3)[0] for _ in range(turns)],
                        kernel_ms=[kernel_alone_ms(fn, 3)
                                   for _ in range(turns)])
            label = f"{type(metric).__name__} main path {tag}"
            report["cases"][label] = dict(package=rows)
            print(f"{label}: {json.dumps(rows)}", flush=True)
    # The mu chart's instances on the main path's rays, with the hybrid's
    # poison mask (the package's full build: its mu entries).
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    for metric in (Kerr(M=1.0, a=0.9), KerrNewman(M=1.0, a=0.6, Q=0.6)):
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            a32, t32 = al.to(dt), th.to(dt)
            poison = tk.hybrid_poison(metric, R_OBS, a32, t32, np.pi / 2,
                                      tk.hybrid_slots(a32.numel()))
            for method in ("dp45", "dop853"):
                def fn(a=a32, t=t32, m=metric, p=poison, me=method, **kw):
                    return kk.trace_rays_kerr_cuda(
                        m, R_OBS, a, t, np.pi / 2, rf, LAMBDA_MAX, 200000,
                        formulation="mu", force_invalid=p, method=me, **kw)
                rows = dict(ms=[cuda_ms(fn, 3)[0] for _ in range(turns)],
                            kernel_ms=[kernel_alone_ms(fn, 3)
                                       for _ in range(turns)])
                label = (f"{type(metric).__name__} mu main path {tag}"
                         f"{' dop853' if method == 'dop853' else ''}")
                report["cases"][label] = dict(package=rows)
                print(f"{label}: {json.dumps(rows)}", flush=True)
    for label, by in report["cases"].items():
        summary = {name: dict(
            ms=float(np.median(r["ms"])),
            kernel_ms=(float(np.median(r["kernel_ms"]))
                       if r.get("kernel_ms") else r.get("kernel_ms")),
            bitwise_equal=r.get("bitwise_equal")) for name, r in by.items()}
        by["summary"] = summary
        print(f"kerr {label}: {json.dumps(summary)}", flush=True)
    return report


PLANES_SOURCES = ("kerr_dp45_planes", "kerr_dp45_planes_f64",
                  "kerr_dop853_planes", "kerr_dop853_planes_f64")


def planes_builds(parent):
    """Build PLANES_SOURCES of the earlier commit's csrc/ (`parent`) and
    of the package into a library each; print each instance's ptxas
    figures. Returns {build: library}."""
    from pathlib import Path
    from chip_smoke import ptxas_report
    from light_path_tracer_tpu_torch.ops.cuda import _build

    def declare(lib, _name, _d):
        for suffix in ("", "_f64", "_dop853", "_dop853_f64"):
            fn = getattr(lib, _build.PLANES_ENTRY + suffix)
            fn.argtypes = [_build._P, _build._P]
            fn.restype = _build._I
    dirs = {"parent": Path(parent), "package": _build.CSRC}
    builds = parallel_builds("planes_study", dirs, PLANES_SOURCES, declare,
                             jobs=8)
    for name, (_lib, log, _out, _d) in builds.items():
        for kname, regs, spill in ptxas_report(log):
            print(f"  ptxas [{name}]: {kname}: {regs} registers; {spill}",
                  flush=True)
    return {name: lib for name, (lib, _log, _out, _d) in builds.items()}


class use_planes_build:
    """Within the block the plane-recorder launches of
    ops/cuda/kerr_trace_kernel.py go to `lib` (planes_builds)."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel
        self.kk = kerr_trace_kernel
        self.saved = self.kk.load_library
        self.kk.load_library = lambda library="dp45": self.lib

    def __exit__(self, *exc):
        self.kk.load_library = self.saved


def planes_cases(dev):
    """label -> fn(probe=None) -> a tuple of DiskTraceResult: the planes
    section's calls."""
    import torch
    import chip_smoke as cs
    from light_path_tracer_tpu_torch import camera
    dim = (1024, 1024)
    fov = camera.fov_from_vertical(cs.p24_scene().vertical_fov, dim)
    f32 = dict(dtype=torch.float32, device=dev)
    al4 = camera.build_alpha_lookup(dim, fov, **f32).reshape(-1)
    th4 = camera.build_theta_lookup(dim, fov, **f32).reshape(-1)
    rng = np.random.default_rng(25)
    ra = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    rt = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    cases = {}
    for name in cs.P25_SETS:
        for method in ("dp45", "dop853"):
            cases[f"1024^2 grid {method} float32 kerr {name}"] = (
                lambda n=name, m=method, **kw: cs.p25_trace(
                    "kerr", al4, th4, n, m, max_steps=cs.GRID_STEPS, **kw))
        for method, dtype, family in cs.P25_INSTANCES:
            dt = getattr(torch, dtype)
            cases[f"4096 rays {method} {dtype} {family} {name}"] = (
                lambda n=name, m=method, f=family, a=ra.to(dt), t=rt.to(dt),
                **kw: cs.p25_trace(f, a, t, n, m, **kw))
    return cases


def planes_outputs(res, probe):
    import chip_smoke as cs
    return [x for plane in res for _n, x in cs.p25_fields(plane)] + [
        probe["attempts"], probe["accepted"]]


def planes_section(dev, parent, turns):
    import torch
    from chip_smoke import kernel_alone_ms, same_bits
    builds = planes_builds(parent)
    cases = planes_cases(dev)
    names = list(builds)
    report = dict(cases={})
    want = {}
    for name in names:                     # one untimed turn
        with use_planes_build(builds[name]):
            for fn in cases.values():
                fn()
    torch.cuda.synchronize()
    for turn in range(turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            with use_planes_build(builds[name]):
                for label, fn in cases.items():
                    probe = {}
                    got = planes_outputs(fn(probe=probe), probe)
                    if name == "parent" and label not in want:
                        want[label] = got
                    row = report["cases"].setdefault(label, {}).setdefault(
                        name, dict(kernel_ms=[]))
                    row["kernel_ms"].append(kernel_alone_ms(fn, 3))
                    if label in want:
                        row["bitwise_equal"] = row.get(
                            "bitwise_equal", True) and len(got) == len(
                                want[label]) and all(
                            same_bits(a, b) for a, b in zip(
                                got, want[label]))
                    print(f"turn {turn} [{name}] {label}: "
                          f"{row['kernel_ms'][-1]:.3f} ms, bitwise "
                          f"{row.get('bitwise_equal')}", flush=True)
    for label, by in report["cases"].items():
        summary = {name: dict(kernel_ms=float(np.median(r["kernel_ms"])),
                              bitwise_equal=r.get("bitwise_equal"))
                   for name, r in by.items()}
        by["summary"] = summary
        print(f"planes {label}: {json.dumps(summary)}", flush=True)
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_study: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--turns", type=int, default=4)
    parser.add_argument("--sections", default="ab,rays,main,regs")
    parser.add_argument("--blocks", default="7,0")
    parser.add_argument("--parent", default=None,
                        help="the earlier commit's csrc/ (extras, kerr and "
                             "planes sections)")
    parser.add_argument("--extras-blocks", default="",
                        help="block bounds to build every extras instance "
                             "with, comma separated (extras section)")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    builds = Builds()
    X = inputs(dev)
    report = dict(card=card, build_s=builds.build_s)
    sections = args.sections.split(",")
    if "main" in sections:
        report["main"] = main_section(dev, builds, X)
    if "rays" in sections:
        report["rays"] = rays_section(dev, builds, X)
    if "ab" in sections:
        report["ab"] = ab_section(dev, builds, X, args.turns)
    if "regs" in sections:
        report["regs"] = regs_section(
            dev, builds, X, [int(b) for b in args.blocks.split(",")])
    if "extras" in sections:
        if not args.parent:
            parser.error("the extras section needs --parent")
        blocks = [int(b) for b in args.extras_blocks.split(",") if b]
        report["extras"] = extras_section(dev, X, args.parent, blocks,
                                          args.turns)
    if "kerr" in sections:
        if not args.parent:
            parser.error("the kerr section needs --parent")
        report["kerr"] = kerr_section(dev, X, args.parent, args.turns)
    if "planes" in sections:
        if not args.parent:
            parser.error("the planes section needs --parent")
        report["planes"] = planes_section(dev, args.parent, args.turns)
    print(f"builds (s): {json.dumps(builds.build_s)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
