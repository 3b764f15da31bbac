#!/usr/bin/env python3
"""What building without FMA contraction costs and changes, and where the
main path's Kerr kernel loses its time, on one NVIDIA GPU.

  python3 scripts/torch_kernel_study.py [--out study.json] [--turns 4]
                                        [--sections ab,rays,main,regs]
                                        [--blocks 7,0]

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
    from chip_smoke import (ORBIT_STEP_FLOPS, PEAK_FP32, PEAK_FP64,
                            attempt_flops, form_flops)
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

    def declare(lib):
        for suffix in ("", "_f64"):
            fn = getattr(lib, "lpt_kerr_dp45" + suffix)
            fn.argtypes = [_build._P, _build._I]
            fn.restype = _build._I
        lib.lpt_cuda_error_string.argtypes = [_build._I]
        lib.lpt_cuda_error_string.restype = _build.ctypes.c_char_p
        return lib
    _build.CSRC = tmp
    _build._sources = lambda: [tmp / "kerr_dp45.cu", tmp / "kerr_dp45_f64.cu"]
    _build._declare = declare
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
    print(f"builds (s): {json.dumps(builds.build_s)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
