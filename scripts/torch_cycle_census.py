#!/usr/bin/env python3
"""Census of the frozen lanes of the port's ray kernels, on one GPU.

  python3 scripts/torch_cycle_census.py [--out census.json]

A lane whose state stops changing bitwise either sits in an exact cycle
of (step size, lambda), which the kernels end at once (the exact-cycle
exit, csrc/kerr_dp45_common.cuh CycleWatch), or stays frozen while
lambda still moves, or grinds without freezing at all. For each grid
below the script runs the kernel once with the exit off and once with it
on, and prints per grid:
  * the lanes by kind: exact cycle (with the periods seen), frozen with
    a moving lambda, frozen without a repeat, ground (>= 1,000 attempts)
    without freezing; the exits' counts and the slowest lanes;
  * whether the two runs agree bitwise on every output (state or
    extras, status, final alpha, half-orbits, flags, per-ray attempts,
    warp step sum), and both kernel times (CUDA events, one launch).
Grids: the config-4 thin-disk grids at 1024^2 (aligned and offset by a
quarter pixel; theta_obs 80 deg, FOV 40 deg), the 1024^2 Kerr a=0.9
shadow of the main path, the volumetric scene (theta_obs 80 deg, FOV 16
deg) at 1024^2 and 256^2 for the thin, absorbed, jet, 3-band, Stokes,
movie (thin and absorbed) and order (thin and absorbed) forms of
chip_smoke.py's phases 12-14 at sat_window 2,048, and the 256^2 order
decomposition's lane (171, 129).

Then config 4's ray (row 959, col 511 of the aligned grid) in the plain
loop on the CPU, in the kernel as the package builds it (-fmad=false: no
contraction of a*b + c into FMA) and in the kernel built with nvcc's
default contraction (where it froze in a period-1 cycle, while JAX and
the plain loop escape in 51 attempts): each prints the ray's attempts,
status and census. Exit code 0 iff every grid agreed bitwise.
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
sys.path.insert(0, REPO)

R_OBS = 100.0
LAMBDA_MAX = 5000.0
THETA = float(np.radians(80.0))
RAY = (959, 511)

def decode(census):
    """(period, final frozen streak, lambda moved) per lane."""
    c = census.cpu().numpy().astype(np.int64)
    return (c >> 21) & 1023, c & 0xFFFFF, (c >> 20) & 1


def kinds(attempts, census, flags=None):
    """The lanes by kind, from a run with the exit off."""
    period, streak, moved = decode(census)
    att = attempts.cpu().numpy()
    frozen = (period == 0) & (streak >= 64)
    row = dict(
        lanes=int(att.size), attempts_mean=float(att.mean()),
        attempts_max=int(att.max()),
        exact_cycle=int((period > 0).sum()),
        periods={int(p): int((period == p).sum())
                 for p in np.unique(period[period > 0])},
        frozen_moving_lambda=int((frozen & (moved == 1)).sum()),
        frozen_no_repeat=int((frozen & (moved == 0)).sum()),
        ground_not_frozen=int(((att >= 1000) & (period == 0)
                               & (streak < 64)).sum()))
    if flags is not None:
        fl = flags.cpu().numpy()
        row.update(saturation_exits=int(((fl & 2) != 0).sum()),
                   frozen_exits=int(((fl & 4) != 0).sum()))
    return row


def slowest(attempts, census, width, k=5):
    att = attempts.cpu().numpy()
    period, streak, moved = decode(census)
    return [dict(row=int(i // width), col=int(i % width),
                 attempts=int(att[i]), period=int(period[i]),
                 final_streak=int(streak[i]), lambda_moved=int(moved[i]))
            for i in np.argsort(att)[-k:][::-1]]


def both(run, fields, width):
    """run(cycle_exit, probe) -> result; returns the census row."""
    from chip_smoke import cuda_ms, same_bits
    p_off, p_on = {}, {}
    ms_off, off = cuda_ms(lambda: run(False, p_off), 1)
    ms_on, on = cuda_ms(lambda: run(True, p_on), 1)
    pairs = [(x, y) for x, y in zip(fields(off), fields(on))]
    pairs.append((p_off["attempts"], p_on["attempts"]))
    if "flags" in p_off:
        pairs.append((p_off["flags"], p_on["flags"]))
    row = kinds(p_off["attempts"], p_off["cycles"], p_off.get("flags"))
    row.update(bitwise_equal=all(same_bits(x, y) for x, y in pairs),
               ms_exit_off=ms_off, ms_exit_on=ms_on,
               attempts_max_exit_on=int(p_on["attempts"].max()),
               slowest=slowest(p_off["attempts"], p_off["cycles"], width))
    return row


def census(dev):
    import torch
    from light_path_tracer_tpu_torch import camera, disk, volumetric
    from light_path_tracer_tpu_torch import polarization
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.pipeline import trace_inputs
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)

    kerr = Kerr(M=1.0, a=0.9)
    f32 = dict(dtype=torch.float32, device=dev)
    rows = {}
    dim = (1024, 1024)
    fov40 = camera.fov_from_vertical(np.radians(40.0), dim)
    plane = (disk.r_isco(1.0, 0.9), disk.DiskConfig().r_out,
             float(np.pi / 2), True)
    for label, off in (("config-4 disk 1024^2 aligned", (0.0, 0.0)),
                       ("config-4 disk 1024^2 quarter-offset",
                        (0.25, 0.25))):
        al = camera.build_alpha_lookup(dim, fov40, pixel_offset=off,
                                       **f32).reshape(-1)
        th = camera.build_theta_lookup(dim, fov40, pixel_offset=off,
                                       **f32).reshape(-1)
        rows[label] = both(
            lambda ce, pr: kk.trace_disk_rays_cuda(
                kerr, R_OBS, al, th, THETA, LAMBDA_MAX, 200000, plane, 2,
                probe=pr, _cycle_exit=ce),
            lambda r: (r.status, r.n_hits, r.final_alpha, r.n_half, r.xi,
                       r.n_steps, *r.r_hits, *r.phi_hits), dim[1])
        print(f"{label}: {json.dumps(rows[label])}", flush=True)
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=R_OBS)
    fov = camera.fov_from_vertical(scene.vertical_fov, dim)
    al, th, rf, _rows = trace_inputs(scene, RenderConfig(), dim, fov, dev)
    rows["Kerr shadow 1024^2"] = both(
        lambda ce, pr: kk.trace_rays_kerr_cuda(
            kerr, R_OBS, al, th, np.pi / 2, rf, LAMBDA_MAX, 200000,
            probe=pr, _cycle_exit=ce),
        lambda r: tuple(r), dim[1])
    print(f"Kerr shadow 1024^2: {json.dumps(rows['Kerr shadow 1024^2'])}",
          flush=True)

    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                          True))
    times = tuple(period * k / 8 for k in range(8))
    R = volumetric.RIAFConfig
    for side in (1024, 256):
        d = (side, side)
        fov = camera.fov_from_vertical(np.radians(16.0), d)
        al = camera.build_alpha_lookup(d, fov, **f32).reshape(-1)
        th = camera.build_theta_lookup(d, fov, **f32).reshape(-1)
        aux = polarization.camera_constants(kerr, R_OBS, THETA, al, th)
        forms = {}
        for name, riaf in (("thin", R()), ("absorbed", R(alpha0=0.3)),
                           ("jet", R(profile="jet", jet_beta=0.6,
                                     index=-1.0))):
            em, ab = volumetric.make_transfer_fns(kerr, riaf)
            forms[name] = ("vol", em, ab)
        forms["spectral 3-band"] = ("aux", volumetric.make_spectral_transfer(
            kerr, R(g_power=4.0, alpha0=1.0, opacity_index=3.0),
            (0.1, 1.0, 10.0)), 4, (), (1, 2, 3))
        forms["stokes toroidal"] = (
            "aux", polarization.make_polarized_volumetric_transfer(
                kerr, R(), "toroidal", 0.7), 3, aux, (0, 1, 2))
        for a0, tag in ((0.0, "thin"), (0.3, "absorbed")):
            ab = int(a0 > 0)
            forms[f"movie {tag}"] = (
                "aux", volumetric.make_movie_transfer(
                    kerr, R(spot_amp=8.0, alpha0=a0), times), 9 + ab, (),
                tuple(range(1 + ab, 9 + ab)))
            forms[f"order {tag}"] = (
                "aux", volumetric.make_order_transfer(kerr, R(alpha0=a0), 3),
                4 + ab, (), tuple(range(1 + ab, 4 + ab)))
        for name, form in forms.items():
            if form[0] == "vol":
                _k, em, ab = form

                def run(ce, pr):
                    return vk.trace_rays_volumetric_cuda(
                        kerr, R_OBS, al, th, THETA, em, LAMBDA_MAX, 200000,
                        absorption_fn=ab, sat_window=2048, probe=pr,
                        _cycle_exit=ce)

                def fields(r):
                    return (r.emission, r.optical_depth, r.final_alpha,
                            r.status, r.n_half_orbits, r.n_steps)
            else:
                _k, tf, n_extras, ax, mon = form

                def run(ce, pr):
                    return vk.trace_rays_aux_cuda(
                        kerr, R_OBS, al, th, THETA, tf, n_extras, ax,
                        LAMBDA_MAX, 200000, sat_window=2048,
                        sat_monitor=mon, probe=pr, _cycle_exit=ce)

                def fields(r):
                    return (*r.extras, r.final_alpha, r.status,
                            r.n_half_orbits, r.n_steps)
            label = f"volumetric {side}^2 {name}"
            rows[label] = both(run, fields, side)
            print(f"{label}: {json.dumps(rows[label])}", flush=True)
            if side == 256 and name == "order thin":
                lane = 171 * side + 129
                sl = slice(lane, lane + 1)
                pr = {}
                vk.trace_rays_aux_cuda(
                    kerr, R_OBS, al[sl], th[sl], THETA, tf, n_extras, (),
                    LAMBDA_MAX, 200000, sat_window=2048, sat_monitor=mon,
                    probe=pr, _cycle_exit=False)
                p, s, m = decode(pr["cycles"])
                rows["lane (171, 129)"] = dict(
                    attempts=int(pr["attempts"][0]),
                    flags=int(pr["flags"][0]), period=int(p[0]),
                    final_streak=int(s[0]), lambda_moved=int(m[0]))
                print(f"256^2 order lane (171, 129): "
                      f"{json.dumps(rows['lane (171, 129)'])}", flush=True)
        del al, th, aux
    return rows


def ray_run(dev, tag):
    """The config-4 ray RAY through this tree's disk kernel."""
    import torch
    from light_path_tracer_tpu_torch import camera, disk
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel as kk
    kerr = Kerr(M=1.0, a=0.9)
    dim = (1024, 1024)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    i = RAY[0] * dim[1] + RAY[1]
    args = dict(dtype=torch.float32, device=dev)
    al = camera.build_alpha_lookup(dim, fov, **args).reshape(-1)[i:i + 1]
    th = camera.build_theta_lookup(dim, fov, **args).reshape(-1)[i:i + 1]
    plane = (disk.r_isco(1.0, 0.9), disk.DiskConfig().r_out,
             float(np.pi / 2), True)
    pr = {}
    res = kk.trace_disk_rays_cuda(kerr, R_OBS, al, th, THETA, LAMBDA_MAX,
                                  200000, plane, 2, probe=pr,
                                  _cycle_exit=False)
    p, s, m = decode(pr["cycles"])
    row = dict(variant=tag, attempts=int(pr["attempts"][0]),
               status=int(res.status[0]), n_hits=int(res.n_hits[0]),
               r_hit=float(res.r_hits[0][0]), period=int(p[0]),
               final_streak=int(s[0]), lambda_moved=int(m[0]))
    return row, al.cpu(), th.cpu()


def contracted_ray(dev):
    """RAY through the disk kernel built as nvcc builds by default, with
    a*b + c contracted into FMA (the package's -fmad=false taken out):
    only kerr_dp45.cu, into its own library."""
    from light_path_tracer_tpu_torch.ops.cuda import _build
    saved = _build.NVCC_FLAGS, _build._sources, _build._declare
    csrc = _build.CSRC

    def declare(lib, _library="dp45"):
        lib.lpt_kerr_dp45.argtypes = [_build._P, _build._I]
        lib.lpt_kerr_dp45.restype = _build._I
        lib.lpt_cuda_error_string.argtypes = [_build._I]
        lib.lpt_cuda_error_string.restype = _build.ctypes.c_char_p
        return lib
    try:
        _build.NVCC_FLAGS = tuple(f for f in saved[0] if f != "-fmad=false")
        _build._sources = lambda _library="dp45": [csrc / "kerr_dp45.cu"]
        _build._declare = declare
        _build.load_library.cache_clear()
        row, _al, _th = ray_run(dev, "kernel built with contraction "
                                     "(nvcc's default)")
    finally:
        _build.NVCC_FLAGS, _build._sources, _build._declare = saved
        _build.load_library.cache_clear()
    return row


def diagnose(dev):
    """The ray in this tree's kernel, the plain loop on the CPU and the
    kernel built with contraction."""
    from light_path_tracer_tpu_torch import disk
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    row, al, th = ray_run(dev, "kernel (no contraction)")
    rows = [row]
    kerr = Kerr(M=1.0, a=0.9)
    plane = (disk.r_isco(1.0, 0.9), disk.DiskConfig().r_out,
             float(np.pi / 2), True)
    res = kerr_trace.trace_disk_rays_kerr(kerr, R_OBS, al, th, THETA,
                                          LAMBDA_MAX, 200000, plane, 2)
    rows.append(dict(variant="plain loop on the CPU",
                     attempts=int(res.n_steps), status=int(res.status[0]),
                     n_hits=int(res.n_hits[0]),
                     r_hit=float(res.r_hits[0][0])))
    rows.append(contracted_ray(dev))
    for r in rows:
        print(f"ray {RAY}: {json.dumps(r)}", flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_cycle_census: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    from light_path_tracer_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    from chip_smoke import ptxas_report
    for name, regs, spill in ptxas_report(lib.build_log):
        print(f"  ptxas: {name}: {regs} registers; {spill}", flush=True)
    rows = census(dev)
    ray = diagnose(dev)
    ok = all(r.get("bitwise_equal", True) for r in rows.values())
    report = dict(card=card, grids=rows, ray=ray, bitwise_ok=ok)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"census: every grid bitwise equal with the exit on and off: "
          f"{ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
