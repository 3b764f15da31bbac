#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds the Kerr DP45 kernel
against its plain PyTorch version on the card, drives the main path (the
1024^2 Kerr a=0.9 shadow through render_shadow) and checks the image.
Phases:
  1. machine: card name and power limit, torch and nvcc versions;
  2. build: nvcc for sm_90a, with the build time;
  3. kernel vs plain version: 4,096 random rays (status agreement > 0.99,
     p99 |d final_alpha| < 2e-3 on stable escaped rays), a 128^2 image
     (shadow masks agree on >= 99.5% of pixels), and the main path's
     524,288 rays at 1024^2 (same gates), each with both times;
  4. main path: render_shadow once to warm up and 3 more times; the kernel
     launch counter must grow and the plain loop's stay at 0; the shadow
     must be the Kerr D inside the alpha_crit circle.
The second-to-last line is a JSON object of per-kernel results, the last
{"ok": true, "device": {...}}. Exit code 0 iff every phase passed; without
a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

R_OBS = 100.0
LAMBDA_MAX = 5000.0
GATE_STEPS = 20000
KERNEL_SOURCE = "light_path_tracer_tpu_torch/csrc/kerr_dp45.cu"
REPLACES = "light_path_tracer_tpu/ops/pallas/kerr_trace_kernel.py:40"


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
    cmp.update(ms=ms, plain_ms=plain_ms, n=int(alphas.numel()),
               n_steps_kernel=int(rk.n_steps), n_steps_plain=int(rp.n_steps))
    print(f"  {label}: {json.dumps(cmp)}", flush=True)
    torch.cuda.synchronize()
    return cmp


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import kerr_trace_kernel
    from light_path_tracer_tpu_torch.pipeline import (render_shadow,
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
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

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

    print(json.dumps({"kernels": [{
        "name": "kerr_dp45", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": gmain["max_abs"], "ms": gmain["ms"],
        "plain_ms": gmain["plain_ms"]}]}), flush=True)
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
