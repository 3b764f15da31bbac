#!/usr/bin/env python
"""Where a frame's time goes in the PyTorch/CUDA port, by torch.profiler.

  python scripts/torch_profile_paths.py [--size 1024] [--frames 3]
                                        [--paths polarized,movie,...]

Renders each path through its entry point on one NVIDIA GPU (the Kerr
a = 0.9 shadow of the main path and config 4's thin disk, then the scenes
of scripts/newmodes_bench.py: a = 0.9, r_obs 100 M, theta_obs 80 deg, FOV
16 deg), three warm-up frames and then `--frames` frames under
torch.profiler, and prints one JSON line per path: wall ms per frame
(profiler included), device ms per frame (the sum of the kernels' and
copies' device time), the ray kernel's ms and share, launches per frame
(all device kernels / ray-kernel launches), device-to-host copy ms and the
device's busy share of the wall time. The first line is the card's name
and power limit. Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def paths(size):
    from light_path_tracer_tpu_torch import disk, pipeline, polarization
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.utils.config import (RenderConfig,
                                                          SceneConfig)
    shadow = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0)
    thin_disk = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                            theta_obs=float(np.radians(80.0)))
    scene = SceneConfig(M=1.0, a=0.9, r_obs_mult=100.0,
                        theta_obs=float(np.radians(80.0)),
                        vertical_fov_deg=16.0)
    cfg = RenderConfig()
    dim = (size, size)
    period = 2.0 * np.pi / abs(volumetric.keplerian_omega(1.0, 0.9, 6.0,
                                                           True))
    times = tuple(period * k / 8 for k in range(8))
    riaf = volumetric.RIAFConfig
    return {
        "shadow": lambda: pipeline.render_shadow(shadow, dim, cfg,
                                                 device="cuda"),
        "disk": lambda: disk.render_disk(thin_disk, dim, cfg,
                                         disk.DiskConfig(), device="cuda"),
        "thin": lambda: volumetric.render_volumetric(scene, dim, cfg, riaf()),
        "spectral": lambda: volumetric.render_volumetric_spectrum(
            scene, dim, (0.1, 1.0, 10.0), cfg,
            riaf(g_power=4.0, alpha0=1.0, opacity_index=3.0)),
        "polarized": lambda: polarization.render_polarized_volumetric(
            scene, dim, cfg, riaf()),
        "movie": lambda: volumetric.render_volumetric_movie(
            scene, dim, times, cfg, riaf(spot_amp=8.0)),
        "movie_absorbed": lambda: volumetric.render_volumetric_movie(
            scene, dim, times, cfg, riaf(spot_amp=8.0, alpha0=0.3)),
        "decomposed": lambda: volumetric.render_volumetric_decomposed(
            scene, dim, cfg, riaf(), n_orders=3)}


def profile(render, frames):
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for _ in range(3):
        render()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3 / frames
    device_us = ray_us = dtoh_us = 0.0
    launches = ray_launches = 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or getattr(
            ev, "cuda_time_total", 0.0)
        if ev.device_type.name != "CUDA" or us <= 0.0:
            continue
        device_us += us
        if "Memcpy DtoH" in ev.key:
            dtoh_us += us
        elif "Memcpy" not in ev.key and "Memset" not in ev.key:
            launches += ev.count
        if "kerr_dp45" in ev.key:
            ray_us += us
            ray_launches += ev.count
    device_ms = device_us / 1e3 / frames
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                ray_kernel_ms=ray_us / 1e3 / frames,
                ray_kernel_share=ray_us / max(device_us, 1e-9),
                launches=launches / frames,
                ray_kernel_launches=ray_launches / frames,
                dtoh_ms=dtoh_us / 1e3 / frames,
                device_busy=device_ms / wall_ms)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("--paths", default="")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_paths needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    # The profiler's first use pays its own start-up: spend it here.
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1.0)
    torch.cuda.synchronize()
    table = paths(args.size)
    wanted = [p for p in args.paths.split(",") if p] or list(table)
    for name in wanted:
        row = profile(table[name], args.frames)
        print(json.dumps({"path": name, "size": args.size, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
