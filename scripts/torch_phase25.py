#!/usr/bin/env python3
"""chip_smoke.py's phase 25 alone on one NVIDIA GPU, after the Stokes
extras instances against their plain loop.

  python3 scripts/torch_phase25.py

Builds the three kernel libraries side by side, holds each Stokes
instance (two fields, float32 and float64, DP45 and DOP853; 4,096 random
rays, the saturation exits at 512, capped at 1,500) against the plain
loop on the card bit for bit (status, final alpha, I, Q, U), then runs
chip_smoke.tilted_phase on 4,096 random disk rays (phase 8's) with its
PlainPool children, and prints its kernels-line entry. Exits 1 if a
gate of the phase fails (chip_smoke.SmokeFailure).
"""

import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import numpy as np
    import torch
    import chip_smoke as cs
    from light_path_tracer_tpu_torch import polarization, volumetric
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    from light_path_tracer_tpu_torch.ops.cuda import _build
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    from light_path_tracer_tpu_torch.utils.config import RenderConfig
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    print(card, flush=True)
    builds = [threading.Thread(target=_build.load_library, args=(name,))
              for name in ("dp45", "more", "dop853")]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    print(f"builds done {time.perf_counter() - t0:.1f} s", flush=True)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    al_d = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    th_d = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    kerr = Kerr(M=1.0, a=0.9)
    alv = torch.tensor(rng.uniform(0.0, 0.25, 4096), **f32)
    thv = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    aux = polarization.camera_constants(kerr, cs.R_OBS, cs.THETA_VOL, alv,
                                        thv)
    ok = True
    for field in ("toroidal", "vertical"):
        fn = polarization.make_polarized_volumetric_transfer(
            kerr, volumetric.RIAFConfig(), field, cs.P0)
        for dtype in (torch.float32, torch.float64):
            for method in ("dp45", "dop853"):
                al, th = alv.to(dtype), thv.to(dtype)
                ax = tuple(x.to(dtype) for x in aux)
                args = (kerr, cs.R_OBS, al, th, cs.THETA_VOL, fn, 3, ax,
                        cs.LAMBDA_MAX, 1500)
                kw = dict(method=method, sat_window=512,
                          sat_monitor=(0, 1, 2))
                a = vk.trace_rays_aux_cuda(*args, **kw)
                b = tk.trace_rays_aux(*args, **kw)
                same = [cs.same_bits(x, y) for x, y in zip(
                    a.extras + (a.status, a.final_alpha),
                    b.extras + (b.status, b.final_alpha))]
                ok = ok and all(same)
                print(f"stokes {field} {dtype} {method}: bitwise {same}",
                      flush=True)
    pool = cs.PlainPool()
    try:
        entry = cs.tilted_phase(dev, card, pool, dict(
            disk_rays=(al_d, th_d), cfg=RenderConfig()))
        print(json.dumps(entry), flush=True)
    except cs.SmokeFailure as exc:
        print(f"phase 25 FAILED: {exc}", file=sys.stderr, flush=True)
        ok = False
    finally:
        pool.close()
        cs.PlainPool.stop_all()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0 if ok else 1)
