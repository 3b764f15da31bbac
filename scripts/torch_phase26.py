#!/usr/bin/env python3
"""chip_smoke.py's phase 26 alone on one NVIDIA GPU: the broad extras
and plane-recorder instances (spectra, movies and order decompositions of
any width; any number of disk planes and slots).

  python3 scripts/torch_phase26.py

Builds the "dp45" and "more" kernel libraries side by side and the
"broad" one in a child at nice 19 (as the smoke does), then runs
chip_smoke.queue_phase26_grids (the plain loops at the main paths' 1024^2
shapes), chip_smoke.queue_phase26 and chip_smoke.broad_phase on phase
8's 4,096 random disk rays (seed 0) with their PlainPool children, and
prints the phase's kernels-line entries. Exits 1 if a gate of the phase
fails (chip_smoke.SmokeFailure).
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
    from light_path_tracer_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    print(card, flush=True)
    broad = cs.background_build("broad")
    builds = [threading.Thread(target=_build.load_library, args=(name,))
              for name in ("dp45", "more")]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    print(f"dp45 and more built: {time.perf_counter() - t0:.1f} s",
          flush=True)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    al_d = torch.tensor(rng.uniform(0.01, 0.12, 4096), **f32)
    th_d = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **f32)
    pool = cs.PlainPool()
    code = 0
    try:
        grid_jobs, grids = cs.queue_phase26_grids(pool, dev)
        jobs, rays = cs.queue_phase26(pool, dev, al_d, th_d)
        entries = cs.broad_phase(dev, card, pool, dict(
            build=broad, jobs=jobs, rays=rays, grid_jobs=grid_jobs,
            grids=grids))
        print(json.dumps({"kernels": entries}), flush=True)
    except cs.SmokeFailure as exc:
        print(f"phase 26 FAILED: {exc}", file=sys.stderr, flush=True)
        code = 1
    finally:
        pool.close()
        cs.PlainPool.stop_all()
        cs.background_build.stop_all()
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(code)
