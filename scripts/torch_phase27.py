#!/usr/bin/env python3
"""chip_smoke.py's phase 27 alone on one NVIDIA GPU: the surface kernel
(every instance bitwise its plain loop) and the lens-map products of the
`shadow --rings` / `lens` CLI at 64^2 against the CPU and at 512^2.

  python3 scripts/torch_phase27.py

Builds the "dp45" kernel library (the Kerr and orbit kernels of the ring
layers and the magnification map) and the "surface" one in a child at
nice 19 (as the smoke does), then runs chip_smoke.queue_phase27 and
chip_smoke.surface_phase with their PlainPool children, and prints the
phase's kernels-line entries. Exits 1 if a gate of the phase fails
(chip_smoke.SmokeFailure).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import torch
    import chip_smoke as cs
    from light_path_tracer_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    print(card, flush=True)
    surface = cs.background_build("surface")
    _build.load_library("dp45")
    print(f"dp45 built: {time.perf_counter() - t0:.1f} s", flush=True)
    pool = cs.PlainPool()
    code = 0
    try:
        jobs = cs.queue_phase27(pool, dev)
        entries = cs.surface_phase(dev, card, pool, dict(build=surface,
                                                          jobs=jobs))
        pool.close()
        cs.retime_entries(card)
        print(json.dumps({"kernels": entries}), flush=True)
    except cs.SmokeFailure as exc:
        print(f"phase 27 FAILED: {exc}", file=sys.stderr, flush=True)
        code = 1
    finally:
        pool.close()
        cs.PlainPool.stop_all()
        cs.background_build.stop_all()
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(code)
