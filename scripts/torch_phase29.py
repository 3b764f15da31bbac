#!/usr/bin/env python3
"""chip_smoke.py's phase 29 alone on one NVIDIA GPU: `ray`, `plot` and
`orbit` through the CLI with the ten angles and both orbits held against
the CPU, the fixed-step RK4 1024^2 shadow against the DP45 kernel's frame,
the user metrics (`--metric-py`, the 512^2 frames, the closure identity,
64^2 against the CPU) and the differentiable fit.

  python3 scripts/torch_phase29.py

Builds the "dp45" kernel library (the Kerr and orbit kernels that trace_ray
and plot launch), then runs chip_smoke.queue_phase29 and
chip_smoke.paths_phase with their PlainPool children. Exits 1 if a gate of
the phase fails (chip_smoke.SmokeFailure).
"""

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
    _build.load_library("dp45")
    print(f"dp45 built: {time.perf_counter() - t0:.1f} s", flush=True)
    pool = cs.PlainPool()
    code = 0
    try:
        jobs = cs.queue_phase29(pool, dev)
        cs.paths_phase(dev, card, pool, dict(jobs=jobs))
    except cs.SmokeFailure as exc:
        print(f"phase 29 FAILED: {exc}", file=sys.stderr, flush=True)
        code = 1
    finally:
        pool.close()
        cs.PlainPool.stop_all()
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(code)
