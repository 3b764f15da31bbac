#!/usr/bin/env python3
"""chip_smoke.py's phase 28 alone on one NVIDIA GPU: the Kerr kernel with
run-time (M, a) and (M, a, r_obs) (the theta and mu instances bitwise
their plain loop, a 1024^2 flyby frame through the hybrid bitwise the
plain loop through it), the dynamic frame against the static shadow, each
mode at 64^2 against the CPU, and the `animate`, `pano` and `star` CLIs
at full width.

  python3 scripts/torch_phase28.py

Builds the "dp45" kernel library in the parent and the "more" (the mu
instances) and "surface" ones in children at nice 19, as the smoke does,
then runs chip_smoke.queue_phase28 and chip_smoke.dynamic_phase with their
PlainPool children and prints the phase's kernels-line entries. Exits 1
if a gate of the phase fails (chip_smoke.SmokeFailure).
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
    builds = [cs.background_build(name) for name in ("more", "surface")]
    _build.load_library("dp45")
    print(f"dp45 built: {time.perf_counter() - t0:.1f} s", flush=True)
    pool = cs.PlainPool()
    code = 0
    try:
        jobs = cs.queue_phase28(pool, dev)
        for b in builds:
            _lib, secs = b.result()
            print(f"{b.library} built in {secs:.1f} s at nice 19",
                  flush=True)
        entries = cs.dynamic_phase(dev, card, pool, dict(jobs=jobs))
        pool.close()
        cs.retime_entries(card)
        print(json.dumps({"kernels": entries}), flush=True)
    except cs.SmokeFailure as exc:
        print(f"phase 28 FAILED: {exc}", file=sys.stderr, flush=True)
        code = 1
    finally:
        pool.close()
        cs.PlainPool.stop_all()
        cs.background_build.stop_all()
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(code)
