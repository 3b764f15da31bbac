#!/usr/bin/env python3
"""chip_smoke.py's phase 30 alone on one NVIDIA GPU: the port's HTTP render
server (serve.py) on the card, each mode's reply bitwise its direct call
with its kernels' launches, the error taxonomy under a held render lock,
the offline `request` CLI, and the lookup cache, chunk resume and live bar
on the 1024^2 shadow scene.

  python3 scripts/torch_phase30.py

Builds the "dp45" kernel library in the parent and the "surface" one in a
child at nice 19, as the smoke does, then runs chip_smoke.serve_phase.
With --tests, also runs the card tests of the server (tests/test_torch_
cuda.py -k "serve or device_memory or progress_and_store", --noconftest)
once the phase has passed. Exits 1 if a gate fails.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

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
    code = 0
    try:
        _lib, secs = surface.result()
        print(f"surface built in {secs:.1f} s at nice 19", flush=True)
        t1 = time.perf_counter()
        cs.serve_phase(dev, card)
        print(f"phase 30: {time.perf_counter() - t1:.1f} s", flush=True)
    except cs.SmokeFailure as exc:
        print(f"phase 30 FAILED: {exc}", file=sys.stderr, flush=True)
        code = 1
    finally:
        cs.background_build.stop_all()
    if code == 0 and "--tests" in sys.argv[1:]:
        code = subprocess.call(
            [sys.executable, "-m", "pytest", "--noconftest", "-q",
             "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
             "serve or device_memory or progress_and_store"], cwd=ROOT)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(code)
