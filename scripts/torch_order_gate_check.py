#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's photon-ring order gates, on one GPU.

  python3 scripts/torch_order_gate_check.py

Copies the port and chip_smoke.py into temporary directories, breaks the
order functor's last, open-ended bucket in two of the copies
(csrc/kerr_dp45_orders.cu), builds each copy and runs phase 14's order
forms (three orders thin and absorbed, two orders thin) against the plain
loop on its 4,096 random rays:
  control      the sources as they are: every gate must pass;
  last-empty   the last order's emission lands in the order before it;
  last-closed  the last bucket takes only its own winding, so emission
               after a later crossing is dropped.
Prints each form's numbers and verdict; exits 0 iff the control passes
every gate and each broken kernel fails at least one. The repo's own
tree is never changed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = "const bool in = n < kOrders - 1 ? bucket == edge : bucket >= edge;"
MUTATIONS = {
    "control": LINE,
    "last-empty": ("const bool in = n < kOrders - 2 ? bucket == edge : "
                   "(n == kOrders - 2 && bucket >= edge);"),
    "last-closed": "const bool in = bucket == edge;",
}


def child(tag):
    """Runs in a copy: phase 14's order forms with gates that report."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as cs
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.models import Kerr

    failed = []
    cs.require = lambda ok, what: None if ok else failed.append(what)
    dev = torch.device("cuda", 0)
    kerr = Kerr(M=1.0, a=0.9)
    ac = kerr.alpha_crit(cs.R_OBS, cs.THETA_VOL)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, cs.VOL_RAYS), **f32)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, cs.VOL_RAYS), **f32)
    forms = cs.aux_forms(kerr, al, th)
    forms = {k: v for k, v in forms.items() if k.startswith("order")}
    forms["order x2 thin"] = (
        volumetric.make_order_transfer(kerr, volumetric.RIAFConfig(), 2),
        3, (), (1, 2), 0)
    verdicts = {}
    for label, form in forms.items():
        before = len(failed)
        cs.aux_both(tag, kerr, label, form, al, th, cs.AUX_STEPS,
                    cs.AUX_WINDOW, f64=False)
        verdicts[label] = "passed" if len(failed) == before else "FAILED"
    print(f"VERDICT {json.dumps({tag: verdicts})}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_order_gate_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    source = "light_path_tracer_tpu_torch/csrc/kerr_dp45_orders.cu"
    verdicts = {}
    for tag, line in MUTATIONS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(REPO, "light_path_tracer_tpu_torch"),
                            os.path.join(tmp, "light_path_tracer_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
            path = os.path.join(tmp, source)
            with open(path) as f:
                text = f.read()
            if text.count(LINE) != 1:
                print(f"the bucket line is not in {source}", file=sys.stderr)
                return 1
            with open(path, "w") as f:
                f.write(text.replace(LINE, line))
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tag],
                cwd=tmp, capture_output=True, text=True, timeout=900)
            print(out.stdout, end="", flush=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            last = out.stdout.strip().splitlines()[-1]
            verdicts.update(json.loads(last.removeprefix("VERDICT ")))
    ok = (all(v == "passed" for v in verdicts["control"].values())
          and all("FAILED" in verdicts[t].values()
                  for t in ("last-empty", "last-closed")))
    print(f"order gates: {json.dumps(verdicts)}; "
          f"{'ok' if ok else 'NOT ok'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
