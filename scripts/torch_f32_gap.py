#!/usr/bin/env python3
"""Where the float32 gap between the PyTorch port's plain extras loop and
the JAX package's comes from, on the CPU.

  JAX_PLATFORMS=cpu python3 scripts/torch_f32_gap.py [--seeds 8] [CASE ...]

Runs the float32 cases of tests/test_torch_broad_extras.py (12-frame
movies, 10- and 33-band spectra; 5 and 6 orders on rays away from the
critical curve) and of tests/test_torch_movie.py (4 frames) over several
ray seeds. For each case and seed it prints, as p99 over the rays of
equal status divided by the largest float64 value, the worst extra's
  gap    |port float32 - JAX float32|,
  port   |port float32 - JAX float64|,
  jax    |JAX float32 - JAX float64|,
and the largest (port - 2 jax) over the extras: the gap between the
packages is each package's own float32 error, which the port's does not
exceed by more than twice JAX's. For the order forms it prints the winding
m's gap, the per-ray bucket sums' readings as above, and the order
buckets' numbers (chip_smoke.order_numbers) and their gates, port float32
against JAX float32.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _extras_case(tb, name, seeds):
    kind, width, n, riaf_kw, kw = tb.F32_CASES[name]
    jt, tt, n_bands = tb._transfer(kind, tb.A, width, **riaf_kw)
    for seed in range(seeds):
        al, th = tb._rays(n, seed, "float32")
        sj, st, pairs = tb._both(tb.A, al, th, jt, tt, n_bands, **kw)
        s64, ref = tb._jax64(tb.A, al, th, jt, n_bands, **kw)
        g = tb.f32_readings(sj, st, s64, pairs, ref)
        print(f"{name} seed {seed}: {g}", flush=True)


def _movie4_case(seeds):
    import jax.numpy as jnp
    import numpy as np
    import torch
    import test_torch_broad_extras as tb
    import test_torch_movie as tm
    from light_path_tracer_tpu_torch.models import Kerr
    from light_path_tracer_tpu_torch.ops import kerr_trace as tk
    jt, tt = tm._transfers(alpha0=0.3)
    n_bands = 1 + len(tm.TIMES)
    kw = dict(sat_window=512, sat_monitor=tuple(range(2, 2 + len(tm.TIMES))))

    def pairs_of(rj, rt):
        return [(np.asarray(rj.tau_hat), rt.tau_hat.numpy())] + [
            (np.asarray(a), b.numpy()) for a, b in zip(rj.emission,
                                                      rt.emission)]
    for seed in range(seeds):
        al, th = tm._rays(192, seed, "float32")
        rj = tm.jspec(tm.JKerr(M=tm.M, a=tm.A), tm.R_OBS, jnp.asarray(al),
                      jnp.asarray(th), tm.THETA, jt, n_bands, 5000.0, 4000,
                      **kw)
        rt = tk.trace_rays_spectral(
            Kerr(M=tm.M, a=tm.A), tm.R_OBS, torch.from_numpy(al),
            torch.from_numpy(th), tm.THETA, tt, n_bands, 5000.0, 4000, **kw)
        s64, ref = tb._jax64(tm.A, al, th, jt, n_bands, **kw)
        print(f"movie4 seed {seed}: " + str(tb.f32_readings(
            np.asarray(rj.status), rt.status.numpy(), s64, pairs_of(rj, rt),
            ref)), flush=True)


def _order_case(tb, n_orders, seeds):
    for seed in range(seeds):
        sj, st, g = tb.f32_orders(n_orders, seed)
        smoke = tb._smoke()
        keep = {k: g[k] for k in ("sum", "p99_sum", "flux_shift",
                                  "flux_rel", "carriers", "bucket_match")}
        print(f"orders{n_orders} seed {seed}: statuses equal "
              f"{bool((sj == st).all())}, m {g['m']}, order gate "
              f"{smoke.order_gate(g)}, flux bars {g['flux_bars']}, "
              f"flux shift bar {g['flux_shift_bar']}, {keep}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("cases", nargs="*")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch
    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location(
        "test_torch_broad_extras", ROOT / "tests" / "test_torch_broad_extras.py")
    tb = importlib.util.module_from_spec(spec)
    sys.modules["test_torch_broad_extras"] = tb
    spec.loader.exec_module(tb)
    cases = args.cases or [*tb.F32_CASES, "movie4", "orders5", "orders6"]
    for name in cases:
        if name == "movie4":
            _movie4_case(args.seeds)
        elif name.startswith("orders"):
            _order_case(tb, int(name[len("orders"):]), args.seeds)
        else:
            _extras_case(tb, name, args.seeds)


if __name__ == "__main__":
    main()
