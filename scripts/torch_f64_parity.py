#!/usr/bin/env python3
"""Where the float64 extras kernel parts from its plain loop on the card.

  python3 scripts/torch_f64_parity.py [--out f64_parity.json]
                                      [--sections libm,attempts,swap]

libm: builds one probe source twice with nvcc for sm_90a, with the
    package's flags (ops/cuda/_build.py NVCC_FLAGS, -fmad=false) and with
    nvcc's default contraction of a*b + c into FMA, and evaluates in each
    build the math library calls the kernels make, through the kernels'
    own wrappers (csrc/kerr_dp45_common.cuh exp_, pow_, sin_, cos_, sqrt_,
    acos_; csrc/kerr_dp45_extras.cuh's sigmoid 1 / (1 + exp(-x))) and an
    IEEE division, on 2^20 arguments each (made from a seed), in float32
    and float64; counts the values where each build differs from
    PyTorch's own operation on the same CUDA tensor (torch.exp, x ** k
    with a 0-dim tensor k as the plain loops raise to, torch.sin, ...,
    torch.sigmoid, x / y) and the largest difference in units of the last
    place.
attempts: the float64 absorbed volumetric trace (4,096 rays of the
    1024^2 scene's range, a = 0.9 Kerr and a = 0.6, Q = 0.6 Kerr-Newman,
    theta_obs 80 deg, DP45) through the kernel wrapper and the plain loop
    on the card at attempt caps 1, 2, 4, ..., then bisected: the first
    cap at which any output differs, how many rays differ there, and by
    how much.
swap: the same traces at full depth with the plain loop's transfer
    functions calling the probe's float64 exp, pow and sigmoid of the
    package's build in place of PyTorch's (every other operation stays
    PyTorch's): whether the plain loop then equals the kernel bit for bit.

Prints one JSON object a section and writes them all to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROBE_SOURCE = r"""
#include "kerr_dp45_common.cuh"

namespace {
template <class T>
__device__ __forceinline__ T sigmoid_f(T x) {
  return T(1.0) / (T(1.0) + exp_(-x));
}

template <class T>
__global__ void libm_probe(int fn, const T* x, const T* y, T* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T a = x[i], b = y[i];
  T r;
  switch (fn) {
    case 0: r = exp_(a); break;
    case 1: r = pow_(a, b); break;
    case 2: r = sin_(a); break;
    case 3: r = cos_(a); break;
    case 4: r = sqrt_(a); break;
    case 5: r = acos_(a); break;
    case 6: r = sigmoid_f(a); break;
    default: r = a / b; break;
  }
  out[i] = r;
}
}  // namespace

extern "C" int lpt_libm_probe(int fn, int f64, const void* x, const void* y,
                              void* out, int n) {
  const int blocks = (n + 127) / 128;
  if (f64)
    libm_probe<double><<<blocks, 128>>>(fn, (const double*)x,
                                        (const double*)y, (double*)out, n);
  else
    libm_probe<float><<<blocks, 128>>>(fn, (const float*)x, (const float*)y,
                                       (float*)out, n);
  return (int)cudaGetLastError();
}
"""

FUNCTIONS = ("exp", "pow", "sin", "cos", "sqrt", "acos", "sigmoid", "div")
# Arguments of each call: a uniform range (and pow's exponents, the ones
# the transfer functions raise to).
RANGES = {"exp": (-40.0, 5.0), "pow": (0.05, 12.0), "sin": (-20.0, 20.0),
          "cos": (-20.0, 20.0), "sqrt": (0.0, 1e4), "acos": (-1.0, 1.0),
          "sigmoid": (-30.0, 30.0), "div": (0.1, 100.0)}
POW_EXPONENTS = (3.0, 2.0, 4.0, 1.5, -1.0)


def build_probes(out_dir: Path):
    """The probe library with the package's flags ("package") and with
    nvcc's default contraction ("contracted"); returns {name: CDLL}."""
    from light_path_tracer_tpu_torch.ops.cuda import _build
    src = out_dir / "libm_probe.cu"
    src.write_text(PROBE_SOURCE)
    flags = {"package": list(_build.NVCC_FLAGS),
             "contracted": [f for f in _build.NVCC_FLAGS
                            if f != "-fmad=false"]}
    procs = {}
    for name, fl in flags.items():
        lib = out_dir / f"libm_probe_{name}.so"
        cmd = [_build._nvcc(), *fl, "-shared", "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {name} failed:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.lpt_libm_probe.restype = ctypes.c_int
        cdll.lpt_libm_probe.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int]
        libs[name] = cdll
    return libs


def probe_call(lib, fn: str, x, y=None):
    """The probe's value of `fn` on CUDA tensors x (and y)."""
    import torch
    y = x if y is None else y.expand_as(x).contiguous()
    out = torch.empty_like(x)
    rc = lib.lpt_libm_probe(FUNCTIONS.index(fn), int(x.dtype ==
                                                     torch.float64),
                            x.data_ptr(), y.data_ptr(), out.data_ptr(),
                            x.numel())
    if rc:
        raise RuntimeError(f"probe launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    return out


def torch_call(fn: str, x, y=None):
    import torch
    return {"exp": lambda: torch.exp(x), "pow": lambda: x ** y,
            "sin": lambda: torch.sin(x), "cos": lambda: torch.cos(x),
            "sqrt": lambda: torch.sqrt(x), "acos": lambda: torch.acos(x),
            "sigmoid": lambda: torch.sigmoid(x), "div": lambda: x / y}[fn]()


def ulps(a, b):
    """Largest distance in units of the last place between two tensors of
    one float type (0 where both are the same bits)."""
    import torch
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    ia, ib = a.view(it).to(torch.int64), b.view(it).to(torch.int64)
    return int((ia - ib).abs().max()) if a.numel() else 0


def libm_section(dev, libs):
    import torch
    rng = np.random.default_rng(12)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for fn in FUNCTIONS:
            lo, hi = RANGES[fn]
            x = torch.tensor(rng.uniform(lo, hi, 1 << 20), dtype=dtype,
                             device=dev)
            ys = ([torch.full((), e, dtype=dtype, device=dev)
                   for e in POW_EXPONENTS] if fn == "pow" else
                  [torch.tensor(rng.uniform(0.1, 100.0, 1 << 20),
                                dtype=dtype, device=dev)] if fn == "div"
                  else [None])
            for y in ys:
                key = f"{fn} {str(dtype)[6:]}"
                if fn == "pow":
                    key += f" k={float(y):g}"
                ref = torch_call(fn, x, y)
                rows[key] = {}
                for name, lib in libs.items():
                    got = probe_call(lib, fn, x, y)
                    rows[key][name] = dict(
                        differ=int((got.view(-1) != ref.view(-1)).sum()),
                        max_ulps=ulps(got, ref))
    return rows


def absorbed_inputs(family: str, dev):
    """The 4,096 float64 rays and the absorbed form of `family`."""
    import torch
    from light_path_tracer_tpu_torch import volumetric
    from light_path_tracer_tpu_torch.models import Kerr, KerrNewman
    m = (Kerr(M=1.0, a=0.9) if family == "kerr"
         else KerrNewman(M=1.0, a=0.6, Q=0.6))
    theta_obs = float(np.radians(80.0))
    ac = m.alpha_crit(100.0, theta_obs)
    rng = np.random.default_rng(231)
    t = dict(dtype=torch.float64, device=dev)
    al = torch.tensor(rng.uniform(0.3 * ac, 4 * ac, 4096), **t)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, 4096), **t)
    em, ab = volumetric.make_transfer_fns(m, volumetric.RIAFConfig(
        alpha0=0.5))
    return m, al, th, theta_obs, em, ab


def absorbed_trace(inputs, cap, kernel):
    from light_path_tracer_tpu_torch.ops import kerr_trace
    from light_path_tracer_tpu_torch.ops.cuda import volumetric_kernel as vk
    m, al, th, theta_obs, em, ab = inputs
    fn = (vk.trace_rays_volumetric_cuda if kernel
          else kerr_trace.trace_rays_volumetric)
    res = fn(m, 100.0, al, th, theta_obs, em, 5000.0, cap,
             absorption_fn=ab, sat_window=512)
    return dict(status=res.status, emission=res.emission,
                optical_depth=res.optical_depth, final_alpha=res.final_alpha)


def differ(a, b):
    """{output: (rays whose bits differ, largest |d|)} of two traces."""
    import torch
    out = {}
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        it = {torch.float64: torch.int64, torch.float32: torch.int32}.get(
            x.dtype)
        ne = (x.view(it) != y.view(it)) if it else (x != y)
        ok = ne & torch.isfinite(x.double()) & torch.isfinite(y.double())
        out[k] = (int(ne.sum()), float((x.double() - y.double())[ok].abs()
                                       .max()) if ok.any() else 0.0)
    return out


def attempts_section(dev):
    rows = {}
    for family in ("kerr", "kerr_newman"):
        inputs = absorbed_inputs(family, dev)

        def same(cap):
            d = differ(absorbed_trace(inputs, cap, True),
                       absorbed_trace(inputs, cap, False))
            return all(v[0] == 0 for v in d.values()), d

        cap, last_same, seen = 1, 0, {}
        while cap <= 4096:
            ok, d = same(cap)
            seen[cap] = d
            if not ok:
                break
            last_same, cap = cap, cap * 2
        if cap > 4096:
            rows[family] = dict(first_differing_cap=None, checked_to=4096)
            continue
        lo, hi = last_same, cap
        while hi - lo > 1:
            mid = (lo + hi) // 2
            ok, d = same(mid)
            seen[mid] = d
            lo, hi = (mid, hi) if ok else (lo, mid)
        rows[family] = dict(first_differing_cap=hi, last_equal_cap=lo,
                            at_first=seen[hi],
                            full_depth=same(200000)[1])
    return rows


class ProbeOperand:
    """A divisor or exponent of the plain transfer functions on the card
    whose power goes to the probe's pow (the package's build): x / k
    divides by the 0-dim tensor, x ** k calls the probe."""

    def __init__(self, value, like, lib):
        import torch
        self.t = torch.full((), float(value), dtype=like.dtype,
                            device=like.device)
        self.lib = lib

    def __rtruediv__(self, x):
        return x / self.t

    def __rpow__(self, x):
        return probe_call(self.lib, "pow", x.contiguous(), self.t)


class ProbeTorch:
    """The torch module as the transfer functions see it, with exp and
    sigmoid from the probe (the package's build)."""

    def __init__(self, lib):
        import torch
        self._torch, self._lib = torch, lib

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def exp(self, x):
        return probe_call(self._lib, "exp", x.contiguous())

    def sigmoid(self, x):
        return probe_call(self._lib, "sigmoid", x.contiguous())


def swap_section(dev, lib):
    from light_path_tracer_tpu_torch import volumetric
    rows = {}
    saved = volumetric.torch, volumetric._k
    for family in ("kerr", "kerr_newman"):
        inputs = absorbed_inputs(family, dev)
        k = absorbed_trace(inputs, 200000, True)
        p = absorbed_trace(inputs, 200000, False)
        try:
            volumetric.torch = ProbeTorch(lib)
            volumetric._k = lambda x, like: ProbeOperand(x, like, lib)
            s = absorbed_trace(inputs, 200000, False)
        finally:
            volumetric.torch, volumetric._k = saved
        rows[family] = dict(plain=differ(k, p), plain_with_probe_libm=differ(
            k, s))
    return rows


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="f64_parity.json")
    parser.add_argument("--sections", default="libm,attempts,swap")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_f64_parity: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    report = dict(card=card)
    print(card, flush=True)
    sections = args.sections.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        libs = (build_probes(Path(tmp)) if {"libm", "swap"} & set(sections)
                else {})
        for name in sections:
            if name == "libm":
                rows = libm_section(dev, libs)
            elif name == "attempts":
                rows = attempts_section(dev)
            else:
                rows = swap_section(dev, libs["package"])
            report[name] = rows
            print(json.dumps({name: rows}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
