"""Build and load the package's CUDA kernels.

The sources in `light_path_tracer_tpu_torch/csrc/*.cu` have a plain C
interface; each `*_f64.cu` builds the float64 instances of its float
sibling. At first use each is compiled by its own `nvcc` for Hopper
(`sm_90a`), all at once, and the objects are linked into one shared
library under `build/light_path_tracer_tpu_torch/` beside the package,
named by a hash of the sources, headers and flags, and loaded with
`ctypes`. A later process with the same sources loads the existing file.
Nothing is compiled when a module is imported, and a missing `nvcc` or a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "light_path_tracer_tpu_torch"
# -fmad=false: no contraction of a*b + c into one FMA, so each product and
# sum rounds apart, as the plain loops and the JAX package on the CPU
# round them (a kernel that wants an FMA writes fmaf / fma explicitly).
# -Xptxas -v only reports registers, shared memory and spills per kernel
# (kept in build_log); it does not change the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_F = ctypes.c_float
_D = ctypes.c_double
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lpt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every (cmd, Popen); raise with the compiler's output if
    any failed. Returns the concatenated output."""
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _compile(out: Path) -> str:
    """Compile every source into `out`, one nvcc per source, all started
    together, then link; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        log = _run([_start([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                            str(src)])
                    for src, obj in zip(_sources(), objs)])
        lib = Path(tmp) / out.name
        log += _run([_start([_nvcc(), *LINK_FLAGS, "-o", str(lib),
                             *(str(o) for o in objs)])])
        os.replace(lib, out)
    return log


def _declare(lib):
    # Each entry has a float instance and a float64 one (name + "_f64")
    # whose scalars are doubles.
    for suffix, real in (("", _F), ("_f64", _D)):
        fn = getattr(lib, "lpt_kerr_dp45" + suffix)
        fn.argtypes = [_P, _I]
        fn.restype = _I
        for name in ("lpt_kerr_dp45_extras", "lpt_kerr_dp45_stokes",
                     "lpt_kerr_dp45_movie_thin",
                     "lpt_kerr_dp45_movie_absorbed", "lpt_kerr_dp45_orders"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = [_P, _P]
            fn.restype = _I
        fn = getattr(lib, "lpt_orbit_rk4" + suffix)
        fn.argtypes = [_P] * 6 + [_I] * 2 + [real] * 13 + [_I] * 2 + [_P]
        fn.restype = _I
    fn = lib.lpt_peak_probe
    fn.argtypes = [_I, _P, _P, _I, _I, ctypes.c_double, ctypes.c_double, _P]
    fn.restype = _I
    lib.lpt_cuda_error_string.argtypes = [_I]
    lib.lpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library():
    """The compiled kernel library, built on first use. Its `build_log`
    attribute holds nvcc's resource report ('' when it was loaded from an
    earlier build)."""
    path = library_path()
    log = "" if path.exists() else _compile(path)
    lib = _declare(ctypes.CDLL(str(path)))
    lib.build_log = log
    return lib


def check(lib, rc: int, what: str):
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        msg = lib.lpt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
