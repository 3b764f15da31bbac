"""Build and load the package's CUDA kernels.

The sources in `light_path_tracer_tpu_torch/csrc/*.cu` have a plain C
interface. At first use they are compiled by `nvcc` for Hopper (`sm_90a`)
into one shared library under `build/light_path_tracer_tpu_torch/` beside
the package, named by a hash of the sources and flags, and loaded with
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
# -Xptxas -v only reports registers, shared memory and spills per kernel
# (kept in build_log); it does not change the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_F = ctypes.c_float
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
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lpt_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> str:
    """Compile every source into `out`; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(s) for s in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return proc.stdout + proc.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib):
    fn = lib.lpt_kerr_dp45
    fn.argtypes = ([_P] * 10 + [_I] + [_F] * 6 + [_I] + [_F] * 8 + [_P])
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
