"""Build and load the package's CUDA kernels.

The sources in `light_path_tracer_tpu_torch/csrc/*.cu` have a plain C
interface; each `*_f64.cu` builds the float64 instances of its float
sibling, each `*_mu*.cu` the Kerr kernel's mu-chart instances, each
`*_wide*.cu` its disk variant's instances for 5 to 8 crossing slots, each
`*_planes*.cu` its plane-recorder instances (tilted, warped and second
planes, crossing times), each `*_kn*.cu` the extras kernel's
Kerr-Newman ones and each `*_broad*.cu` the instances that read their
width at run time (the extras kernel's spectra, movies and order
decompositions wider than its compiled instances, and the plane recorder
with any number of planes), and each `kerr_surface*.cu` the surface
kernel's instances. They form five libraries: "dp45", the DP45
Kerr and extras kernels' theta and Kerr instances, the orbit kernel and
the peak probe; "more", the DP45 mu-chart, wide, plane-recorder and
Kerr-Newman-extras instances (`kerr_dp45_*mu*.cu`, `kerr_dp45_wide*.cu`,
`kerr_dp45_planes*.cu`, `kerr_dp45_*_kn*.cu`); "dop853", every other
`kerr_dop853*.cu` source (the DOP853 instances of the Kerr and extras
kernels, every chart, width and family); "broad", every
`*_broad*.cu` source, DP45 and DOP853; and "surface", the
`kerr_surface*.cu` sources, DP45 and DOP853. At the first use of a library
each of its sources is compiled by its own `nvcc` for Hopper (`sm_90a`),
all at once, and the objects are linked into one shared library under
`build/light_path_tracer_tpu_torch/` beside the package, named by the
library and a hash of the sources, headers and flags, and loaded with
`ctypes`; so a run that traces DP45 only never builds the DOP853
instances. A later process with the same sources loads the existing file.
Nothing is compiled when a module is imported, and a missing `nvcc` or a
failed build raises with the compiler's output.

The float64 extras, plane-recorder, broad and surface sources
(`*_{extras,stokes,movie,orders,planes,broad}*_f64.cu`,
`kerr_surface*_f64.cu`) are built as
relocatable device code and call the float64 pow of
`csrc/lpt_pow_f64.cu`, a translation unit built with nvcc's default
contraction, as PyTorch builds its own pow: each library that holds such
sources compiles that file too and device-links them before the link.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "light_path_tracer_tpu_torch"
# -fmad=false: no contraction of a*b + c into one FMA, so each product and
# sum rounds apart, as the plain loops and the JAX package on the CPU
# round them (a kernel that wants an FMA writes fmaf / fma explicitly).
# -Xptxas -v only reports registers, shared memory and spills per kernel
# (kept beside the library and in build_log); it does not change the
# code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# The float64 extras sources: relocatable device code whose pow_ calls
# lpt_pow_f64 (csrc/kerr_dp45_common.cuh), and that pow's own source,
# built with contraction (nvcc's default) in place of -fmad=false.
RDC_FLAGS = ("-rdc=true", "-DLPT_EXTERN_POW_F64=1")
POW_SOURCE = "lpt_pow_f64.cu"
POW_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false") + (
    "-fmad=true", "-rdc=true")
DLINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-Xcompiler",
               "-fPIC", "-dlink")

# The extras kernel's C entry points, one a transfer family; each has a
# *_describe twin that reports an instance's resources. Each but the
# Stokes one also has Kerr-Newman instances, entries name + "_kn" (the
# describe twin name + "_describe_kn"), before the pair's and the dtype's
# suffixes.
EXTRAS_ENTRIES = ("lpt_kerr_dp45_extras", "lpt_kerr_dp45_stokes",
                  "lpt_kerr_dp45_movie_thin", "lpt_kerr_dp45_movie_absorbed",
                  "lpt_kerr_dp45_orders")
KN_EXTRAS_ENTRIES = tuple(e for e in EXTRAS_ENTRIES
                          if e != "lpt_kerr_dp45_stokes")
# The Kerr kernel's C entry points: the theta chart, the mu chart and the
# wide disk instances (a call and the disk flag); the plane-recorder
# instances take a call and a PlaneSet.
KERR_ENTRIES = ("lpt_kerr_dp45", "lpt_kerr_dp45_mu", "lpt_kerr_dp45_wide")
PLANES_ENTRY = "lpt_kerr_dp45_planes"
# The broad library's entries: the extras kernel's (a call, its
# RiafParams and the width; a describe twin name + "_describe" that takes
# the form), with Kerr-Newman instances name + "_kn", and the plane
# recorder's with any number of planes (a call and a PlaneList).
BROAD_EXTRAS_ENTRY = "lpt_kerr_dp45_broad"
BROAD_PLANES_ENTRY = "lpt_kerr_dp45_broad_planes"
# The surface kernel's entry (a SurfaceCall), one a pair and dtype.
SURFACE_ENTRY = "lpt_kerr_surface"


def _broad_source(name):
    """A source of the run-time-width instances (the "broad" library)."""
    return "_broad" in name


def _surface_source(name):
    """A source of the surface kernel's instances (the "surface"
    library)."""
    return name.startswith("kerr_surface")


def _variant_source(name):
    """A source of the mu chart's, the wide disk, the plane-recorder or
    the Kerr-Newman extras' instances."""
    stem = name[:-len(".cu")]
    return ("_mu" in stem or "_wide" in stem or "_planes" in stem
            or stem.endswith(("_kn", "_kn_f64")))


def _rdc_source(name):
    """A float64 source of the extras kernel, of the plane recorder or of
    the broad instances (it calls lpt_pow_f64)."""
    stem = name[:-len(".cu")]
    form = stem.removeprefix("kerr_dp45_").removeprefix("kerr_dop853_")
    return stem.endswith("_f64") and form.startswith(
        ("extras", "stokes", "movie", "orders", "planes", "broad",
         "kerr_surface"))

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


# The libraries: name -> (file name prefix, whether a source belongs).
LIBRARIES = {
    "dp45": ("lpt_kernels", lambda name: not name.startswith("kerr_dop853")
             and not _variant_source(name) and not _broad_source(name)
             and not _surface_source(name) and name != POW_SOURCE),
    "more": ("lpt_more", lambda name: not name.startswith("kerr_dop853")
             and _variant_source(name) and not _broad_source(name)),
    "dop853": ("lpt_dop853", lambda name: name.startswith("kerr_dop853")
               and not _broad_source(name)),
    "broad": ("lpt_broad", _broad_source),
    "surface": ("lpt_surface", _surface_source),
}


def _sources(library="dp45"):
    belongs = LIBRARIES[library][1]
    srcs = [s for s in sorted(CSRC.glob("*.cu")) if belongs(s.name)]
    if not srcs:
        raise RuntimeError(f"no CUDA sources of the {library} library in "
                           f"{CSRC}")
    return srcs


def library_path(library="dp45") -> Path:
    """Where the library `library` ("dp45", "more", "dop853", "broad" or
    "surface") for the current sources, headers and flags lives. The hash covers
    every source and header (a DOP853 source includes its DP45
    sibling)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS + RDC_FLAGS
                                + POW_FLAGS + DLINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{LIBRARIES[library][0]}_{h.hexdigest()[:16]}.so"


def log_path(lib: Path) -> Path:
    """Where nvcc's output for the library at `lib` is kept."""
    return lib.with_suffix(".log")


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


def _compile(out: Path, library: str) -> str:
    """Compile every source of `library` into `out`, one nvcc per source,
    all started together (with lpt_pow_f64.cu where a float64 extras
    source is among them), device-link the relocatable objects, then
    link; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = _sources(library)
    flags = [NVCC_FLAGS + (RDC_FLAGS if _rdc_source(s.name) else ())
             for s in srcs]
    if any(_rdc_source(s.name) for s in srcs):
        srcs.append(CSRC / POW_SOURCE)
        flags.append(POW_FLAGS)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        log = _run([_start([_nvcc(), *f, "-c", "-o", str(obj), str(src)])
                    for src, obj, f in zip(srcs, objs, flags)])
        rdc = [str(o) for o, f in zip(objs, flags) if "-rdc=true" in f]
        if rdc:
            dlink = Path(tmp) / "dlink.o"
            log += _run([_start([_nvcc(), *DLINK_FLAGS, "-o", str(dlink),
                                 *rdc])])
            objs.append(dlink)
        lib = Path(tmp) / out.name
        log += _run([_start([_nvcc(), *LINK_FLAGS, "-o", str(lib),
                             *(str(o) for o in objs)])])
        log_path(out).write_text(log)
        os.replace(lib, out)
    return log


def _declare_pair(lib, suffix, base=True, variants=True):
    """The Kerr and extras entries of one pair and dtype (suffix: "",
    "_f64", "_dop853" or "_dop853_f64"): the theta and Kerr ones (base),
    the mu chart's and the Kerr-Newman extras' ones (variants)."""
    kerr = ((KERR_ENTRIES[0],) if base else ()) + (
        KERR_ENTRIES[1:] if variants else ())
    for name in kerr:
        fn = getattr(lib, name + suffix)
        fn.argtypes = [_P, _I]
        fn.restype = _I
    if variants:
        fn = getattr(lib, PLANES_ENTRY + suffix)
        fn.argtypes = [_P, _P]
        fn.restype = _I
    for name in EXTRAS_ENTRIES if base else ():
        _declare_extras(lib, name + suffix, name + "_describe" + suffix)
    for name in KN_EXTRAS_ENTRIES if variants else ():
        _declare_extras(lib, name + "_kn" + suffix,
                        name + "_describe_kn" + suffix)


def _declare(lib, library):
    # Each entry has a float instance and a float64 one (name + "_f64")
    # whose scalars are doubles; the DOP853 library's entries carry
    # "_dop853" before that suffix and are the Kerr and extras ones.
    if library == "dop853":
        for suffix in ("_dop853", "_dop853_f64"):
            _declare_pair(lib, suffix)
        return _declare_error_string(lib)
    if library == "more":
        for suffix in ("", "_f64"):
            _declare_pair(lib, suffix, base=False)
        return _declare_error_string(lib)
    if library == "broad":
        for suffix in ("", "_f64", "_dop853", "_dop853_f64"):
            for kn in ("", "_kn"):
                fn = getattr(lib, BROAD_EXTRAS_ENTRY + kn + suffix)
                fn.argtypes = [_P, _P, _P]
                fn.restype = _I
                fn = getattr(lib, BROAD_EXTRAS_ENTRY + "_describe" + kn
                             + suffix)
                fn.argtypes = [_I, _P]
                fn.restype = _I
            fn = getattr(lib, BROAD_PLANES_ENTRY + suffix)
            fn.argtypes = [_P, _P]
            fn.restype = _I
        return _declare_error_string(lib)
    if library == "surface":
        for suffix in ("", "_f64", "_dop853", "_dop853_f64"):
            fn = getattr(lib, SURFACE_ENTRY + suffix)
            fn.argtypes = [_P]
            fn.restype = _I
        return _declare_error_string(lib)
    for suffix, real in (("", _F), ("_f64", _D)):
        _declare_pair(lib, suffix, variants=False)
        fn = getattr(lib, "lpt_orbit_rk4" + suffix)
        fn.argtypes = [_P] * 6 + [_I] * 2 + [real] * 13 + [_I] * 2 + [_P]
        fn.restype = _I
    fn = lib.lpt_peak_probe
    fn.argtypes = [_I, _P, _P, _I, _I, ctypes.c_double, ctypes.c_double, _P]
    fn.restype = _I
    return _declare_error_string(lib)


def _declare_extras(lib, entry, describe):
    fn = getattr(lib, entry)
    fn.argtypes = [_P, _P]
    fn.restype = _I
    fn = getattr(lib, describe)
    fn.argtypes = [_I, _I, _P]
    fn.restype = _I


def _declare_error_string(lib):
    lib.lpt_cuda_error_string.argtypes = [_I]
    lib.lpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library(library="dp45"):
    """The compiled kernel library `library` ("dp45", "more", "dop853",
    "broad" or "surface"), built on first use. Its `build_log` attribute holds nvcc's
    resource report of the build that made it ('' where that build kept
    none), and
    `build_seconds` the seconds this process spent building it (0.0 when
    it loaded an existing file)."""
    if library not in LIBRARIES:
        raise ValueError(f"no kernel library {library!r}; expected one of "
                         f"{', '.join(LIBRARIES)}")
    path = library_path(library)
    t0 = time.perf_counter()
    built = not path.exists()
    if built:
        log = _compile(path, library)
    elif log_path(path).exists():
        log = log_path(path).read_text()
    else:
        log = ""
    lib = _declare(ctypes.CDLL(str(path)), library)
    lib.build_log = log
    lib.build_seconds = time.perf_counter() - t0 if built else 0.0
    return lib


def check(lib, rc: int, what: str):
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        msg = lib.lpt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
