"""Wrapper of the hand-written CUDA surface kernel (csrc/kerr_surface.cuh
through csrc/kerr_surface.cu and its siblings): rays traced onto an
opaque sphere, their raw end state kept.

The counterpart of `light_path_tracer_tpu.ops.kerr_trace.trace_rays_surface`
(an XLA loop in the JAX package, the primitive of its lens-map products
and of star.py). One thread a ray runs the initial conditions, the
adaptive loop with the sphere r = r_surface as its capture event and
r = 2 r_obs as its escape event (base tolerances on every ray, no
certain-plunge exit, Hermite event location), and the angle extraction,
and writes the raw end state (r, theta, phi, p_r, p_theta), xi = L/E and
the extraction's outputs. With record_time the state carries the
coordinate time as a sixth error-controlled component (dt/dlambda = the
metric's g^tt p_t + g^tphi p_phi), shortened to the event point with the
rest; the instance without it integrates five.

The Kerr kernel's shadow instances cannot stand in for it: their
certain-plunge exit ends a plunging ray inside the photon-orbit band,
not on the surface, so its raw state and attempts would differ from the
loop's. The instances, both pairs ("dp45", "dop853") and both dtypes,
trace Kerr, Kerr-Newman and Johannsen-Psaltis (the family a template
argument, named by the metric's exact class; a Kerr-Newman metric at
Q = 0 launches the Kerr instance), with and without the time component;
they form the library `_build.load_library("surface")`, built at their
first launch. The float64 ones raise to the step-control exponent
through the contracted pow of csrc/lpt_pow_f64.cu, as PyTorch's float64
pow does on the card.

`trace_rays_surface_cuda` launches the kernel on CUDA float32 or float64
tensors and raises on any other CUDA input (another dtype, another
metric class, another method); it never falls back. CPU tensors run the
plain loop (`ops/kerr_trace.trace_rays_surface`). Each instance counts
its launches on a counter of its own (`instance_counter`: the family it
launched, "_time" with the time component, the pair and the dtype, as
`.launches_kerr`, `.launches_kerr_newman_time_f64`,
`.launches_johannsen_psaltis_dop853`).
"""

from __future__ import annotations

import ctypes

import torch

from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    _check_call, _check_inputs, counter_name, entry_suffix,
    family_scalars, method_suffix)
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    _h_init_for, check_method, get_tols, trace_rays_surface)
from light_path_tracer_tpu_torch.ops.types import SurfaceResult

ENTRY = "lpt_kerr_surface"
# The instances' families by KerrCall's family code, as their launch
# counters name them.
FAMILY_NAMES = {0: "kerr", 1: "kerr_newman", 2: "johannsen_psaltis"}


def instance_counter(dtype, method, family, record_time) -> str:
    """The launch counter of one instance: "launches_" + the family (as
    FAMILY_NAMES names it) + "_time" with the time component, then the
    pair's and the dtype's suffixes (launches_kerr, launches_kerr_f64,
    launches_johannsen_psaltis_time_dop853, ...)."""
    return counter_name(dtype, method, FAMILY_NAMES[family]
                        + ("_time" if record_time else ""))


def _counters():
    return [instance_counter(dtype, method, family, timed)
            for dtype in (torch.float32, torch.float64)
            for method in ("dp45", "dop853")
            for family in FAMILY_NAMES for timed in (False, True)]


def _call_fields(real):
    """SurfaceCall<T>'s fields (csrc/kerr_surface.cuh) with real the
    ctypes type of T: the device pointers and the stream, the ints, then
    the scalars."""
    return ([(name, ctypes.c_void_p) for name in (
        "alpha", "theta", "final_alpha", "n_half", "status", "state",
        "t_hit", "xi", "steps", "warp_steps", "stream")]
        + [(name, ctypes.c_int) for name in (
            "n", "max_steps", "family", "record_time")]
        + [(name, real) for name in (
            "M", "a", "r_plus", "r_obs", "theta_obs", "lambda_max", "atol",
            "rtol", "h_min", "tiny_err", "h_init", "r_capture", "r_reclass",
            "q2", "eps3", "r_freeze")])


class SurfaceCall(ctypes.Structure):
    """The float instances' SurfaceCall<float>, field for field."""

    _fields_ = _call_fields(ctypes.c_float)


class SurfaceCall64(ctypes.Structure):
    """The float64 instances' SurfaceCall<double>, field for field."""

    _fields_ = _call_fields(ctypes.c_double)


def zero_counters():
    """Set every launch counter of trace_rays_surface_cuda to 0."""
    for name in _counters():
        setattr(trace_rays_surface_cuda, name, 0)


def launches() -> dict:
    """The launches trace_rays_surface_cuda has counted, by counter."""
    return {name: getattr(trace_rays_surface_cuda, name)
            for name in _counters()}


def trace_rays_surface_cuda(metric, r_obs, alphas, thetas, theta_obs,
                            r_surface: float, lambda_max: float,
                            max_steps: int = 200000,
                            precision: str = "fast", method: str = "dp45",
                            record_time: bool = False,
                            probe: dict | None = None):
    """Trace rays onto the opaque sphere r = r_surface with the CUDA
    surface kernel; returns SurfaceResult.

    Same arguments and result as ops.kerr_trace.trace_rays_surface.
    alphas/thetas: (N,) contiguous CUDA tensors, both float32 or both
    float64. probe: a dict that receives the per-ray "attempts". One
    launch on the current stream, which does not synchronise. CPU
    tensors go to the plain loop; other devices raise.
    """
    if not _check_call(alphas, metric, "theta", max_steps):
        return trace_rays_surface(
            metric, r_obs, alphas, thetas, theta_obs, r_surface,
            lambda_max, max_steps, precision=precision, method=method,
            record_time=record_time)
    check_method(method)
    _check_inputs((("alphas", alphas, None), ("thetas", thetas, None)),
                  alphas)
    n = alphas.numel()
    dtype, dev = alphas.dtype, alphas.device
    suffix = entry_suffix(dtype)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)
    state = empty(5, n)
    final_alpha, xi = empty(n), empty(n)
    t_hit = empty(n) if record_time else torch.zeros(n, dtype=dtype,
                                                     device=dev)
    n_half, status = empty(n, dt=torch.int32), empty(n, dt=torch.int32)
    n_steps = empty(dt=torch.int64)
    steps = empty(n, dt=torch.int32) if probe is not None else None
    tols = get_tols(dtype, precision)
    fam = family_scalars(metric)
    entry = ENTRY + method_suffix(method) + suffix
    lib = load_library("surface")
    with torch.cuda.device(dev):
        call = (SurfaceCall64 if suffix else SurfaceCall)(
            alpha=alphas.data_ptr(), theta=thetas.data_ptr(),
            final_alpha=final_alpha.data_ptr(), n_half=n_half.data_ptr(),
            status=status.data_ptr(), state=state.data_ptr(),
            t_hit=t_hit.data_ptr() if record_time else None,
            xi=xi.data_ptr(),
            steps=None if steps is None else steps.data_ptr(),
            warp_steps=n_steps.data_ptr(),
            stream=torch.cuda.current_stream().cuda_stream,
            n=n, max_steps=int(max_steps), family=fam["family"],
            record_time=int(bool(record_time)),
            M=float(metric.M), a=float(metric.a),
            r_plus=float(metric.r_plus), r_obs=float(r_obs),
            theta_obs=float(theta_obs), lambda_max=float(lambda_max),
            atol=tols["atol"], rtol=tols["rtol"], h_min=tols["h_min"],
            tiny_err=tols["tiny_err"], h_init=_h_init_for(r_obs),
            r_capture=float(r_surface),
            r_reclass=float(metric.capture_radius() * 1.1),
            q2=fam["q2"], eps3=fam["eps3"], r_freeze=fam["r_freeze"])
        rc = getattr(lib, entry)(ctypes.byref(call))
    check(lib, rc, f"{entry} launch")
    name = instance_counter(dtype, method, fam["family"], record_time)
    setattr(trace_rays_surface_cuda, name,
            getattr(trace_rays_surface_cuda, name) + 1)
    if probe is not None:
        probe["attempts"] = steps
    return SurfaceResult(state[1], state[2], state[3], state[4], xi, t_hit,
                         final_alpha, n_half, status, n_steps)


# Kernel launches per pair, dtype and instance set, so a run can show
# that it went through the kernel.
zero_counters()

__all__ = ["trace_rays_surface_cuda", "trace_rays_surface", "SurfaceCall",
           "SurfaceCall64", "instance_counter", "launches", "zero_counters"]
