"""Wrapper of the hand-written CUDA orbit kernel (csrc/schwarzschild_rk4.cu).

The counterpart of `light_path_tracer_tpu.ops.pallas.schwarzschild_kernel`
(`trace_rays_schwarzschild_pallas`). The kernel runs one thread per ray:
the orbit initial state, the fixed-step RK4 loop in phi with its capture
and escape crossings, the final-angle extraction and the status fold, so
a call is one launch plus the allocation of its outputs. It serves
Schwarzschild and Reissner-Nordstrom; the metric's constants are kernel
arguments, each computed in double here: rounded once to float32 for the
float instance, as the JAX float32 path rounds its Python-float
constants, and passed unrounded to the float64 instance (entry
`lpt_orbit_rk4_f64`), as the reference's float64 path runs.

`trace_rays_schwarzschild_cuda` launches the kernel on CUDA float32 or
float64 tensors (launches counted per dtype: `.launches`,
`.launches_f64`) and raises on any other CUDA input; it never falls back.
Given a
CPU tensor it runs the kernel's plain version, the PyTorch loop
`trace_rays_schwarzschild_plain` (ops/schwarzschild_trace.py), because
there is no kernel to run there; the tests and the chip smoke test
compare the two.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.reissner_nordstrom import (
    ReissnerNordstrom)
from light_path_tracer_tpu_torch.models.schwarzschild import Schwarzschild
from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library
from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
    count_launch, entry_suffix)
from light_path_tracer_tpu_torch.ops.schwarzschild_trace import (
    orbit_constants)
from light_path_tracer_tpu_torch.ops.schwarzschild_trace import (
    trace_rays_schwarzschild as trace_rays_schwarzschild_plain)
from light_path_tracer_tpu_torch.ops.types import TraceResult

__all__ = ["trace_rays_schwarzschild_cuda", "trace_rays_schwarzschild_plain"]


def _kernel_constants(metric, r_obs, phi_max, h_max, dtype):
    """The kernel's scalar arguments after (n, charged), in its order, for
    the instance of `dtype`."""
    M = float(metric.M)
    Q = float(getattr(metric, "Q", 0.0))
    f0 = float(metric.f(r_obs))
    u_capture, u_escape, n_steps = orbit_constants(metric, r_obs, phi_max,
                                                   h_max)
    # JAX forms 2 M as arithmetic in the dtype on M in the dtype.
    two_M = (2.0 * M if dtype == torch.float64
             else float(np.float32(2.0) * np.float32(M)))
    floats = (r_obs, float(np.sqrt(max(f0, 1e-300))), 1.0 / r_obs, two_M,
              Q * Q, 3.0 * M, 2.0 * Q * Q, u_capture, u_escape,
              float(phi_max), float(h_max), float(np.pi),
              metric.R_S * 1.1)
    return floats + (n_steps, int(f0 <= 0.0))


def trace_rays_schwarzschild_cuda(metric, r_obs, alphas,
                                  phi_max: float = 50.0,
                                  h_max: float = 0.05,
                                  return_steps: bool = False):
    """Trace N spherically symmetric rays with the CUDA kernel.

    Same arguments and result as trace_rays_schwarzschild_plain. alphas:
    (N,) contiguous float32 or float64 CUDA tensor. Launches on the current
    stream
    and does not synchronise. CPU tensors go to the plain version; other
    devices raise.
    """
    if alphas.device.type == "cpu":
        return trace_rays_schwarzschild_plain(
            metric, r_obs, alphas, phi_max, h_max, return_steps=return_steps)
    if alphas.device.type != "cuda":
        raise ValueError(f"no orbit kernel for device {alphas.device}")
    if not isinstance(metric, Schwarzschild):
        raise TypeError(f"the orbit kernel traces Schwarzschild and "
                        f"Reissner-Nordstrom, got {type(metric).__name__}")
    suffix = entry_suffix(alphas.dtype)
    if alphas.dim() != 1:
        raise ValueError(f"alphas must be 1-D, got shape "
                         f"{tuple(alphas.shape)}")
    if not alphas.is_contiguous():
        raise ValueError("alphas must be contiguous")
    n = alphas.numel()
    if n >= 2**31:
        raise ValueError("at most 2**31 - 1 rays per launch")

    r_obs = float(r_obs)
    consts = _kernel_constants(metric, r_obs, phi_max, h_max, alphas.dtype)
    dev = alphas.device
    final_alpha = torch.empty(n, dtype=alphas.dtype, device=dev)
    n_half = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(n, dtype=torch.int32, device=dev)
    steps = (torch.empty(n, dtype=torch.int32, device=dev) if return_steps
             else None)
    n_steps = torch.empty((), dtype=torch.int64, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "lpt_orbit_rk4" + suffix)(
            alphas.data_ptr(), final_alpha.data_ptr(), n_half.data_ptr(),
            status.data_ptr(), None if steps is None else steps.data_ptr(),
            n_steps.data_ptr(), n, int(isinstance(metric, ReissnerNordstrom)),
            *consts, stream)
    check(lib, rc, f"orbit_rk4{suffix} launch")
    count_launch(trace_rays_schwarzschild_cuda, alphas.dtype)
    res = TraceResult(final_alpha, n_half, status, n_steps)
    return (res, steps) if return_steps else res


# Kernel launches per dtype, so a run can show that it went through the
# kernel.
trace_rays_schwarzschild_cuda.launches = 0
trace_rays_schwarzschild_cuda.launches_f64 = 0
