"""Wrapper of the hand-written CUDA Kerr DP45 kernel (csrc/kerr_dp45.cu).

The counterpart of `light_path_tracer_tpu.ops.pallas.kerr_trace_kernel`
(`trace_rays_kerr_pallas`). The kernel runs one thread per ray: initial
conditions, plunge radius and the whole adaptive loop, writing the final
state, status and per-ray attempt count; the escape angle is extracted
here in torch (`finalize_angles`), as the JAX wrapper does.

`trace_rays_kerr_cuda` launches the kernel on CUDA float32 tensors and
raises on any other CUDA input; it never falls back. Given CPU tensors it
runs the kernel's plain version, the PyTorch loop `trace_rays_kerr_plain`
(ops/kerr_trace.py), because there is no kernel to run there; the tests
and the chip smoke test compare the two.
"""

from __future__ import annotations

import torch

from light_path_tracer_tpu_torch.models.kerr import Kerr
from light_path_tracer_tpu_torch.ops.cuda._build import check, load_library
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    _h_init_for, finalize_angles, get_tols, warp_step_sum)
from light_path_tracer_tpu_torch.ops.kerr_trace import (
    trace_rays_kerr as trace_rays_kerr_plain)
from light_path_tracer_tpu_torch.ops.types import TraceResult

__all__ = ["trace_rays_kerr_cuda", "trace_rays_kerr_plain"]


def _check_inputs(alphas, thetas, axis_refine):
    for name, t, dtype in (("alphas", alphas, torch.float32),
                           ("thetas", thetas, torch.float32),
                           ("axis_refine", axis_refine, torch.bool)):
        if t.dtype != dtype:
            raise ValueError(f"the CUDA Kerr kernel (float32 only) takes "
                             f"{name} as {dtype}, got {t.dtype}")
        if t.device != alphas.device:
            raise ValueError(f"{name} is on {t.device}, alphas on "
                             f"{alphas.device}")
        if t.dim() != 1 or t.shape != alphas.shape:
            raise ValueError(f"{name} must have shape {tuple(alphas.shape)},"
                             f" got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if alphas.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 rays per launch")


def trace_rays_kerr_cuda(metric, r_obs, alphas, thetas, theta_obs,
                         axis_refine, lambda_max: float,
                         max_steps: int = 200000, precision: str = "fast",
                         formulation: str = "theta"):
    """Trace N Kerr rays with the CUDA kernel; returns TraceResult.

    Same arguments and result as trace_rays_kerr_plain. alphas/thetas:
    (N,) contiguous float32 CUDA tensors; axis_refine: (N,) bool on the
    same device. Launches on the current stream and does not synchronise.
    CPU tensors go to the plain version; other devices raise.
    """
    if alphas.device.type == "cpu":
        return trace_rays_kerr_plain(
            metric, r_obs, alphas, thetas, theta_obs, axis_refine,
            lambda_max, max_steps, precision=precision,
            formulation=formulation)
    if alphas.device.type != "cuda":
        raise ValueError(f"no Kerr kernel for device {alphas.device}")
    if formulation != "theta":
        raise NotImplementedError(
            f"formulation={formulation!r}: the CUDA kernel integrates the "
            f"theta chart only")
    if not isinstance(metric, Kerr):
        raise TypeError(f"the CUDA kernel traces Kerr, got "
                        f"{type(metric).__name__}")
    _check_inputs(alphas, thetas, axis_refine)
    if max_steps >= 2**31:
        raise ValueError("max_steps must fit in int32")

    n = alphas.numel()
    state = torch.empty((5, n), dtype=torch.float32, device=alphas.device)
    status = torch.empty(n, dtype=torch.int32, device=alphas.device)
    attempts = torch.empty(n, dtype=torch.int32, device=alphas.device)
    tols = get_tols(torch.float32, precision)
    lib = load_library()
    with torch.cuda.device(alphas.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lpt_kerr_dp45(
            alphas.data_ptr(), thetas.data_ptr(), axis_refine.data_ptr(),
            *(state[c].data_ptr() for c in range(5)),
            status.data_ptr(), attempts.data_ptr(), n,
            float(metric.M), float(metric.a), float(metric.r_plus),
            float(r_obs), float(theta_obs), float(lambda_max),
            int(max_steps),
            tols["atol"], tols["rtol"], tols["atol_ref"], tols["rtol_ref"],
            tols["h_min"], tols["tiny_err"],
            _h_init_for(r_obs), float(metric.capture_radius()), stream)
    check(lib, rc, "kerr_dp45 launch")
    trace_rays_kerr_cuda.launches += 1

    _y0, p_t, p_phi, _inv = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    final_alpha, n_half, status_out = finalize_angles(
        metric, state, p_t, p_phi, status)
    return TraceResult(final_alpha, n_half, status_out,
                       warp_step_sum(attempts))


# Kernel launches, so a run can show that it went through the kernel.
trace_rays_kerr_cuda.launches = 0
