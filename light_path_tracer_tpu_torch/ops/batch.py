"""Batch tracing driver (whole-grid branch).

The JAX package's `trace_batch` also chunks and difficulty-sorts large
batches and re-traces stragglers in a second pass. Those branches are not
ported: this driver sends the whole batch to one call, and the tensor's
device picks the implementation — the hand-written CUDA kernel for a
CUDA tensor, the plain PyTorch loop for a CPU tensor. Nothing moves a
batch between devices or falls back from one path to the other.
"""

from __future__ import annotations

import math

import torch

from light_path_tracer_tpu_torch.ops.types import TraceResult


def _kerr_backend(backend, alphas):
    """'cuda' (the kernel) for a CUDA tensor, 'torch' (the plain loop)
    for a CPU tensor. backend must be 'auto': in this package the
    device, not a flag, picks the path."""
    if backend != "auto":
        raise ValueError(
            f"backend={backend!r}: this package picks its path from the "
            f"tensor's device; use backend='auto'")
    if alphas.device.type == "cuda":
        return "cuda"
    if alphas.device.type == "cpu":
        return "torch"
    raise ValueError(f"no Kerr tracer for device {alphas.device}")


def trace_batch(metric, r_obs, alphas, thetas=None, theta_obs=math.pi / 2,
                axis_refine=None, *, chunk_size=None, lambda_max=None,
                max_steps=200000, backend="auto", integrator="dp45",
                event_interp="hermite", two_pass="auto",
                formulation="theta", precision="fast"):
    """Trace N rays through `metric`; returns TraceResult of shape (N,).

    lambda_max defaults to max(5000, 6 r_obs). two_pass='auto' traces in
    one pass; the two-pass straggler driver, chunking, other integrators
    and interpolants, and the mu chart raise until they are ported.
    """
    n = int(alphas.shape[0])
    if metric.is_spherically_symmetric:
        raise NotImplementedError(
            "the Schwarzschild orbit tracer is not ported yet "
            "(ROADMAP.md, Queue 1)")
    if chunk_size is not None and chunk_size < n:
        raise NotImplementedError(
            "chunked tracing is not ported yet; use chunk_size=None")
    if two_pass is True:
        raise NotImplementedError("the two-pass driver is not ported yet")
    if integrator != "dp45":
        raise NotImplementedError(
            f"integrator={integrator!r} is not ported yet (dp45 only)")
    if event_interp != "hermite":
        raise NotImplementedError(
            f"event_interp={event_interp!r} is not ported yet "
            f"(hermite only)")

    device = alphas.device
    if n == 0:
        return TraceResult(
            torch.zeros((0,), dtype=alphas.dtype, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int64, device=device))
    if thetas is None:
        thetas = torch.zeros_like(alphas)
    if axis_refine is None:
        axis_refine = torch.zeros(alphas.shape, dtype=torch.bool,
                                  device=device)
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if _kerr_backend(backend, alphas) == "cuda":
        from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
            trace_rays_kerr_cuda as kerr_fn)
    else:
        from light_path_tracer_tpu_torch.ops.kerr_trace import (
            trace_rays_kerr as kerr_fn)
    return kerr_fn(metric, float(r_obs), alphas, thetas, float(theta_obs),
                   axis_refine, float(lambda_max), max_steps,
                   precision=precision, formulation=formulation)
