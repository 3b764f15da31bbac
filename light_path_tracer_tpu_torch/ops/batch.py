"""Batch tracing driver (whole-grid branch).

Spherically symmetric metrics (Schwarzschild, Reissner-Nordstrom) go to
the orbit-equation tracer, Kerr to the DP45 tracer: on the kernel in one
pass or, for large batches, through the two-pass straggler driver; on the
plain loop in one pass, as the JAX package's XLA branch ignores
`two_pass`. The JAX package's
`trace_batch` also chunks and difficulty-sorts large Kerr batches; that
branch is not ported: here the whole batch goes to one call. The
tensor's device picks the implementation — the hand-written CUDA kernel
for a CUDA tensor, the plain PyTorch loop for a CPU tensor. Nothing moves
a batch between devices or falls back from one path to the other.
"""

from __future__ import annotations

import math

import torch

from light_path_tracer_tpu_torch.ops.types import TraceResult


def _backend(backend, alphas):
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
    raise ValueError(f"no tracer for device {alphas.device}")


def trace_batch(metric, r_obs, alphas, thetas=None, theta_obs=math.pi / 2,
                axis_refine=None, *, chunk_size=None, lambda_max=None,
                max_steps=200000, phi_max=50.0, h_max=0.05,
                backend="auto", integrator="dp45",
                event_interp="hermite", two_pass="auto", pass1_steps=512,
                formulation="theta", precision="fast"):
    """Trace N rays through `metric`; returns TraceResult of shape (N,).

    Spherically symmetric metrics trace the orbit equation in phi
    (phi_max, h_max); the Kerr-only arguments do not apply to them.
    lambda_max defaults to max(5000, 6 r_obs). two_pass: 'auto' | True |
    False — on the kernel (CUDA tensors, float32 or float64) the
    straggler driver (a `pass1_steps`-capped pass, then a full-depth
    re-trace of the rays still running); 'auto' turns it on above
    2,000,000 rays, the JAX package's rule for its kernel path. The plain
    loop (CPU tensors) ignores it, as the JAX package's XLA branch does.
    Chunking, other integrators and interpolants, and the mu chart raise
    until they are ported.
    """
    n = int(alphas.shape[0])
    device = alphas.device
    if n == 0:
        return TraceResult(
            torch.zeros((0,), dtype=alphas.dtype, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int64, device=device))

    if metric.is_spherically_symmetric:
        if _backend(backend, alphas) == "cuda":
            from light_path_tracer_tpu_torch.ops.cuda.schwarzschild_kernel \
                import trace_rays_schwarzschild_cuda as orbit_fn
        else:
            from light_path_tracer_tpu_torch.ops.schwarzschild_trace import (
                trace_rays_schwarzschild as orbit_fn)
        return orbit_fn(metric, float(r_obs), alphas, phi_max=phi_max,
                        h_max=h_max)

    if chunk_size is not None and chunk_size < n:
        raise NotImplementedError(
            "chunked tracing is not ported yet; use chunk_size=None")
    if integrator != "dp45":
        raise NotImplementedError(
            f"integrator={integrator!r} is not ported yet (dp45 only)")
    if event_interp != "hermite":
        raise NotImplementedError(
            f"event_interp={event_interp!r} is not ported yet "
            f"(hermite only)")

    if thetas is None:
        thetas = torch.zeros_like(alphas)
    if axis_refine is None:
        axis_refine = torch.zeros(alphas.shape, dtype=torch.bool,
                                  device=device)
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    # 'auto' two-pass is batch-size dependent, as in the JAX package: the
    # 2M-ray threshold was set on a TPU, where one straggler pins an
    # 8192-lane tile; PERF.md records what it does on the H100. Only the
    # kernel path takes it.
    path = _backend(backend, alphas)
    use_two_pass = path == "cuda" and (two_pass if two_pass != "auto"
                                       else n > 2_000_000)
    kwargs = dict(precision=precision, formulation=formulation)
    if use_two_pass:
        from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
            trace_rays_kerr_two_pass as kerr_fn)
        kwargs["pass1_steps"] = pass1_steps
    elif path == "cuda":
        from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
            trace_rays_kerr_cuda as kerr_fn)
    else:
        from light_path_tracer_tpu_torch.ops.kerr_trace import (
            trace_rays_kerr as kerr_fn)
    return kerr_fn(metric, float(r_obs), alphas, thetas, float(theta_obs),
                   axis_refine, float(lambda_max), max_steps, **kwargs)
