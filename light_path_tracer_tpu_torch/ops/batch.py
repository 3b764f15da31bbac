"""Batch tracing driver: whole-grid, chunked and difficulty-sorted.

Spherically symmetric metrics (Schwarzschild, Reissner-Nordstrom) go to
the orbit-equation tracer, Kerr to the adaptive tracer (DP45 or DOP853,
with Hermite or linear event location): on the kernel in one
pass or, for large batches, through the two-pass straggler driver; on the
plain loop in one pass, as the JAX package's XLA branch ignores
`two_pass`. `integrator="rk4"` selects the fixed-step RK4 tracer
(ops/kerr_rk4.py) on any device, and a metric with no kernel
(`supports_kernel = False`: `CustomMetric`, whose RHS is autograd of a
user callable) traces on the plain loop on any device, as the JAX
package routes both to XLA. A Kerr batch above `chunk_size` rays is traced in chunks of
that size, optionally sorted by expected difficulty (|alpha -
alpha_crit|, photon-ring grazers integrate longest) so that stragglers
share chunks, then restored to the input order: the JAX package's
chunked branch. The tensor's device picks the implementation — the
hand-written CUDA kernel for a CUDA tensor, the plain PyTorch loop for a
CPU tensor. Nothing moves a batch between devices or falls back from one
path to the other.
"""

from __future__ import annotations

import math

import torch

from light_path_tracer_tpu_torch.ops.kerr_trace import check_method
from light_path_tracer_tpu_torch.ops.types import TraceResult
from light_path_tracer_tpu_torch.utils.progress import chunk_iterator


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


def _pad_to(x, n, fill):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                    device=x.device)])


def difficulty_order(metric, r_obs, theta_obs, alphas):
    """The chunked branch's ray order: by |alpha - alpha_crit| (photon-ring
    grazers integrate longest), a stable sort so that ties keep their
    input order, as jnp.argsort does."""
    alpha_crit = metric.alpha_crit(float(r_obs), float(theta_obs),
                                  device=alphas.device)
    return torch.argsort(torch.abs(alphas - alpha_crit), stable=True)


def trace_batch(metric, r_obs, alphas, thetas=None, theta_obs=math.pi / 2,
                axis_refine=None, *, chunk_size=None, sort_by_difficulty=True,
                lambda_max=None, max_steps=200000, phi_max=50.0, h_max=0.05,
                backend="auto", integrator="dp45",
                event_interp="hermite", two_pass="auto", pass1_steps=512,
                formulation="theta", precision="fast", progress=False,
                chunk_store=None):
    """Trace N rays through `metric`; returns TraceResult of shape (N,).

    Spherically symmetric metrics trace the orbit equation in phi
    (phi_max, h_max); the Kerr-only arguments do not apply to them.
    lambda_max defaults to max(5000, 6 r_obs). two_pass: 'auto' | True |
    False — on the kernel (CUDA tensors, float32 or float64) the
    straggler driver (a `pass1_steps`-capped pass, then a full-depth
    re-trace of the rays still running); 'auto' turns it on above
    2,000,000 rays of the whole batch, the JAX package's rule for its
    kernel path, and then drives each chunk. The plain loop (CPU tensors)
    ignores it, as the JAX package's XLA branch does.
    chunk_size: trace a Kerr batch of more rays in chunks of this many,
    sorted by |alpha - alpha_crit| first when sort_by_difficulty (a
    stable sort, so ties keep their input order) and padded with easy
    far-field rays; n_steps sums the chunks' counts on the device.
    integrator: "dp45" or "dop853"; event_interp: "hermite" or "linear";
    any other value raises ValueError. formulation="mu" traces each batch
    (or chunk) through the hybrid tracer: the mu chart in bulk, the rays
    near the polar axis re-traced in theta; on the kernel with the JAX
    Pallas backend's semantics (ops/cuda/kerr_trace_kernel.py, its first
    pass capped at `pass1_steps` when two-pass is on), on the plain loop
    with its XLA backend's (ops/kerr_trace.py). integrator="rk4" traces
    the fixed-step RK4 loop (ops/kerr_rk4.py) on the rays' device, with
    h_max its base step 1.0; a metric with supports_kernel False traces
    the plain loop on the rays' device.
    progress (chunked path only): False, True (a tqdm bar) or "live" (the
    ANSI bar with CPU and RSS telemetry, utils/progress.py); on a CUDA
    device each chunk is synchronised before the bar moves.
    chunk_store (chunked path only): a checkpoint.ChunkStore; each chunk
    found in it is taken from it (moved to the rays' device) instead of
    traced, and each traced chunk is put into it as it completes, so an
    interrupted trace resumes from its last completed chunk. With neither
    a bar nor a store the chunks launch with no host sync between them.
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

    if integrator != "rk4":
        check_method(integrator, event_interp)

    if thetas is None:
        thetas = torch.zeros_like(alphas)
    if axis_refine is None:
        axis_refine = torch.zeros(alphas.shape, dtype=torch.bool,
                                  device=device)
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    # 'auto' two-pass is batch-size dependent, as in the JAX package: the
    # 2M-ray threshold of the whole batch (which then drives each chunk)
    # was set on a TPU, where one straggler pins an 8192-lane tile;
    # PERF.md records what it does on the H100. Only the kernel path
    # takes it.
    if not getattr(metric, "supports_kernel", True):
        if backend == "cuda":
            raise ValueError(
                f"{type(metric).__name__} has no CUDA kernel (its RHS is "
                f"autograd of a user callable); use backend='auto'")
        _backend(backend, alphas)
        path = "torch"
    else:
        path = _backend(backend, alphas)
    use_two_pass = path == "cuda" and (two_pass if two_pass != "auto"
                                       else n > 2_000_000)
    kwargs = dict(precision=precision, formulation=formulation,
                  method=integrator, event_interp=event_interp)
    if integrator == "rk4":
        from light_path_tracer_tpu_torch.ops.kerr_rk4 import (
            trace_rays_kerr_rk4 as kerr_fn)
        kwargs = {}
    elif formulation == "mu":
        # The mu bulk with the theta pole re-trace, as the JAX package's
        # production branch (ops/batch.py there).
        kwargs = dict(precision=precision, method=integrator,
                      event_interp=event_interp)
        if path == "cuda":
            from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel \
                import trace_rays_kerr_hybrid as kerr_fn
            kwargs["pass1_steps"] = pass1_steps if use_two_pass else None
        else:
            from light_path_tracer_tpu_torch.ops.kerr_trace import (
                trace_rays_kerr_hybrid as kerr_fn)
    elif use_two_pass:
        from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
            trace_rays_kerr_two_pass as kerr_fn)
        kwargs["pass1_steps"] = pass1_steps
    elif path == "cuda":
        from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
            trace_rays_kerr_cuda as kerr_fn)
    else:
        from light_path_tracer_tpu_torch.ops.kerr_trace import (
            trace_rays_kerr as kerr_fn)

    def trace(a, t, ar):
        return kerr_fn(metric, float(r_obs), a, t, float(theta_obs), ar,
                       float(lambda_max), max_steps, **kwargs)

    if chunk_size is None or chunk_size >= n:
        return trace(alphas, thetas, axis_refine)

    if sort_by_difficulty:
        order = difficulty_order(metric, r_obs, theta_obs, alphas)
        inv_order = torch.empty_like(order)
        inv_order[order] = torch.arange(n, device=device)
        a_s, t_s, ar_s = alphas[order], thetas[order], axis_refine[order]
    else:
        inv_order = None
        a_s, t_s, ar_s = alphas, thetas, axis_refine

    n_pad = -(-n // chunk_size) * chunk_size
    # Easy far-field rays, so padding lanes end at once.
    a_s = _pad_to(a_s, n_pad, math.pi / 2)
    t_s = _pad_to(t_s, n_pad, 0.0)
    ar_s = _pad_to(ar_s, n_pad, False)

    sync_bar = bool(progress) and device.type == "cuda"
    chunks = []
    for s in chunk_iterator(range(0, n_pad, chunk_size), progress):
        res = chunk_store.get(s) if chunk_store is not None else None
        if res is not None:
            res = TraceResult(*(x.to(device) for x in res))
        else:
            res = trace(a_s[s:s + chunk_size], t_s[s:s + chunk_size],
                        ar_s[s:s + chunk_size])
            if chunk_store is not None:
                chunk_store.put(s, res)      # its .cpu() waits for the chunk
            elif sync_bar:
                torch.cuda.synchronize(device)
        chunks.append(res)
    fa = torch.cat([c.final_alpha for c in chunks])[:n]
    nh = torch.cat([c.n_half_orbits for c in chunks])[:n]
    st = torch.cat([c.status for c in chunks])[:n]
    # The step count stays on the device: no host sync per chunk.
    steps = torch.stack([c.n_steps for c in chunks]).sum()
    if inv_order is not None:
        fa, nh, st = fa[inv_order], nh[inv_order], st[inv_order]
    return TraceResult(fa, nh, st, steps)
