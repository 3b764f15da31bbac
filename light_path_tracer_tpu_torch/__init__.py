"""PyTorch/CUDA port of light_path_tracer_tpu, the general-relativistic
ray tracer.

The JAX package `light_path_tracer_tpu` is the reference; this package
mirrors its layout and names module by module, in plain PyTorch, with
every TPU kernel on a ported path rewritten as a hand-written CUDA kernel
for Hopper (csrc/). Ported so far: the Kerr shadow main path —
`render_shadow` through the whole-grid `trace_batch` to the CUDA DP45
kernel (`ops/cuda/kerr_trace_kernel.py`) on a CUDA device, or to its
plain PyTorch loop (`ops/kerr_trace.py`) on the CPU.

This package imports torch and never jax.
"""

from light_path_tracer_tpu_torch.models import Kerr, make_metric
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.ops.types import TraceResult
from light_path_tracer_tpu_torch.pipeline import (
    precompute_final_alpha, render_shadow)
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig

__all__ = ["Kerr", "make_metric", "trace_batch", "TraceResult",
           "precompute_final_alpha", "render_shadow", "RenderConfig",
           "SceneConfig"]
