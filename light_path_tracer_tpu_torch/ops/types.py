"""Shared result types for batched ray tracing."""

from __future__ import annotations

from typing import NamedTuple

import torch


class TraceResult(NamedTuple):
    """Per-ray tracing outcome (structure-of-arrays over N rays).

    status: 1 escaped, -1 captured, 0 invalid (rays that ran out of
    affine length are folded into escaped or captured at extraction).
    final_alpha is NaN for captured/invalid rays.
    """

    final_alpha: torch.Tensor    # (N,) float
    n_half_orbits: torch.Tensor  # (N,) int32
    status: torch.Tensor         # (N,) int32
    # () int64 — total sequential step work actually executed. The CUDA
    # kernel runs one thread per ray, and a warp of 32 consecutive rays
    # runs until its slowest lane is done, so the count is the sum, over
    # groups of 32 consecutive rays, of the group's largest per-ray
    # attempt count (ops.kerr_trace.warp_step_sum). The plain PyTorch
    # loop reports the same quantity from its own per-ray counts.
    n_steps: torch.Tensor
