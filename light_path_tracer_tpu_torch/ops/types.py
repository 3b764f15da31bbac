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


class VolumetricResult(NamedTuple):
    """Per-ray volumetric radiative-transfer trace outcome
    (`light_path_tracer_tpu.ops.types.VolumetricResult`, the same fields
    in the same order).

    emission is the path integral of the emissivity weight, integrated
    as an error-controlled extra state component; 0 for lanes whose
    integration went INVALID. With absorption it is the self-absorbed
    integral of j g^p exp(-tau) and optical_depth the ray's total tau
    (zeros when optically thin). final_alpha / n_half_orbits / status /
    n_steps follow TraceResult.
    """

    emission: torch.Tensor       # (N,) float
    final_alpha: torch.Tensor    # (N,) float
    n_half_orbits: torch.Tensor  # (N,) int32
    status: torch.Tensor         # (N,) int32
    n_steps: torch.Tensor        # () int64
    optical_depth: torch.Tensor  # (N,) float


class SpectralResult(NamedTuple):
    """Per-ray multi-frequency transfer outcome
    (`light_path_tracer_tpu.ops.types.SpectralResult`): emission[i] is
    band i's self-absorbed intensity, all bands from one trace sharing
    the reduced optical depth tau_hat."""

    emission: tuple              # n_bands x (N,) float
    tau_hat: torch.Tensor        # (N,) float
    final_alpha: torch.Tensor    # (N,) float
    n_half_orbits: torch.Tensor  # (N,) int32
    status: torch.Tensor         # (N,) int32
    n_steps: torch.Tensor        # () int64


class ExtrasResult(NamedTuple):
    """Per-ray outcome of the generic coupled-extras trace
    (`light_path_tracer_tpu.ops.types.ExtrasResult`): n error-controlled
    path-integral components accumulated along each geodesic."""

    extras: tuple                # n x (N,) float
    final_alpha: torch.Tensor    # (N,) float
    n_half_orbits: torch.Tensor  # (N,) int32
    status: torch.Tensor         # (N,) int32
    n_steps: torch.Tensor        # () int64


class DiskTraceResult(NamedTuple):
    """Per-ray disk-mode trace output (`light_path_tracer_tpu.disk.
    DiskTraceResult`, the same fields in the same order).

    n_hits counts the in-disk crossings recorded (at most max_hits);
    slot k of r_hits / phi_hits (and pr_hits / pth_hits with
    record_momentum) holds the k-th crossing's radius, physical azimuth
    and momenta, 0 where there was none. xi = L/E = p_phi per ray.
    final_alpha / n_half are the escape heading and winding of the final
    state (NaN final_alpha unless escaped); for an opaque disk they mean
    something only on rays with n_hits == 0, since a hit ray parks at its
    crossing. n_steps follows TraceResult's contract. xi_hits (tilted
    disks), t_hits and t_end (record_time) stay empty in this package.
    """

    status: torch.Tensor
    n_hits: torch.Tensor
    r_hits: tuple
    xi: torch.Tensor
    n_steps: torch.Tensor
    final_alpha: torch.Tensor
    n_half: torch.Tensor
    phi_hits: tuple = ()
    xi_hits: tuple = ()
    pr_hits: tuple = ()
    pth_hits: tuple = ()
    t_hits: tuple = ()
    t_end: tuple = ()


class SurfaceResult(NamedTuple):
    """Per-ray opaque-spherical-surface trace outcome
    (`light_path_tracer_tpu.ops.types.SurfaceResult`, field for field).

    status CAPTURED means the ray hit the sphere r = r_surface: theta,
    phi are its raw chart coordinates there (double-cover theta,
    cumulative phi) and p_r, p_theta its momentum. ESCAPED rays keep
    their Hermite-localised state at r = 2 r_obs (the raw escape state
    of the lens-map products) and their escape heading in final_alpha /
    n_half_orbits, as in TraceResult. xi = L/E per ray; t_hit the
    coordinate time from the camera (0 unless the trace recorded it).
    """

    theta: torch.Tensor          # (N,) float
    phi: torch.Tensor            # (N,) float
    p_r: torch.Tensor            # (N,) float
    p_theta: torch.Tensor        # (N,) float
    xi: torch.Tensor             # (N,) float
    t_hit: torch.Tensor          # (N,) float
    final_alpha: torch.Tensor    # (N,) float
    n_half_orbits: torch.Tensor  # (N,) int32
    status: torch.Tensor         # (N,) int32
    n_steps: torch.Tensor        # () int64
