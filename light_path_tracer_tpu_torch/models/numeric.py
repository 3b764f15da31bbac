"""Numeric (trace-based) geometry for metrics without closed forms.

The counterpart of `light_path_tracer_tpu.models.numeric`. Families
without Carter separability (Johannsen-Psaltis) have no closed-form
shadow envelope, so the critical angle is measured from the integrator
itself: per screen azimuth, bisect the capture/escape boundary in viewing
angle and return the envelope maximum. Each bisection step is one float64
trace of `n_azimuth` rays on `device`: the CUDA kernel's float64 instance
on a CUDA device, its plain loop on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def alpha_crit_traced(metric, r_obs, theta_obs=None, n_azimuth: int = 16,
                      iters: int = 26, max_steps: int = 60000,
                      device=None, probe: list | None = None) -> float:
    """Shadow-envelope critical angle by bisection on traced outcomes.

    Works for any metric the Kerr-family tracer accepts. Invalid and
    step-exhausted lanes count as captured (a clean escape always
    classifies). The upper edge starts at 3x the Schwarzschild critical
    angle and doubles while a boundary ray still fails to escape, so a
    strong deformation cannot hide behind the bracket. device: None
    traces on the card. probe: on the card, a list that receives each
    launch's probe dict (trace_rays_kerr_cuda's: per-ray attempts and raw
    state) beside its result's warp step sum, as "n_steps".
    """
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_rays_kerr_cuda)
    from light_path_tracer_tpu_torch.ops.kerr_trace import ESCAPED
    if theta_obs is None:
        theta_obs = np.pi / 2
    device = torch.device("cuda" if device is None else device)
    thetas = torch.as_tensor(
        np.linspace(0.0, 2.0 * np.pi, n_azimuth, endpoint=False) + 0.05,
        dtype=torch.float64, device=device)
    refine = torch.zeros(n_azimuth, dtype=torch.bool, device=device)

    def not_escaped(angles):
        launch = None if probe is None else {}
        res = trace_rays_kerr_cuda(
            metric, float(r_obs),
            torch.as_tensor(angles, dtype=torch.float64, device=device),
            thetas, float(theta_obs), refine,
            lambda_max=max(5000.0, 6.0 * float(r_obs)),
            max_steps=max_steps, probe=launch)
        if probe is not None:
            probe.append(dict(launch, n_steps=res.n_steps))
        return res.status.cpu().numpy() != ESCAPED

    b_schw = 3.0 * np.sqrt(3.0) * metric.M
    hi0 = min(np.pi / 2, 3.0 * np.arcsin(
        min(1.0, b_schw / float(r_obs))))
    lo = np.full(n_azimuth, 1e-5)
    hi = np.full(n_azimuth, hi0)
    for _ in range(6):
        if not not_escaped(hi).any() or hi.max() >= np.pi / 2:
            break
        hi = np.minimum(hi * 2.0, np.pi / 2)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cap = not_escaped(mid)
        lo = np.where(cap, mid, lo)
        hi = np.where(cap, hi, mid)
    return float(np.max(0.5 * (lo + hi)))
