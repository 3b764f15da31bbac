"""Metric base class.

Metrics are small frozen dataclasses of Python floats. Scalar,
configuration-time geometry (horizon, capture radius, alpha_crit) runs on
the host in float64 NumPy; the per-ray hot path is batched over torch
tensors, structure-of-arrays, on whatever device the tensors live.

The public 8-D state is [t, r, theta, phi, p_t, p_r, p_theta, p_phi]
(`geodesic_equations`, `initial_conditions_8d`: the trajectory recorder
and the timelike orbits); the tracers integrate the reduced 5-D state
with the conserved (p_t, p_phi).
"""

from __future__ import annotations

import abc
import dataclasses


@dataclasses.dataclass(frozen=True)
class Metric(abc.ABC):
    """Base class for spacetime metrics (geometric units, G = c = 1)."""

    is_spherically_symmetric: bool = dataclasses.field(
        default=False, init=False, repr=False)

    @abc.abstractmethod
    def capture_radius(self) -> float:
        """Inner stopping radius for integration (host-side scalar)."""

    @abc.abstractmethod
    def alpha_crit(self, r_obs, theta_obs=None, device=None) -> float:
        """Critical viewing angle in radians (host-side scalar). device:
        where a family without a closed form traces its bisection (None:
        the card); closed forms ignore it."""

    @abc.abstractmethod
    def viewing_angle_to_impact_parameter(self, alpha, r_obs,
                                          theta_obs=None) -> float:
        """Convert viewing angle to impact parameter (host-side scalar)."""

    @abc.abstractmethod
    def geodesic_equations(self, lam, state8):
        """RHS of Hamilton's equations on the public 8-D state: `state8`
        is (..., 8), the result (..., 8)."""

    @abc.abstractmethod
    def initial_conditions_8d(self, r_obs, alpha, theta=0.0, theta_obs=None):
        """Batched initial 8-D state for photons at viewing angle alpha:
        (state8 (..., 8), invalid mask)."""

    def trace_ray(self, r_obs, alpha, theta=0.0, theta_obs=None,
                  phi_max=50.0, axis_refine=False, dtype=None, device=None):
        """Trace one ray through `trace_batch`; returns (final_alpha,
        n_half_orbits, outcome) with outcome 'escaped' | 'captured' |
        'invalid'. dtype: a torch floating dtype (None: the default
        dtype); device: None traces on the card (the CUDA kernel), "cpu"
        on the plain loop."""
        import math
        import torch
        from light_path_tracer_tpu_torch.ops.batch import trace_batch

        if theta_obs is None:
            theta_obs = math.pi / 2
        if dtype is None:
            dtype = torch.get_default_dtype()
        device = torch.device("cuda" if device is None else device)
        res = trace_batch(
            self, r_obs, torch.tensor([alpha], dtype=dtype, device=device),
            torch.tensor([theta], dtype=dtype, device=device), theta_obs,
            torch.tensor([bool(axis_refine)], device=device),
            phi_max=phi_max)
        status = int(res.status[0])
        outcome = {1: "escaped", -1: "captured", 0: "invalid"}[status]
        return (float(res.final_alpha[0]), int(res.n_half_orbits[0]),
                outcome)
