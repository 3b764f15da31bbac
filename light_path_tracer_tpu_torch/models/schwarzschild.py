"""Schwarzschild metric: non-rotating black hole of mass M.

The PyTorch counterpart of `light_path_tracer_tpu.models.schwarzschild`,
for the orbit-equation path that shadows and lensed renders take:
  * host-side closed forms in float64: R_S = 2M, the photon sphere 3M,
    B_CRIT = 3 sqrt(3) M, f(r) = 1 - R_S/r, alpha_crit and the
    alpha <-> b conversion;
  * the batched orbit equation in phi over torch tensors: the RHS
    (u', w') = (w, -u + 3 M u^2), the initial (u, w) from the viewing
    angle, and the final-angle extraction through the escape heading.

Every batched method computes in the dtype of its input tensors, with
each Python-float constant rounded once to that dtype and the operations
in the JAX package's order, so float32 results round the way JAX's do.
The CUDA orbit kernel (csrc/schwarzschild_rk4.cu) carries the same
formulas per thread. The 8-D Hamiltonian path serves trajectory plots
only and is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.base import Metric

# jnp.maximum(x, 1e-300) rounds its floor to the array's dtype: 0.0 in
# float32 (the literal underflows), 1e-300 in float64.
_TINY = 1e-300


def _scalar(x, like):
    """0-dim tensor of x in `like`'s dtype and device."""
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Schwarzschild(Metric):
    M: float = 1.0

    is_spherically_symmetric: bool = dataclasses.field(
        default=True, init=False, repr=False)

    # ---- host-side scalar geometry (float64) ----

    @property
    def R_S(self) -> float:
        return 2.0 * self.M

    @property
    def R_PHOTON(self) -> float:
        return 3.0 * self.M

    @property
    def B_CRIT(self) -> float:
        return 3.0 * np.sqrt(3.0) * self.M

    def f(self, r):
        """Metric function f(r) = 1 - R_S / r."""
        return 1.0 - self.R_S / r

    def capture_radius(self) -> float:
        return self.R_S * 1.01

    def alpha_crit(self, r_obs, theta_obs=None, device=None) -> float:
        arg = self.B_CRIT * np.sqrt(self.f(r_obs)) / r_obs
        return float(np.arcsin(np.clip(arg, -1.0, 1.0)))

    def viewing_angle_to_impact_parameter(self, alpha, r_obs,
                                          theta_obs=None):
        return r_obs * np.sin(alpha) / np.sqrt(self.f(r_obs))

    # ---- batched orbit equation (torch) ----

    def orbit_rhs(self, u, w):
        """RHS of the photon orbit equation: (u', w') = (w, -u + 3 M u^2)."""
        return w, -u + 3.0 * self.M * u * u

    def _impact(self, r_obs, alphas):
        """(f(r_obs), b, u0, b_safe) of the orbit's initial state."""
        f0 = float(self.f(r_obs))
        b = r_obs * torch.sin(alphas) / float(np.sqrt(max(f0, 1e-300)))
        u0 = torch.full_like(alphas, 1.0 / r_obs)
        b_safe = torch.where(b == 0.0, torch.ones_like(b), b)
        return f0, b, u0, b_safe

    @staticmethod
    def _branch(alphas, w0_sq, b, f0):
        """Initial w with the sign of cos(alpha): forward-looking rays
        move inward (w > 0), backward ones outward. Returns (w0,
        invalid) with invalid = no real trajectory (b == 0, w0^2 < 0,
        observer inside the horizon)."""
        invalid = (b == 0.0) | (w0_sq < 0.0)
        if f0 <= 0.0:
            invalid = torch.ones_like(invalid)
        one = torch.ones_like(alphas)
        w0 = torch.where(torch.cos(alphas) >= 0.0, one, -one) * torch.sqrt(
            torch.clamp(w0_sq, min=0.0))
        return w0, invalid

    def orbit_initial_state(self, r_obs, alphas):
        """Initial (u, w) for the orbit equation, batched over alphas.

        w0^2 = 1/b^2 - u0^2 + 2 M u0^3. Returns (u0, w0, invalid).
        """
        f0, b, u0, b_safe = self._impact(r_obs, alphas)
        M = _scalar(self.M, alphas)
        w0_sq = 1.0 / (b_safe * b_safe) - u0 * u0 + 2.0 * M * u0 * u0 * u0
        w0, invalid = self._branch(alphas, w0_sq, b, f0)
        return u0, w0, invalid

    def orbit_extract_angle(self, phi, u, w):
        """Final viewing angle + winding from the orbit state.

        Returns (final_alpha, n_half_orbits, captured_by_radius).
        """
        tiny = _scalar(_TINY, u)
        r_f = 1.0 / torch.maximum(u, tiny)
        n_half = torch.floor(torch.abs(phi) / math.pi).to(torch.int32)
        captured_by_radius = r_f <= self.R_S * 1.1

        dr_dphi = -w / torch.maximum(u * u, tiny)
        sin_phi = torch.sin(phi)
        cos_phi = torch.cos(phi)
        heading = torch.atan2(dr_dphi * sin_phi + r_f * cos_phi,
                              dr_dphi * cos_phi - r_f * sin_phi)
        final_alpha = torch.arccos(torch.clamp(-torch.cos(heading),
                                               -1.0, 1.0))
        return final_alpha, n_half, captured_by_radius
