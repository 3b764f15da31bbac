"""Reissner-Nordstrom metric: charged, non-rotating black hole.

The PyTorch counterpart of
`light_path_tracer_tpu.models.reissner_nordstrom`. Spherically symmetric,
so it rides every orbit-equation path of Schwarzschild (the plain tracer
and the CUDA orbit kernel) by overriding the closed forms and the orbit
equation only:

    f(r)   = 1 - 2M/r + Q^2/r^2
    r_+    = M + sqrt(M^2 - Q^2)            (outer horizon, used as R_S)
    r_ph   = (3M + sqrt(9M^2 - 8Q^2)) / 2   (photon sphere)
    b_crit = r_ph / sqrt(f(r_ph))
    u''    = -u + 3 M u^2 - 2 Q^2 u^3
    w0^2   = 1/b^2 - u^2 + 2 M u^3 - Q^2 u^4

|Q| > M (naked singularity) is rejected. The 8-D Hamiltonian path
replaces R_S/(2 r^2) by f'/2 = M/r^2 - Q^2/r^3 in Schwarzschild's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.schwarzschild import (Schwarzschild,
                                                              _scalar)


@dataclasses.dataclass(frozen=True)
class ReissnerNordstrom(Schwarzschild):
    Q: float = 0.0

    def __post_init__(self):
        if abs(self.Q) > self.M:
            raise ValueError(
                f"|Q| must be <= M (naked singularity): Q={self.Q}, "
                f"M={self.M}")

    # ---- closed-form geometry overrides ----

    @property
    def R_S(self) -> float:
        """Outer horizon r_+ = M + sqrt(M^2 - Q^2); the capture and
        reclassification radii key off it."""
        return float(self.M + np.sqrt(max(self.M ** 2 - self.Q ** 2, 0.0)))

    @property
    def R_PHOTON(self) -> float:
        return float(0.5 * (3.0 * self.M + np.sqrt(
            9.0 * self.M ** 2 - 8.0 * self.Q ** 2)))

    @property
    def B_CRIT(self) -> float:
        r_ph = self.R_PHOTON
        return float(r_ph / np.sqrt(self.f(r_ph)))

    def f(self, r):
        """Metric function f(r) = 1 - 2M/r + Q^2/r^2."""
        return 1.0 - 2.0 * self.M / r + (self.Q / r) * (self.Q / r)

    # ---- batched orbit equation ----

    def orbit_rhs(self, u, w):
        """(u', w') = (w, -u + 3 M u^2 - 2 Q^2 u^3)."""
        return w, (-u + 3.0 * self.M * u * u
                   - 2.0 * self.Q * self.Q * u * u * u)

    def orbit_initial_state(self, r_obs, alphas):
        """Initial (u, w): w0^2 = 1/b^2 - u^2 + 2 M u^3 - Q^2 u^4.

        The powers are formed as JAX's integer_pow forms them:
        u^3 = u (u u), u^4 = (u u)(u u).
        """
        f0, b, u0, b_safe = self._impact(r_obs, alphas)
        M = _scalar(self.M, alphas)
        Q2 = _scalar(self.Q * self.Q, alphas)
        u0_2 = u0 * u0
        w0_sq = (1.0 / (b_safe * b_safe) - u0 * u0
                 + 2.0 * M * (u0 * u0_2) - Q2 * (u0_2 * u0_2))
        w0, invalid = self._branch(alphas, w0_sq, b, f0)
        return u0, w0, invalid

    # ---- full 8-D Hamiltonian path ----

    def geodesic_equations(self, lam, state8):
        """Hamilton's equations with f(r) = 1 - 2M/r + Q^2/r^2: the
        Schwarzschild body with f'/2 = M/r^2 - Q^2/r^3 in place of
        R_S/(2 r^2)."""
        t, r, th, phi, p_t, p_r, p_th, p_phi = torch.movedim(state8, -1, 0)
        horizon = self.R_S
        M = self.M
        Q2 = self.Q * self.Q
        frozen = r <= horizon * 1.001

        r_safe = torch.where(frozen, torch.full_like(r, 10.0 * horizon), r)
        f = 1.0 - 2.0 * M / r_safe + Q2 / (r_safe * r_safe)
        sin_th = torch.sin(th)
        cos_th = torch.cos(th)
        sin2 = torch.clamp(sin_th * sin_th, min=1e-15)
        r2 = r_safe * r_safe
        r3 = r2 * r_safe
        half_fp = M / r2 - Q2 / r3          # f'(r) / 2

        dt = -p_t / f
        dr = f * p_r
        dth = p_th / r2
        dphi = p_phi / (r2 * sin2)
        dp_r = (-half_fp * (p_t * p_t) / (f * f)
                - half_fp * p_r * p_r
                + (p_th * p_th + p_phi * p_phi / sin2) / r3)
        dp_th = cos_th * p_phi * p_phi / (r2 * sin2 * torch.sqrt(sin2))
        zeros = torch.zeros_like(r)
        out = torch.stack(
            [dt, dr, dth, dphi, zeros, dp_r, dp_th, zeros], dim=-1)
        return torch.where(frozen[..., None], torch.zeros_like(out), out)
