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

|Q| > M (naked singularity) is rejected.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
