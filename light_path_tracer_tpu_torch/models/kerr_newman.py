"""Kerr-Newman metric: charged, rotating black hole, a^2 + Q^2 <= M^2.

The PyTorch counterpart of `light_path_tracer_tpu.models.kerr_newman`. In
Boyer-Lindquist coordinates Kerr-Newman is Kerr with two substitutions,

    Delta = r^2 - 2 M r + a^2 + Q^2,    2 M r -> W = 2 M r - Q^2

(the g^tphi numerator), so every inverse-metric component keeps Kerr's
form. The batched hot path is Kerr's through its hooks: `_q2` turns on
the charge terms of `Kerr.rhs5`, `_Delta_b` and `_two_M_r` carry the
charge into the initial conditions and the angle extraction, and
`_inv_terms` into the null normalisation and `tdot`. At Q = 0 every
batched method is Kerr's, bitwise (the JAX package makes its RHS so with
a static branch; here the initial conditions and the plunge radius
follow), and the CUDA wrapper launches the Kerr instance. The CUDA
kernel (csrc/kerr_dp45.cu, family kKerrNewman) carries the charged
formulas.

Spherical photon orbits: with u(r) = 4 r Delta / Delta'(r),

    xi(r) = (r^2 + a^2 - u) / a,    eta(r) = u^2 / Delta - (xi - a)^2,

from R(r) = R'(r) = 0 (Bardeen's closed form is Kerr-only); the band of
unstable orbits is the eta >= 0 region, bracketed numerically.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.kerr import (Kerr, _SIN2_FLOOR,
                                                     _scalar)


def inverse_metric_terms_kn(M, a, q2, r, th):
    """The five contravariant Kerr-Newman components (g^tt, g^tphi,
    g^rr, g^thth, g^phiphi) at tensors (r, th); M, a are 0-dim tensors
    or Python floats, q2 = Q^2 a Python float."""
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = torch.clamp(sin_th * sin_th, min=_SIN2_FLOOR)
    r2 = r * r
    a2 = a * a
    Sigma = r2 + a2 * cos_th * cos_th
    Delta = r2 - 2.0 * M * r + a2 + q2
    ra2 = r2 + a2
    A = ra2 * ra2 - a2 * Delta * sin2
    SD = Sigma * Delta
    g_tt = -A / SD
    g_tphi = -a * (2.0 * M * r - q2) / SD
    g_rr = Delta / Sigma
    g_thth = 1.0 / Sigma
    g_phiphi = (Delta - a2 * sin2) / (SD * sin2)
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi


@functools.lru_cache(maxsize=64)
def _cached_band(metric):
    return metric._photon_band()


@dataclasses.dataclass(frozen=True)
class KerrNewman(Kerr):
    Q: float = 0.0

    def __post_init__(self):
        if self.a ** 2 + self.Q ** 2 > self.M ** 2 * (1 + 1e-12):
            raise ValueError(
                f"a^2 + Q^2 must be <= M^2 (naked singularity): "
                f"a={self.a}, Q={self.Q}, M={self.M}")

    # ---- host-side scalar geometry (float64 NumPy) ----

    @property
    def r_plus(self) -> float:
        return float(self.M + np.sqrt(max(
            self.M ** 2 - self.a ** 2 - self.Q ** 2, 0.0)))

    def _Delta(self, r):
        # Factored (r - r_+)(r - r_-): exact roots, no cancellation at
        # the extremal corner a^2 + Q^2 = M^2.
        s = np.sqrt(max(self.M**2 - self.a**2 - self.Q**2, 0.0))
        return (r - (self.M + s)) * (r - (self.M - s))

    def _xi_eta(self, r_ph):
        M, a = self.M, self.a
        Delta = self._Delta(r_ph)
        dDelta = 2.0 * (r_ph - M)
        u = 4.0 * r_ph * Delta / dDelta
        xi = (r_ph ** 2 + a ** 2 - u) / a
        eta = u ** 2 / Delta - (xi - a) ** 2
        return xi, eta

    def unstable_photon_radii(self):
        """(r_prograde, r_retrograde): the eta(r) >= 0 band edges, each
        refined by 80 bisections (the closed form at a = 0). Cached per
        (M, a, Q): the plunge radius of every trace needs it, and its
        ~2 ms of host NumPy would otherwise sit in front of each launch
        (the JAX package computes it once per compiled trace)."""
        return _cached_band(self)

    def _photon_band(self):
        if self.a == 0:
            r_ph = 0.5 * (3.0 * self.M + np.sqrt(
                9.0 * self.M ** 2 - 8.0 * self.Q ** 2))
            return float(r_ph), float(r_ph)
        r_lo = self.r_plus * (1.0 + 1e-9)
        rs = np.linspace(r_lo, 4.5 * self.M, 4001)
        rs = rs[np.abs(rs - self.M) > 1e-9]    # the pole of Delta'
        _xi, eta = self._xi_eta(rs)
        pos = eta >= 0.0
        if not pos.any():
            # Degenerate band (extremal corners): one equatorial orbit at
            # the eta maximum.
            r_star = float(rs[np.argmax(eta)])
            return r_star, r_star
        i0, i1 = np.argmax(pos), len(pos) - np.argmax(pos[::-1]) - 1

        def bisect(ra, rb):
            for _ in range(80):
                rm = 0.5 * (ra + rb)
                if self._xi_eta(np.asarray([rm]))[1][0] >= 0.0:
                    rb = rm
                else:
                    ra = rm
            return rb

        r_pro = (bisect(rs[i0 - 1], rs[i0]) if i0 > 0 else rs[0])
        r_ret = (bisect(rs[i1 + 1], rs[i1]) if i1 < len(rs) - 1
                 else rs[-1])
        return float(r_pro), float(r_ret)

    def alpha_crit(self, r_obs, theta_obs=None, n_samples=50,
                   device=None) -> float:
        """Shadow-envelope critical angle: Kerr's sampling recipe with
        the general-Delta (xi, eta) and the Reissner-Nordstrom floor."""
        if theta_obs is None:
            theta_obs = np.pi / 2
        M, a, Q = self.M, self.a, self.Q
        r_ph0 = 0.5 * (3.0 * M + np.sqrt(9.0 * M ** 2 - 8.0 * Q ** 2))
        f0 = 1.0 - 2.0 * M / r_ph0 + Q ** 2 / r_ph0 ** 2
        b_floor = r_ph0 / np.sqrt(f0)
        if a == 0:
            b_crit = b_floor
        else:
            r_pro, r_ret = self.unstable_photon_radii()
            r_arr = np.linspace(r_pro, r_ret, n_samples)
            xi, eta = self._xi_eta(r_arr)
            b2 = xi ** 2 + np.maximum(eta, 0.0)
            b_crit = max(float(np.sqrt(np.max(b2))), float(b_floor))

        Delta_o = self._Delta(r_obs)
        Sigma_o = self._Sigma(r_obs, theta_obs)
        sin_th = np.sin(theta_obs)
        A = (r_obs ** 2 + a ** 2) ** 2 - a ** 2 * Delta_o * sin_th ** 2
        arg = b_crit * np.sqrt(Sigma_o * Delta_o / A) / r_obs
        return float(np.arcsin(np.clip(arg, -1.0, 1.0)))

    def viewing_angle_to_impact_parameter(self, alpha, r_obs,
                                          theta_obs=None):
        if theta_obs is None:
            theta_obs = np.pi / 2
        Delta = self._Delta(r_obs)
        Sigma = self._Sigma(r_obs, theta_obs)
        sin_th = np.sin(theta_obs)
        A = (r_obs ** 2 + self.a ** 2) ** 2 \
            - self.a ** 2 * Delta * sin_th ** 2
        return r_obs * np.sin(alpha) * np.sqrt(A / (Sigma * Delta))

    # ---- batched hot-path hooks (torch) ----

    @property
    def _q2(self) -> float:
        return self.Q * self.Q

    def _Delta_b(self, r, M, a):
        if not self.Q:
            return super()._Delta_b(r, M, a)
        return r * r - 2.0 * M * r + a * a + self._q2

    def _inv_terms(self, r, th, M, a):
        if not self.Q:
            return super()._inv_terms(r, th, M, a)
        return inverse_metric_terms_kn(M, a, self._q2, r, th)

    def _two_M_r(self, r, M):
        if not self.Q:
            return super()._two_M_r(r, M)
        return 2.0 * M * r - self._q2

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """Kerr's certain-plunge radius with the general Delta: the
        radial potential keeps its structure under Delta -> Delta + Q^2,
        so a non-vortical photon (eta >= 0) crossing inbound below the
        numeric prograde band edge (unstable_photon_radii) plunges.
        Kerr's at Q = 0."""
        if not self.Q:
            return super().plunge_radii(r_obs, alphas, thetas, theta_obs)
        M, a = _scalar(self.M, alphas), _scalar(self.a, alphas)
        r, _th, _sin_th, cos_th, Sigma, Delta = self._observer(
            r_obs, theta_obs, alphas, M, a)
        rho = r * torch.sin(alphas) * torch.sqrt(Sigma) / torch.sqrt(
            torch.clamp(Delta, min=1e-30))
        alpha_s = -rho * torch.sin(thetas)
        beta_s = -rho * torch.cos(thetas)
        eta = (beta_s * beta_s
               + cos_th * cos_th * (alpha_s * alpha_s - a * a))
        r_pro = _scalar(self.unstable_photon_radii()[0], alphas)
        return torch.where(eta >= 0.0, 0.999 * r_pro,
                           torch.zeros_like(eta)).to(alphas.dtype)
