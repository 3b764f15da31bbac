"""Kerr metric in Boyer-Lindquist coordinates: spinning BH, |a| <= M.

The PyTorch counterpart of `light_path_tracer_tpu.models.kerr.Kerr`, for
the shadow main path:
  * host-side geometry in float64 NumPy: r_+, the capture and freeze
    radii, Bardeen's unstable photon-orbit radii and critical (xi, eta),
    and the shadow-envelope alpha_crit;
  * the batched hot path over torch tensors: screen -> conserved-quantity
    initial conditions, Hamilton's equations on the reduced 5-D state
    [r, theta, phi, p_r, p_theta] (`rhs5`), the coordinate-time rate
    (`tdot`), the certain-plunge radius, and the final-angle extraction;
  * the mu = cos(theta) chart: the canonical point transformation to and
    from [r, mu, phi, p_r, p_mu] (`state_to_mu`, `state_from_mu`), its
    transcendental-free RHS (`rhs5_mu`), and the launch-time mask of rays
    that pass near the polar axis, where that chart is ill-conditioned
    (`pole_risk`; the hybrid tracer re-traces them in theta).

Every batched method computes in the dtype of its input tensors, with the
metric parameters as 0-dim tensors of that dtype, in the same operation
order as the JAX package, so float32 results round the way JAX's do. The
CUDA kernel (csrc/kerr_dp45.cu) carries the same formulas per thread; this
module is its plain version. On the GPU every (M, a) is a kernel argument
at run time. `TracedKerr` is the counterpart of the JAX package's
traced-parameter twin for the sequences' run-time (M, a): the same hot
path with M, a and the radii derived from them formed in float32, as
JAX's traced scalars form them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.base import Metric
from light_path_tracer_tpu_torch.operands import kernel_operand

_SIN2_FLOOR = 1e-15


def _scalar(x, like):
    """0-dim tensor of x in `like`'s dtype and device."""
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def inverse_metric_terms(M, a, r, th):
    """The five nonzero contravariant Kerr metric components (g^tt,
    g^tphi, g^rr, g^thth, g^phiphi) at tensors (r, th); M and a are
    0-dim tensors or Python floats."""
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = torch.clamp(sin_th * sin_th, min=_SIN2_FLOOR)
    r2 = r * r
    a2 = a * a
    Sigma = r2 + a2 * cos_th * cos_th
    Delta = r2 - 2.0 * M * r + a2
    ra2 = r2 + a2
    A = ra2 * ra2 - a2 * Delta * sin2
    SD = Sigma * Delta
    g_tt = -A / SD
    g_tphi = -2.0 * M * a * r / SD
    g_rr = Delta / Sigma
    g_thth = 1.0 / Sigma
    g_phiphi = (Delta - a2 * sin2) / (SD * sin2)
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi


@dataclasses.dataclass(frozen=True)
class Kerr(Metric):
    M: float = 1.0
    a: float = 0.0

    def __post_init__(self):
        if abs(self.a) > self.M:
            raise ValueError(f"|a|={abs(self.a)} exceeds M={self.M}")

    # ---- host-side scalar geometry (float64 NumPy) ----

    @property
    def r_plus(self) -> float:
        return self.M + np.sqrt(self.M**2 - self.a**2)

    def capture_radius(self) -> float:
        return self.r_plus * 1.01

    def reclass_radius(self) -> float:
        """Radius at/inside which extraction books a ray as captured:
        1.1 x the capture radius."""
        return self.capture_radius() * 1.1

    def _freeze_radius(self) -> float:
        """Radius at/below which the RHS is hard-zeroed."""
        return self.r_plus * 1.001

    def _Sigma(self, r, th):
        return r**2 + self.a**2 * np.cos(th)**2

    def _Delta(self, r):
        # Factored (r - r_+)(r - r_-): exact roots, no cancellation near
        # the horizon at extremal spin.
        s = np.sqrt(max(self.M**2 - self.a**2, 0.0))
        return (r - (self.M + s)) * (r - (self.M - s))

    def unstable_photon_radii(self):
        """(r_prograde, r_retrograde) of unstable circular photon orbits
        (Bardeen's closed form; both give 3M at a = 0)."""
        M, a = self.M, self.a
        r_pro = 2.0 * M * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-a / M)))
        r_ret = 2.0 * M * (1.0 + np.cos(2.0 / 3.0 * np.arccos(a / M)))
        return float(r_pro), float(r_ret)

    def _xi_eta(self, r_ph):
        """Critical conserved quantities (xi, eta) of the spherical photon
        orbit at Boyer-Lindquist radius r_ph."""
        M, a = self.M, self.a
        Delta = self._Delta(r_ph)
        xi = (r_ph**2 + a**2) / a - 2.0 * r_ph * Delta / (a * (r_ph - M))
        eta = (r_ph**3 / (a**2 * (r_ph - M)**2)
               * (4.0 * M * Delta - r_ph * (r_ph - M)**2))
        return xi, eta

    def alpha_crit(self, r_obs, theta_obs=None, n_samples=50,
                   device=None) -> float:
        """Shadow-envelope critical viewing angle: the max impact
        parameter over sampled spherical photon orbits, clamped below by
        the Schwarzschild value, converted to a viewing angle at the
        observer."""
        if theta_obs is None:
            theta_obs = np.pi / 2
        M, a = self.M, self.a
        if a == 0:
            b_crit = 3.0 * np.sqrt(3.0) * M
        else:
            r_pro, r_ret = self.unstable_photon_radii()
            r_arr = np.linspace(r_pro, r_ret, n_samples)
            xi, eta = self._xi_eta(r_arr)
            b2 = xi**2 + np.maximum(eta, 0.0)
            b_crit = max(float(np.sqrt(np.max(b2))), 3.0 * np.sqrt(3.0) * M)

        Delta_o = self._Delta(r_obs)
        Sigma_o = self._Sigma(r_obs, theta_obs)
        sin_th = np.sin(theta_obs)
        A = (r_obs**2 + a**2)**2 - a**2 * Delta_o * sin_th**2
        arg = b_crit * np.sqrt(Sigma_o * Delta_o / A) / r_obs
        return float(np.arcsin(np.clip(arg, -1.0, 1.0)))

    # ---- batched hot path (torch, structure-of-arrays) ----

    # Metric-function hooks: Kerr-Newman overrides them (the charge
    # enters only through Delta and the g^tphi numerator 2Mr - Q^2),
    # Johannsen-Psaltis overrides _inv_terms alone.

    @property
    def _q2(self) -> float:
        """Squared charge Q^2 as a Python float, 0 for Kerr: rhs5 adds the
        charge terms only where it is nonzero, so Kerr's arithmetic is
        unchanged."""
        return 0.0

    def _Delta_b(self, r, M, a):
        return r * r - 2.0 * M * r + a * a

    def _inv_terms(self, r, th, M, a):
        return inverse_metric_terms(M, a, r, th)

    def _two_M_r(self, r, M):
        """The g^tphi numerator factor 2 M r (Kerr-Newman subtracts
        Q^2); M is a Python float or a 0-dim tensor."""
        return 2.0 * M * r

    def _observer(self, r_obs, theta_obs, like, M, a):
        """Observer-position scalars (r, th, sin, cos, Sigma, Delta) as
        0-dim tensors in `like`'s dtype."""
        r = _scalar(r_obs, like)
        th = _scalar(theta_obs, like)
        sin_th, cos_th = torch.sin(th), torch.cos(th)
        Sigma = r * r + a * a * cos_th * cos_th
        Delta = self._Delta_b(r, M, a)
        return r, th, sin_th, cos_th, Sigma, Delta

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """Per-ray certain-capture radius for early termination.

        Crossing r < r_prograde inbound is a guaranteed plunge (every
        spherical photon orbit lies outside it), so integration can stop
        there. Vortical rays (eta < 0) are excluded: radius 0 disables.
        """
        M, a = _scalar(self.M, alphas), _scalar(self.a, alphas)
        r, _th, _sin_th, cos_th, Sigma, Delta = self._observer(
            r_obs, theta_obs, alphas, M, a)
        rho = r * torch.sin(alphas) * torch.sqrt(Sigma) / torch.sqrt(
            torch.clamp(Delta, min=1e-30))
        alpha_s = -rho * torch.sin(thetas)
        beta_s = -rho * torch.cos(thetas)
        eta = (beta_s * beta_s
               + cos_th * cos_th * (alpha_s * alpha_s - a * a))
        ratio = torch.clamp(-a / torch.clamp(M, min=1e-30), -1.0, 1.0)
        r_pro = 2.0 * M * (1.0 + torch.cos(2.0 / 3.0 * torch.arccos(ratio)))
        return torch.where(eta >= 0.0, 0.999 * r_pro,
                           torch.zeros_like(eta)).to(alphas.dtype)

    def pole_risk(self, r_obs, alphas, thetas, theta_obs, s_thresh=1e-4):
        """Per-ray mask: will this ray approach the polar axis?

        The polar potential turns at sin^2(theta)_min ~ L^2 / (Q + a^2
        E^2), so rays of small conserved L pass close to the axis, where
        p_mu diverges like 1/sin(theta): the one place the mu chart is
        ill-conditioned. Vortical rays (Q <= 0) are flagged too. Delta is
        Kerr's r^2 - 2Mr + a^2 for every subclass, as in the JAX package
        (Kerr-Newman inherits this method there unchanged).
        """
        M, a = _scalar(self.M, alphas), _scalar(self.a, alphas)
        th = _scalar(theta_obs, alphas)
        sin_th, cos_th = torch.sin(th), torch.cos(th)
        r = _scalar(r_obs, alphas)
        Sigma = r * r + a * a * cos_th * cos_th
        Delta = r * r - 2.0 * M * r + a * a
        rho = r * torch.sin(alphas) * torch.sqrt(Sigma) / torch.sqrt(
            torch.clamp(Delta, min=1e-30))
        alpha_s = -rho * torch.sin(thetas)
        beta_s = -rho * torch.cos(thetas)
        L = -alpha_s * sin_th
        Q = (beta_s * beta_s
             + cos_th * cos_th * (alpha_s * alpha_s - a * a))
        L2 = L * L
        denom = torch.clamp(Q + a * a + L2, min=1e-30)
        return (Q <= 0.0) | (L2 < s_thresh * denom)

    def initial_conditions_5d(self, r_obs, alphas, thetas, theta_obs):
        """Screen angles -> reduced 5-D state + conserved momenta.

        alphas/thetas: (N,) screen viewing angle / azimuth; theta_obs the
        scalar observer inclination. Returns
        ((r, th, phi, p_r, p_th), p_t, p_phi, invalid).
        """
        M, a = _scalar(self.M, alphas), _scalar(self.a, alphas)
        r, th, sin_th, cos_th, Sigma, Delta = self._observer(
            r_obs, theta_obs, alphas, M, a)
        sin2 = torch.clamp(sin_th * sin_th, min=_SIN2_FLOOR)
        bad_obs = (Delta <= 0.0) | (Sigma <= 0.0)

        E = _scalar(1.0, alphas)
        rho = r * torch.sin(alphas) * torch.sqrt(Sigma) / torch.sqrt(
            torch.where(bad_obs, torch.ones_like(Delta), Delta))
        sin_screen = torch.sin(thetas)
        cos_screen = torch.cos(thetas)
        alpha_screen = -rho * sin_screen
        beta_screen = -rho * cos_screen

        xi = -alpha_screen * sin_th
        eta = (beta_screen * beta_screen
               + cos_th * cos_th * (alpha_screen * alpha_screen - a * a))
        L = xi * E
        Q = eta * E * E

        # Covariant convention p_t = -E (E > 0, future-directed).
        p_t = -E
        p_phi = L

        Theta = torch.clamp(
            Q - cos_th * cos_th * (L * L / sin2 - a * a * E * E), min=0.0)
        one = torch.ones_like(alphas)
        p_th = torch.where(cos_screen > 0.0, -one, one) * torch.sqrt(Theta)

        g_tt, g_tphi, g_rr, g_thth, g_phiphi = self._inv_terms(r, th, M, a)
        other = (g_tt * p_t * p_t
                 + 2.0 * g_tphi * p_t * p_phi
                 + g_thth * p_th * p_th
                 + g_phiphi * p_phi * p_phi)
        p_r_sq = -other / g_rr
        # Inward root for forward-looking rays (alpha <= pi/2).
        p_r = torch.where(torch.cos(alphas) >= 0.0, -one, one) * torch.sqrt(
            torch.clamp(p_r_sq, min=0.0))

        invalid = bad_obs.expand(alphas.shape)
        r0 = r.expand(alphas.shape)
        th0 = th.expand(alphas.shape)
        phi0 = torch.zeros_like(alphas)
        p_t_b = p_t.expand(alphas.shape)
        return (r0, th0, phi0, p_r, p_th), p_t_b, p_phi, invalid

    @staticmethod
    def state_to_mu(y):
        """(r, theta, phi, p_r, p_theta) -> (r, mu, phi, p_r, p_mu), a
        tuple of tensors or a (5, N) tensor: mu = cos(theta), p_mu =
        -p_theta / sin(theta) (an exact canonical point transformation, so
        the same geodesics), sin(theta) floored at sqrt(1e-15)."""
        r, th, phi, p_r, p_th = y
        sin_th = torch.sin(th)
        mu = torch.cos(th)
        sin_safe = torch.clamp(sin_th, min=math.sqrt(_SIN2_FLOOR))
        return (r, mu, phi, p_r, -p_th / sin_safe)

    @staticmethod
    def state_from_mu(y):
        """(r, mu, phi, p_r, p_mu) -> (r, theta, phi, p_r, p_theta), with
        sin(theta) from (1 - mu)(1 + mu), which is better conditioned than
        1 - mu^2 near the poles."""
        r, mu, phi, p_r, p_mu = y
        mu_c = torch.clamp(mu, -1.0, 1.0)
        th = torch.arccos(mu_c)
        sin_th = torch.sqrt(torch.clamp((1.0 - mu_c) * (1.0 + mu_c),
                                        min=_SIN2_FLOOR))
        return (r, th, phi, p_r, -sin_th * p_mu)

    def rhs5(self, state5, p_t, p_phi):
        """Hamilton's equations on the reduced 5-D theta-state, batched.

        Analytic d/dr and d/dtheta of the inverse-metric components with
        three reciprocals (1/Sigma, 1/Delta, 1/sin^2) shared by every
        quotient; hard-zeroed inside r <= 1.001 r_+. state5 is a tuple
        (r, th, phi, p_r, p_th) of (N,) tensors; returns a (5, N) tensor.
        """
        r, th, _phi, p_r, p_th = state5
        M, a = _scalar(self.M, r), _scalar(self.a, r)
        r_plus = _scalar(self.r_plus, r)

        frozen = r <= r_plus * 1.001
        r_s = torch.where(frozen, 10.0 * r_plus + 10.0, r)

        sin_th = torch.sin(th)
        cos_th = torch.cos(th)
        sin2 = torch.clamp(sin_th * sin_th, min=_SIN2_FLOOR)
        a2 = a * a
        r2 = r_s * r_s
        Sigma = r2 + a2 * cos_th * cos_th
        Delta = r2 - 2.0 * M * r_s + a2
        q2 = self._q2
        if q2:
            Delta = Delta + q2                 # Kerr-Newman
        ra2 = r2 + a2
        A = ra2 * ra2 - a2 * Delta * sin2

        inv_Sigma = 1.0 / Sigma
        inv_Delta = 1.0 / Delta
        inv_sin2 = 1.0 / sin2
        inv_SD = inv_Sigma * inv_Delta
        inv_SD2 = inv_SD * inv_SD
        inv_S2 = inv_Sigma * inv_Sigma

        g_rr = Delta * inv_Sigma
        g_thth = inv_Sigma
        if q2:
            # g^tphi numerator W = 2Mr - Q^2 (identically r^2 + a^2 -
            # Delta; this form keeps the Kerr limit's rounding).
            W = 2.0 * M * r_s - q2
            g_tphi = -a * W * inv_SD
        else:
            g_tphi = -2.0 * M * a * r_s * inv_SD
        g_phiphi = (Delta - a2 * sin2) * inv_SD * inv_sin2

        dr = g_rr * p_r
        dth = g_thth * p_th
        dphi = g_tphi * p_t + g_phiphi * p_phi

        # -- radial derivatives of the inverse metric --
        SD = Sigma * Delta
        dSigma_dr = 2.0 * r_s
        dDelta_dr = 2.0 * r_s - 2.0 * M
        dA_dr = 4.0 * r_s * ra2 - a2 * dDelta_dr * sin2
        dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr

        dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2
        if q2:
            # d/dr of -a W / (Sigma Delta) with dW/dr = 2M.
            dg_tphi_dr = -a * (2.0 * M * SD - W * dSD_dr) * inv_SD2
        else:
            dg_tphi_dr = -(2.0 * M * a * (SD - r_s * dSD_dr)) * inv_SD2
        dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2
        dg_thth_dr = -dSigma_dr * inv_S2
        inv_den_phi = inv_SD * inv_sin2
        inv_den_phi2 = inv_den_phi * inv_den_phi
        den_phi = SD * sin2
        dg_phiphi_dr = (dDelta_dr * den_phi
                        - (Delta - a2 * sin2) * dSD_dr * sin2) * inv_den_phi2

        dp_r = -0.5 * (dg_tt_dr * p_t * p_t
                       + 2.0 * dg_tphi_dr * p_t * p_phi
                       + dg_rr_dr * p_r * p_r
                       + dg_thth_dr * p_th * p_th
                       + dg_phiphi_dr * p_phi * p_phi)

        # -- polar derivatives of the inverse metric --
        sc = sin_th * cos_th
        dSigma_dth = -2.0 * a2 * sc
        dA_dth = -2.0 * a2 * Delta * sc

        dg_tt_dth = -(dA_dth * SD - A * dSigma_dth * Delta) * inv_SD2
        if q2:
            dg_tphi_dth = a * W * dSigma_dth * inv_S2 * inv_Delta
        else:
            dg_tphi_dth = ((2.0 * M * a * r_s * dSigma_dth) * inv_S2
                           * inv_Delta)
        dg_rr_dth = -Delta * dSigma_dth * inv_S2
        dg_thth_dth = -dSigma_dth * inv_S2

        num = Delta - a2 * sin2
        dnum_dth = -2.0 * a2 * sc
        dden_dth = dSigma_dth * Delta * sin2 + 2.0 * SD * sc
        dg_phiphi_dth = (dnum_dth * den_phi - num * dden_dth) * inv_den_phi2

        dp_th = -0.5 * (dg_tt_dth * p_t * p_t
                        + 2.0 * dg_tphi_dth * p_t * p_phi
                        + dg_rr_dth * p_r * p_r
                        + dg_thth_dth * p_th * p_th
                        + dg_phiphi_dth * p_phi * p_phi)

        out = torch.stack((dr, dth, dphi, dp_r, dp_th))
        return torch.where(frozen, torch.zeros_like(out), out)

    def rhs5_mu(self, state5, p_t, p_phi):
        """Hamilton's equations on the reduced 5-D mu-state, batched.

        state5 = (r, mu, phi, p_r, p_mu) with mu = cos(theta): the same
        Hamiltonian as `rhs5` after the canonical transformation (g^mumu
        = s / Sigma with s = sin^2 = (1 - mu)(1 + mu)), so every component
        is a rational function of (r, mu), with no transcendental
        function. Hard-zeroed inside r <= 1.001 r_+ like rhs5; returns a
        (5, N) tensor.
        """
        r, mu, _phi, p_r, p_mu = state5
        M, a = _scalar(self.M, r), _scalar(self.a, r)
        r_plus = _scalar(self.r_plus, r)

        frozen = r <= r_plus * 1.001
        r_s = torch.where(frozen, 10.0 * r_plus + 10.0, r)

        a2 = a * a
        r2 = r_s * r_s
        s = torch.clamp((1.0 - mu) * (1.0 + mu), min=_SIN2_FLOOR)
        Sigma = r2 + a2 * mu * mu
        Delta = r2 - 2.0 * M * r_s + a2
        q2 = self._q2
        if q2:
            Delta = Delta + q2                 # Kerr-Newman
        ra2 = r2 + a2
        A = ra2 * ra2 - a2 * Delta * s

        inv_Sigma = 1.0 / Sigma
        inv_Delta = 1.0 / Delta
        inv_s = 1.0 / s
        inv_SD = inv_Sigma * inv_Delta
        inv_SD2 = inv_SD * inv_SD
        inv_S2 = inv_Sigma * inv_Sigma

        g_rr = Delta * inv_Sigma
        g_mumu = s * inv_Sigma
        if q2:
            W = 2.0 * M * r_s - q2
            g_tphi = -a * W * inv_SD
        else:
            g_tphi = -2.0 * M * a * r_s * inv_SD
        g_phiphi = (Delta - a2 * s) * inv_SD * inv_s

        dr = g_rr * p_r
        dmu = g_mumu * p_mu
        dphi = g_tphi * p_t + g_phiphi * p_phi

        # -- radial derivatives (s does not depend on r) --
        SD = Sigma * Delta
        dSigma_dr = 2.0 * r_s
        dDelta_dr = 2.0 * r_s - 2.0 * M
        dA_dr = 4.0 * r_s * ra2 - a2 * dDelta_dr * s
        dSD_dr = dSigma_dr * Delta + Sigma * dDelta_dr

        dg_tt_dr = -(dA_dr * SD - A * dSD_dr) * inv_SD2
        if q2:
            dg_tphi_dr = -a * (2.0 * M * SD - W * dSD_dr) * inv_SD2
        else:
            dg_tphi_dr = -(2.0 * M * a * (SD - r_s * dSD_dr)) * inv_SD2
        dg_rr_dr = (dDelta_dr * Sigma - Delta * dSigma_dr) * inv_S2
        dg_mumu_dr = -s * dSigma_dr * inv_S2
        inv_den_phi = inv_SD * inv_s
        inv_den_phi2 = inv_den_phi * inv_den_phi
        den_phi = SD * s
        num = Delta - a2 * s
        dg_phiphi_dr = (dDelta_dr * den_phi
                        - num * dSD_dr * s) * inv_den_phi2

        dp_r = -0.5 * (dg_tt_dr * p_t * p_t
                       + 2.0 * dg_tphi_dr * p_t * p_phi
                       + dg_rr_dr * p_r * p_r
                       + dg_mumu_dr * p_mu * p_mu
                       + dg_phiphi_dr * p_phi * p_phi)

        # -- polar (mu) derivatives, all polynomial in mu --
        ds_dmu = -2.0 * mu
        dSigma_dmu = 2.0 * a2 * mu
        dA_dmu = 2.0 * a2 * Delta * mu
        dSD_dmu = dSigma_dmu * Delta

        dg_tt_dmu = -(dA_dmu * SD - A * dSD_dmu) * inv_SD2
        if q2:
            dg_tphi_dmu = a * W * dSD_dmu * inv_SD2
        else:
            dg_tphi_dmu = 2.0 * M * a * r_s * dSD_dmu * inv_SD2
        dg_rr_dmu = -Delta * dSigma_dmu * inv_S2
        dg_mumu_dmu = (ds_dmu * Sigma - s * dSigma_dmu) * inv_S2
        dnum_dmu = 2.0 * a2 * mu
        dden_dmu = dSD_dmu * s + SD * ds_dmu
        dg_phiphi_dmu = (dnum_dmu * den_phi
                         - num * dden_dmu) * inv_den_phi2

        dp_mu = -0.5 * (dg_tt_dmu * p_t * p_t
                        + 2.0 * dg_tphi_dmu * p_t * p_phi
                        + dg_rr_dmu * p_r * p_r
                        + dg_mumu_dmu * p_mu * p_mu
                        + dg_phiphi_dmu * p_phi * p_phi)

        out = torch.stack((dr, dmu, dphi, dp_r, dp_mu))
        return torch.where(frozen, torch.zeros_like(out), out)

    def tdot(self, state5, p_t, p_phi):
        """Coordinate-time rate dt/dlambda = g^tt p_t + g^tphi p_phi
        along the reduced flow: the t-row of the full Hamiltonian system
        that the 5-D state drops. t never feeds back into the dynamics;
        the flare movie integrates it as an extra component."""
        r, th = state5[0], state5[1]
        M, a = _scalar(self.M, r), _scalar(self.a, r)
        g_tt, g_tphi, *_rest = self._inv_terms(r, th, M, a)
        return g_tt * p_t + g_tphi * p_phi

    def extract_angle(self, state5, p_t, p_phi, captured):
        """Final deflection angle from the integrated state, batched.

        Returns (status, final_alpha, n_half): status 1 escaped,
        -1 captured, 0 invalid.
        """
        r_f, th_f, phi_f, p_r_f, p_th_f = state5
        M, a = _scalar(self.M, r_f), _scalar(self.a, r_f)
        r_reclass = self.reclass_radius()

        # the kernel divides by pi (light_path_tracer_tpu_torch/operands.py)
        n_half = torch.floor(torch.abs(phi_f)
                             / kernel_operand(math.pi, phi_f)).to(torch.int32)
        is_captured = captured | (r_f <= r_reclass)
        bad_state = ~(torch.isfinite(r_f) & torch.isfinite(th_f)
                      & torch.isfinite(phi_f))

        sin_th = torch.sin(th_f)
        cos_th = torch.cos(th_f)
        sin2 = torch.clamp(sin_th * sin_th, min=_SIN2_FLOOR)
        r_s = torch.where(bad_state | is_captured, 10.0 * M + 10.0, r_f)
        Sigma_f = r_s * r_s + a * a * cos_th * cos_th
        Delta_f = self._Delta_b(r_s, M, a)
        degenerate = (Sigma_f <= 1e-15) | (torch.abs(Delta_f) <= 1e-15)
        Sigma_safe = torch.where(degenerate, torch.ones_like(Sigma_f),
                                 Sigma_f)
        Delta_safe = torch.where(degenerate, torch.ones_like(Delta_f),
                                 Delta_f)

        dr_dl = Delta_safe / Sigma_safe * p_r_f
        dth_dl = p_th_f / Sigma_safe
        dphi_dl = (-a * self._two_M_r(r_s, M)
                   / (Sigma_safe * Delta_safe) * p_t
                   + (Delta_safe - a * a * sin2)
                   / (Sigma_safe * Delta_safe * sin2) * p_phi)

        sin_phi = torch.sin(phi_f)
        cos_phi = torch.cos(phi_f)
        vx = (sin_th * cos_phi * dr_dl
              + r_s * cos_th * cos_phi * dth_dl
              - r_s * sin_th * sin_phi * dphi_dl)
        vy = (sin_th * sin_phi * dr_dl
              + r_s * cos_th * sin_phi * dth_dl
              + r_s * sin_th * cos_phi * dphi_dl)
        vz = cos_th * dr_dl - r_s * sin_th * dth_dl

        bad_v = ~(torch.isfinite(vx) & torch.isfinite(vy)
                  & torch.isfinite(vz))
        v_mag = torch.sqrt(vx * vx + vy * vy + vz * vz)
        tiny_v = v_mag < 1e-30
        v_safe = torch.where(tiny_v, torch.ones_like(v_mag), v_mag)
        final_alpha = torch.arccos(torch.clamp(-vx / v_safe, -1.0, 1.0))

        invalid = bad_state | degenerate | bad_v
        status = torch.where(
            is_captured, -1, torch.where(invalid, 0, 1)).to(torch.int32)
        final_alpha = torch.where(is_captured | invalid | tiny_v,
                                  torch.full_like(final_alpha, math.nan),
                                  final_alpha)
        n_half = torch.where(bad_state & ~is_captured,
                             torch.zeros_like(n_half), n_half)
        return status, final_alpha, n_half


class TracedKerr(Kerr):
    """Kerr with run-time (M, a): the sequences' metric (the JAX package's
    `TracedKerr`, whose M and a are traced float32 scalars).

    M and a are rounded to float32, and the radii that the hot path and
    the kernel take are formed from them in float32 as JAX's traced
    scalars form them: r_+ = M + sqrt(max(M M - a a, 0)), the capture
    radius r_+ 1.01, the freeze radius r_+ 1.001 and the reclassification
    radius (r_+ 1.01) 1.1, each product rounded once. The static `Kerr`
    forms them in float64 and rounds once, which can differ by an ulp.
    Every value is kept as a Python float holding the float32 number, so
    each batched method reads it exactly. Only the batched hot path is
    meant (as in JAX: no host-side geometry, and no |a| <= M check).
    """

    def __init__(self, M, a):
        m32, a32 = np.float32(M), np.float32(a)
        r_plus = m32 + np.sqrt(np.maximum(m32 * m32 - a32 * a32,
                                          np.float32(0.0)))
        capture = r_plus * np.float32(1.01)
        object.__setattr__(self, "M", float(m32))
        object.__setattr__(self, "a", float(a32))
        object.__setattr__(self, "_radii", dict(
            r_plus=float(r_plus), capture=float(capture),
            freeze=float(r_plus * np.float32(1.001)),
            reclass=float(capture * np.float32(1.1))))

    @property
    def r_plus(self) -> float:
        return self._radii["r_plus"]

    def capture_radius(self) -> float:
        return self._radii["capture"]

    def reclass_radius(self) -> float:
        return self._radii["reclass"]

    def _freeze_radius(self) -> float:
        return self._radii["freeze"]
