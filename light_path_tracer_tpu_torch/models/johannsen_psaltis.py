"""Johannsen-Psaltis deformed Kerr: the test-GR metric family.

The PyTorch counterpart of `light_path_tracer_tpu.models.johannsen_psaltis`
(Johannsen & Psaltis 2011, PRD 83, 124015). Keeping the leading
deformation h(r, theta) = eps3 M^3 r / Sigma^2, the line element is Kerr's
with

    g_tt     = -(1 + h) (1 - 2 M r / Sigma)
    g_tphi   = -(2 a M r sin^2(theta) / Sigma) (1 + h)
    g_rr     = Sigma (1 + h) / (Delta + a^2 h sin^2(theta))
    g_thth   = Sigma
    g_phiphi = sin^2(theta) [r^2 + a^2 + 2 a^2 M r sin^2(theta)/Sigma]
               + h a^2 sin^2(theta) (Sigma + 2 M r) / Sigma

(Sigma, Delta as in Kerr). There is no Carter constant, so the Kerr
separability tricks (the plunge exit, the (xi, eta) photon-orbit band,
the mu chart) do not exist; the reduced 5-D integrator needs only the two
Killing symmetries. `_inv_terms` inverts the (t, phi) block exactly,
`rhs5` is the JAX package's hand-derived closed form, term for term
(closed-form r/theta partials of the covariant components pushed through
the 2x2 block-inverse derivative chain), and `alpha_crit` bisects traced
outcomes (models/numeric.py). The initial conditions reuse Kerr's
Bardeen screen mapping at the observer, where h ~ eps3 (M/r_obs)^3, and
make the momentum null through the JP inverse metric; the angle
extraction is Kerr's. The CUDA kernel (csrc/kerr_dp45.cu, family
kJohannsenPsaltis) carries the same formulas.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.kerr import (Kerr, _SIN2_FLOOR,
                                                     _scalar)


def covariant_terms_jp(M, a, eps3, r, th):
    """Covariant JP components (g_tt, g_tphi, g_rr, g_thth, g_phiphi) at
    tensors (r, th); M, a, eps3 are 0-dim tensors."""
    sin_th = torch.sin(th)
    cos_th = torch.cos(th)
    sin2 = torch.clamp(sin_th * sin_th, min=_SIN2_FLOOR)
    r2 = r * r
    a2 = a * a
    Sigma = r2 + a2 * cos_th * cos_th
    Delta = r2 - 2.0 * M * r + a2
    h = eps3 * (M * M * M) * r / (Sigma * Sigma)
    two_Mr = 2.0 * M * r
    g_tt = -(1.0 + h) * (1.0 - two_Mr / Sigma)
    g_tphi = -(a * two_Mr * sin2 / Sigma) * (1.0 + h)
    g_rr = Sigma * (1.0 + h) / (Delta + a2 * h * sin2)
    g_thth = Sigma
    g_phiphi = (sin2 * (r2 + a2 + a2 * two_Mr * sin2 / Sigma)
                + h * a2 * sin2 * (Sigma + two_Mr) / Sigma)
    return g_tt, g_tphi, g_rr, g_thth, g_phiphi


def covariant_derivs_jp(M, a, eps3, r, th):
    """The covariant components and their closed-form r and theta
    partials: {name: (value, d/dr, d/dtheta)}. The sin^2 floor's
    derivative is zero where the floor binds, as autodiff of the clamp
    gives it."""
    s = torch.sin(th)
    c = torch.cos(th)
    s2_raw = s * s
    s2 = torch.clamp(s2_raw, min=_SIN2_FLOOR)
    s2p = torch.where(s2_raw >= _SIN2_FLOOR, 2.0 * s * c,
                      torch.zeros_like(s2_raw))
    r2, a2 = r * r, a * a
    Sig = r2 + a2 * c * c
    Sig_r = 2.0 * r
    Sig_t = -2.0 * a2 * s * c
    Del = r2 - 2.0 * M * r + a2
    Del_r = 2.0 * r - 2.0 * M
    M3 = M * M * M
    h = eps3 * M3 * r / (Sig * Sig)
    h_r = eps3 * M3 * (Sig - 4.0 * r2) / (Sig * Sig * Sig)
    h_t = -2.0 * eps3 * M3 * r * Sig_t / (Sig * Sig * Sig)
    W = 2.0 * M * r / Sig
    W_r = 2.0 * M / Sig - W * Sig_r / Sig
    W_t = -W * Sig_t / Sig
    oh = 1.0 + h
    g_tt = -oh * (1.0 - W)
    g_tt_r = -h_r * (1.0 - W) + oh * W_r
    g_tt_t = -h_t * (1.0 - W) + oh * W_t
    g_tp = -a * W * s2 * oh
    g_tp_r = -a * s2 * (W_r * oh + W * h_r)
    g_tp_t = -a * (s2p * W * oh + s2 * (W_t * oh + W * h_t))
    B = Del + a2 * h * s2
    B_r = Del_r + a2 * h_r * s2
    B_t = a2 * (h_t * s2 + h * s2p)
    g_rr = Sig * oh / B
    g_rr_r = (Sig_r * oh + Sig * h_r) / B - g_rr * B_r / B
    g_rr_t = (Sig_t * oh + Sig * h_t) / B - g_rr * B_t / B
    P = r2 + a2 + a2 * W * s2 + a2 * h * (1.0 + W)
    P_r = 2.0 * r + a2 * W_r * s2 + a2 * (h_r * (1.0 + W) + h * W_r)
    P_t = a2 * (W_t * s2 + W * s2p) + a2 * (h_t * (1.0 + W) + h * W_t)
    return dict(g_tt=(g_tt, g_tt_r, g_tt_t),
                g_tp=(g_tp, g_tp_r, g_tp_t),
                g_rr=(g_rr, g_rr_r, g_rr_t),
                g_thth=(Sig, Sig_r, Sig_t),
                g_pp=(s2 * P, s2 * P_r, s2p * P + s2 * P_t))


def _safe_det(D):
    """The (t, phi) block determinant with |D| < 1e-30 replaced by
    1e-30."""
    return torch.where(torch.abs(D) < 1e-30, torch.full_like(D, 1e-30), D)


@dataclasses.dataclass(frozen=True)
class JohannsenPsaltis(Kerr):
    eps3: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        # For eps3 < 0 the deformation moves the inner pathology outside
        # Kerr's horizon: g^rr flips sign where Delta + a^2 h sin^2 = 0,
        # and 1 + h = 0 kills the (t, phi) block. The capture surface
        # parks rays just outside the outermost such root, found by the
        # JAX package's host scan (the same float); for eps3 >= 0 it is
        # Kerr's 1.01 r_+.
        M, a, eps3 = self.M, self.a, self.eps3
        r = np.linspace(1e-3, 4.0 * self.r_plus + 4.0, 4001)
        th = np.linspace(1e-3, np.pi - 1e-3, 61)[:, None]
        Sigma = r[None, :] ** 2 + a ** 2 * np.cos(th) ** 2
        Delta = r ** 2 - 2.0 * M * r + a ** 2
        h = eps3 * M ** 3 * r[None, :] / Sigma ** 2
        sin2 = np.sin(th) ** 2
        bad = ((Delta[None, :] + a ** 2 * h * sin2) <= 0.0) \
            | ((1.0 + h) <= 0.0)
        bad_any = bad.any(axis=0)
        r_barrier = float(r[bad_any.nonzero()[0].max()]) \
            if bad_any.any() else 0.0
        object.__setattr__(
            self, "_r_capture",
            max(1.01 * self.r_plus, 1.02 * r_barrier))

    def capture_radius(self) -> float:
        return self._r_capture

    def _freeze_radius(self) -> float:
        # Just inside the capture surface, so RK stages probing below it
        # stay on finite metric components.
        return 0.995 * self._r_capture

    def _inv_terms(self, r, th, M, a):
        """Exact contravariant components: the (t, phi) block inverts as
        a 2x2 (g^tt = g_phiphi / D, g^tphi = -g_tphi / D, g^phiphi =
        g_tt / D, D = g_tt g_phiphi - g_tphi^2); r and theta are
        diagonal."""
        eps3 = _scalar(self.eps3, r)
        g_tt, g_tphi, g_rr, g_thth, g_phiphi = covariant_terms_jp(
            M, a, eps3, r, th)
        D_safe = _safe_det(g_tt * g_phiphi - g_tphi * g_tphi)
        return (g_phiphi / D_safe, -g_tphi / D_safe, 1.0 / g_rr,
                1.0 / g_thth, g_tt / D_safe)

    def rhs5(self, state5, p_t, p_phi):
        """Hand-derived JP Hamiltonian RHS on the reduced theta-state,
        hard-zeroed inside the freeze radius. With D = g_tt g_pp - g_tp^2,

            d(g^tt)   = (d g_pp  - g^tt   dD) / D
            d(g^tphi) = (-d g_tp - g^tphi dD) / D
            d(g^pp)   = (d g_tt  - g^pp   dD) / D
            d(g^rr)   = -d g_rr (g^rr)^2,  d(g^thth) = -d Sigma / Sigma^2

        and (dr, dth, dphi, dp_r, dp_th) = (g^rr p_r, g^thth p_th,
        g^tphi p_t + g^pp p_phi, -dH/dr, -dH/dtheta). Returns a (5, N)
        tensor."""
        r, th, _phi, p_r, p_th = state5
        M, a = _scalar(self.M, r), _scalar(self.a, r)
        eps3 = _scalar(self.eps3, r)
        r_freeze = _scalar(self._freeze_radius(), r)
        frozen = r <= r_freeze
        r_s = torch.where(frozen, 10.0 * r_freeze + 10.0, r)

        cv = covariant_derivs_jp(M, a, eps3, r_s, th)
        g_tt, g_tt_r, g_tt_t = cv["g_tt"]
        g_tp, g_tp_r, g_tp_t = cv["g_tp"]
        g_rr, g_rr_r, g_rr_t = cv["g_rr"]
        Sig, Sig_r, Sig_t = cv["g_thth"]
        g_pp, g_pp_r, g_pp_t = cv["g_pp"]

        D = g_tt * g_pp - g_tp * g_tp
        D_r = g_tt_r * g_pp + g_tt * g_pp_r - 2.0 * g_tp * g_tp_r
        D_t = g_tt_t * g_pp + g_tt * g_pp_t - 2.0 * g_tp * g_tp_t
        Ds = _safe_det(D)
        i_tt = g_pp / Ds
        i_tp = -g_tp / Ds
        i_pp = g_tt / Ds
        i_tt_r = (g_pp_r - i_tt * D_r) / Ds
        i_tt_t = (g_pp_t - i_tt * D_t) / Ds
        i_tp_r = (-g_tp_r - i_tp * D_r) / Ds
        i_tp_t = (-g_tp_t - i_tp * D_t) / Ds
        i_pp_r = (g_tt_r - i_pp * D_r) / Ds
        i_pp_t = (g_tt_t - i_pp * D_t) / Ds
        i_rr = 1.0 / g_rr
        i_rr_r = -g_rr_r * i_rr * i_rr
        i_rr_t = -g_rr_t * i_rr * i_rr
        i_hh = 1.0 / Sig
        i_hh_r = -Sig_r * i_hh * i_hh
        i_hh_t = -Sig_t * i_hh * i_hh

        p_t = torch.broadcast_to(torch.as_tensor(p_t, dtype=r.dtype,
                                                 device=r.device), r.shape)
        p_phi = torch.broadcast_to(torch.as_tensor(
            p_phi, dtype=r.dtype, device=r.device), r.shape)
        dr = i_rr * p_r
        dth = i_hh * p_th
        dphi = i_tp * p_t + i_pp * p_phi
        dHr = 0.5 * (i_tt_r * p_t * p_t
                     + 2.0 * i_tp_r * p_t * p_phi
                     + i_rr_r * p_r * p_r
                     + i_hh_r * p_th * p_th
                     + i_pp_r * p_phi * p_phi)
        dHt = 0.5 * (i_tt_t * p_t * p_t
                     + 2.0 * i_tp_t * p_t * p_phi
                     + i_rr_t * p_r * p_r
                     + i_hh_t * p_th * p_th
                     + i_pp_t * p_phi * p_phi)
        out = torch.stack((dr, dth, dphi, -dHr, -dHt))
        return torch.where(frozen, torch.zeros_like(out), out)

    def rhs5_mu(self, state5, p_t, p_phi):
        raise NotImplementedError(
            "the mu = cos(theta) chart is wired for the hand-derived "
            "Kerr/Kerr-Newman RHS only; JP integrates in theta form")

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """The certain-plunge exit is off (radius 0 on every ray): its
        photon-orbit band argument needs Carter separability."""
        return torch.zeros_like(alphas)

    def alpha_crit(self, r_obs, theta_obs=None, n_azimuth: int = 16,
                   iters: int = 26, max_steps: int = 60000,
                   device=None) -> float:
        """Shadow-envelope critical angle by bisection on traced outcomes
        (models/numeric.py alpha_crit_traced) on `device`: the float64
        CUDA kernel on a CUDA device (the default), the plain loop on
        the CPU."""
        from light_path_tracer_tpu_torch.models.numeric import (
            alpha_crit_traced)
        return alpha_crit_traced(self, r_obs, theta_obs,
                                 n_azimuth=n_azimuth, iters=iters,
                                 max_steps=max_steps, device=device)
