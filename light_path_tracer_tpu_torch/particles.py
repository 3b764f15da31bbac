"""Timelike (massive-particle) geodesics: bound orbits and their dynamics.

The counterpart of `light_path_tracer_tpu.particles`. The 8-D flow of
every metric (`geodesic_equations`) is generated by H = (1/2) g^{mu nu}
p_mu p_nu, which does not depend on the rest mass: the same Hamilton's
equations integrate null and timelike geodesics, and the mass enters only
through the normalisation g^{mu nu} p_mu p_nu = -mu^2. Massive orbits
therefore ride the adaptive DP45 path recorder
(trajectory.integrate_geodesic_8d_adaptive) unchanged, plain PyTorch on
the tensors' device.

  * `circular_orbit`: the Bardeen-Press-Teukolsky equatorial
    circular-orbit integrals (E, L, Omega), with the charged families'
    W = 2Mr - Q^2;
  * `orbit_from_apsides`: (E, L) of the bound orbit with the requested
    (r_peri, r_apo), by 2x2 Newton on the radial potential (host float64);
  * `timelike_initial_conditions`: batched 8-D states with the timelike
    normalisation, for any metric with `_inv_terms` or the spherically
    symmetric `f`;
  * `integrate_orbit`: the DP45 recorder with the escape event pushed
    out of the way of bound orbits;
  * host diagnostics in float64 NumPy: periapsis passages and
    precession, ascending-node drift (Lense-Thirring), and the
    Hamiltonian residual.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch.trajectory import (
    Trajectory, integrate_geodesic_8d_adaptive)


# ---------------------------------------------------------------------------
# Metric access helpers (every shipped family)
# ---------------------------------------------------------------------------

def _spin_charge(metric):
    return float(getattr(metric, "a", 0.0)), float(getattr(metric, "Q", 0.0))


def inverse_metric_at(metric, r, th):
    """Contravariant (g^tt, g^tphi, g^rr, g^thth, g^phiphi) at tensors
    (r, theta): from `_inv_terms` (the Kerr family) or from `f(r)` (a
    diagonal inverse, the spherically symmetric families)."""
    if hasattr(metric, "_inv_terms"):
        return tuple(metric._inv_terms(r, th, metric.M, metric.a)[:5])
    if hasattr(metric, "f"):
        f = metric.f(r)
        sin2 = torch.clamp(torch.sin(th) ** 2, min=1e-30)
        r2 = r * r
        zero = torch.zeros_like(f)
        return -1.0 / f, zero, f, 1.0 / r2, 1.0 / (r2 * sin2)
    raise TypeError(f"{type(metric).__name__} exposes neither _inv_terms "
                    "nor f(r); cannot build timelike initial conditions")


def _covariant_equatorial(metric, r):
    """Covariant equatorial (g_tt, g_tphi, g_phiphi) in float64 NumPy:
    the Boyer-Lindquist block with W = 2Mr - Q^2 for the Kerr family,
    (-f, 0, r^2) for the spherically symmetric ones."""
    M = float(metric.M)
    a, Q = _spin_charge(metric)
    r = np.asarray(r, np.float64)
    if hasattr(metric, "_inv_terms"):
        w = (2.0 * M * r - Q * Q) / (r * r)
        return -(1.0 - w), -a * w, r * r + a * a + a * a * w
    f = 1.0 - 2.0 * M / r + Q * Q / (r * r) if Q else np.asarray(
        metric.f(r), np.float64)
    return -f, np.zeros_like(r), r * r


# ---------------------------------------------------------------------------
# Circular orbits (Bardeen-Press-Teukolsky, charged)
# ---------------------------------------------------------------------------

def circular_orbit(metric, r, prograde: bool = True):
    """Equatorial timelike circular orbit at Boyer-Lindquist radius r.

    Returns (E, L, Omega) per unit rest mass: Omega = +-x / (r^2 +- a x)
    with x = sqrt(M r - Q^2), then u^t = 1 / sqrt(-(g_tt + 2 Omega g_tphi
    + Omega^2 g_phiphi)), E = -(g_tt + Omega g_tphi) u^t and
    L = (g_tphi + Omega g_phiphi) u^t. ValueError where no timelike
    circular orbit exists.
    """
    M = float(metric.M)
    a, Q = _spin_charge(metric)
    r = float(r)
    x2 = M * r - Q * Q
    if x2 <= 0.0:
        raise ValueError(f"no circular orbit at r={r} (M r <= Q^2)")
    x = np.sqrt(x2)
    s = 1.0 if prograde else -1.0
    omega = s * x / (r * r + s * a * x)
    g_tt, g_tphi, g_phiphi = _covariant_equatorial(metric, r)
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    if norm <= 0.0:
        raise ValueError(f"no timelike circular orbit at r={r} "
                         "(inside the photon orbit)")
    u_t = 1.0 / np.sqrt(norm)
    E = -(g_tt + omega * g_tphi) * u_t
    L = (g_tphi + omega * g_phiphi) * u_t
    return float(E), float(L), float(omega)


def orbit_from_apsides(metric, r_peri, r_apo, prograde: bool = True,
                       mu: float = 1.0):
    """(E, L) of the equatorial bound orbit with turning points (r_p, r_a):
    R(r_p) = R(r_a) = 0 with R(r) = -mu^2 - (g^tt E^2 - 2 g^tphi E L +
    g^phiphi L^2), by 2x2 Newton from the circular orbit at the semi-latus
    rectum. Host-side float64."""
    r_p, r_a = float(r_peri), float(r_apo)
    if not (0.0 < r_p <= r_a):
        raise ValueError(f"need 0 < r_peri <= r_apo, got {r_p}, {r_a}")
    if r_p == r_a:
        E, L, _ = circular_orbit(metric, r_p, prograde)
        return E, L

    rr = torch.tensor([r_p, r_a], dtype=torch.float64)
    g_tt, g_tphi, _g_rr, _g_thth, g_phiphi = (
        np.asarray(torch.as_tensor(t).cpu(), np.float64)
        for t in inverse_metric_at(metric, rr,
                                   torch.full_like(rr, np.pi / 2)))

    def residual(E, L):
        quad = g_tt * E * E - 2.0 * g_tphi * E * L + g_phiphi * L * L
        return -mu * mu - quad

    p_lat = 2.0 * r_p * r_a / (r_p + r_a)  # semi-latus rectum
    E, L, _ = circular_orbit(metric, p_lat, prograde)
    for _ in range(100):
        F = residual(E, L)
        if np.max(np.abs(F)) < 1e-14:
            break
        dF_dE = -(2.0 * g_tt * E - 2.0 * g_tphi * L)
        dF_dL = -(-2.0 * g_tphi * E + 2.0 * g_phiphi * L)
        det = dF_dE[0] * dF_dL[1] - dF_dE[1] * dF_dL[0]
        if det == 0.0:
            raise ValueError("singular apsides system (marginally "
                             "bound/unstable orbit?)")
        dE = (F[0] * dF_dL[1] - F[1] * dF_dL[0]) / det
        dL = (dF_dE[0] * F[1] - dF_dE[1] * F[0]) / det
        E, L = E - dE, L - dL
    else:
        raise ValueError(f"apsides Newton did not converge for "
                         f"({r_p}, {r_a}); residual {F}")
    if E <= 0.0:
        raise ValueError("converged to a nonphysical branch (E <= 0)")
    return float(E), float(L)


# ---------------------------------------------------------------------------
# Initial conditions + integration
# ---------------------------------------------------------------------------

def timelike_initial_conditions(metric, r0, E, L, theta0=np.pi / 2,
                                phi0=0.0, p_theta=0.0, mu: float = 1.0,
                                outward: bool = False,
                                dtype=torch.float64, device=None):
    """Batched 8-D state [t, r, th, phi, p_t, p_r, p_th, p_phi] with the
    timelike normalisation g^{mu nu} p_mu p_nu = -mu^2 (mu = 0: a
    photon); p_r from the normalisation, inward unless `outward`. Returns
    (state8, invalid), invalid where the point is classically forbidden
    (g^rr p_r^2 < 0). Broadcasts over r0, E, L, theta0, phi0, p_theta.
    device: None puts the state on r0's device when r0 is a tensor, else
    on the card."""
    if device is None:
        device = r0.device if isinstance(r0, torch.Tensor) else "cuda"
    r0, E, L, theta0, phi0, p_theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=dtype, device=device)
          for v in (r0, E, L, theta0, phi0, p_theta)))
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = inverse_metric_at(
        metric, r0, theta0)
    quad = (g_tt * E * E - 2.0 * g_tphi * E * L + g_phiphi * L * L
            + g_thth * p_theta * p_theta)
    p_r_sq = (-mu * mu - quad) / g_rr
    invalid = p_r_sq < -1e-12 * (mu * mu + E * E)
    sign = 1.0 if outward else -1.0
    p_r = sign * torch.sqrt(torch.clamp(p_r_sq, min=0.0))
    zeros = torch.zeros_like(r0)
    state8 = torch.stack(
        [zeros, r0, theta0, phi0, -E, p_r, p_theta, L], dim=-1)
    return state8, invalid


def integrate_orbit(metric, state8, n_steps: int = 6000,
                    r_escape: float | None = None,
                    rtol: float = 1e-10, atol: float = 1e-12) -> Trajectory:
    """Integrate timelike state(s) with the adaptive DP45 recorder on the
    state's device: the capture event at the horizon, the escape event at
    `r_escape` (default 50x the initial radius) so bound orbits are never
    clipped, and tolerances 1e-10 / 1e-12 (precession accumulates phase
    over many orbits). A bound orbit that spends its budget reports
    outcome 1; only -1 (plunged) is meaningful for orbits."""
    r0 = float(state8[..., 1].max())
    if r_escape is None:
        r_escape = 50.0 * r0
    return integrate_geodesic_8d_adaptive(
        metric, state8, r_obs=0.5 * float(r_escape), n_steps=n_steps,
        rtol=rtol, atol=atol)


def hamiltonian(metric, states8):
    """(1/2) g^{mu nu} p_mu p_nu along recorded states (..., 8): -mu^2/2
    along any geodesic, so its residual measures the integrator."""
    r, th = states8[..., 1], states8[..., 2]
    p_t, p_r, p_th, p_phi = (states8[..., 4], states8[..., 5],
                             states8[..., 6], states8[..., 7])
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = inverse_metric_at(metric, r, th)
    return 0.5 * (g_tt * p_t * p_t + 2.0 * g_tphi * p_t * p_phi
                  + g_rr * p_r * p_r + g_thth * p_th * p_th
                  + g_phiphi * p_phi * p_phi)


# ---------------------------------------------------------------------------
# Host-side orbit diagnostics (float64 NumPy)
# ---------------------------------------------------------------------------

def _valid_path(traj: Trajectory):
    n = int(traj.n_valid)
    states = traj.states[:n].detach().cpu().numpy().astype(np.float64)
    lams = traj.lambdas[:n].detach().cpu().numpy().astype(np.float64)
    return states, lams


def apsis_passages(traj: Trajectory, kind: str = "peri"):
    """Interior r-extrema along one recorded orbit: (lam, r, phi, t)
    arrays at each periapsis ('peri') or apoapsis ('apo'), refined by
    3-point parabolic interpolation in lambda; phi unwrapped, so
    successive periapsis angles differ by ~2 pi + the advance."""
    states, lams = _valid_path(traj)
    r = states[:, 1]
    phi = np.unwrap(states[:, 3])
    t = states[:, 0]
    if kind == "peri":
        interior = (r[1:-1] <= r[:-2]) & (r[1:-1] <= r[2:])
    elif kind == "apo":
        interior = (r[1:-1] >= r[:-2]) & (r[1:-1] >= r[2:])
    else:
        raise ValueError(f"kind must be 'peri' or 'apo', got {kind!r}")
    idx = np.nonzero(interior)[0] + 1
    # Drop duplicate flat-extremum neighbours (plateaus).
    idx = idx[np.concatenate([[True], np.diff(idx) > 1])]
    out_lam, out_r, out_phi, out_t = [], [], [], []
    for i in idx:
        l0, l1, l2 = lams[i - 1], lams[i], lams[i + 1]
        r0, r1, r2 = r[i - 1], r[i], r[i + 1]
        denom = (l0 - l1) * (l0 - l2) * (l1 - l2)
        if denom == 0.0:
            lam_star = l1
        else:
            # Vertex of the parabola through the three samples.
            A = (l2 * (r1 - r0) + l1 * (r0 - r2) + l0 * (r2 - r1)) / denom
            B = (l2 * l2 * (r0 - r1) + l1 * l1 * (r2 - r0)
                 + l0 * l0 * (r1 - r2)) / denom
            lam_star = l1 if A == 0.0 else np.clip(-B / (2 * A), l0, l2)
        out_lam.append(lam_star)
        out_r.append(np.interp(lam_star, [l0, l1, l2], [r0, r1, r2]))
        out_phi.append(np.interp(lam_star, lams[i - 1:i + 2],
                                 phi[i - 1:i + 2]))
        out_t.append(np.interp(lam_star, lams[i - 1:i + 2],
                               t[i - 1:i + 2]))
    return (np.asarray(out_lam), np.asarray(out_r), np.asarray(out_phi),
            np.asarray(out_t))


def periapsis_precession(traj: Trajectory):
    """Per-orbit periapsis advance |Delta phi| - 2 pi [rad], one value per
    successive periapsis pair (sign-folded, so GR's advance is positive
    in both senses of rotation)."""
    _, _, phis, _ = apsis_passages(traj, "peri")
    if len(phis) < 2:
        raise ValueError("need >= 2 periapsis passages to measure "
                         "precession; integrate more orbits")
    return np.abs(np.diff(phis)) - 2.0 * np.pi


def nodal_precession(traj: Trajectory):
    """Ascending-node drift (Lense-Thirring): the per-orbit advance of
    the unwrapped phi at successive ascending nodes (theta crossing pi/2
    from above). Returns (drift, lambda at each node but the last)."""
    states, lams = _valid_path(traj)
    th = states[:, 2] - np.pi / 2
    phi = np.unwrap(states[:, 3])
    crossing = (th[:-1] > 0.0) & (th[1:] <= 0.0)
    idx = np.nonzero(crossing)[0]
    if len(idx) < 2:
        raise ValueError("need >= 2 ascending nodes; integrate more "
                         "orbits or incline the orbit")
    frac = th[idx] / (th[idx] - th[idx + 1])
    phi_node = phi[idx] + frac * (phi[idx + 1] - phi[idx])
    lam_node = lams[idx] + frac * (lams[idx + 1] - lams[idx])
    return np.abs(np.diff(phi_node)) - 2.0 * np.pi, lam_node[:-1]


def weak_field_periapsis_advance(M, a, r_peri, r_apo,
                                 prograde: bool = True):
    """Leading-order GR periapsis advance per orbit [rad]: 6 pi M / p
    -+ 8 pi a sqrt(M) / p^(3/2) (upper sign prograde), p = 2 r_p r_a /
    (r_p + r_a)."""
    p = 2.0 * r_peri * r_apo / (r_peri + r_apo)
    s = 1.0 if prograde else -1.0
    return 6.0 * np.pi * M / p - s * 8.0 * np.pi * a * np.sqrt(M) / p ** 1.5
