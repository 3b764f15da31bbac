"""User-defined metrics: bring your own spacetime.

The counterpart of `light_path_tracer_tpu.models.custom`. Any stationary,
axisymmetric, asymptotically flat metric is fully specified, for the
reduced 5-D integrator, by its five nonzero covariant Boyer-Lindquist
components

    g_tt(r, theta), g_tphi(r, theta), g_rr(r, theta),
    g_thth(r, theta), g_phiphi(r, theta):

the hot loop needs only the two Killing symmetries (t, phi cyclic ->
conserved p_t, p_phi), not Carter separability. `CustomMetric` wraps a
user callable returning those five components, written with torch, and
derives the rest:

  * the contravariant components by exact 2x2 (t, phi)-block inversion
    (`_inv_terms`);
  * the geodesic RHS by autograd of the Hamiltonian H = (1/2)
    g^{mu nu} p_mu p_nu (`Kerr.rhs5_autodiff`, the oracle of the
    hand-derived Kerr forms);
  * the escape heading through the user metric's own contravariant
    components (`extract_angle`);
  * a capture surface from a host-side signature scan (the outermost
    radius where the metric stops being a Lorentzian exterior);
  * the critical angle by bisection on traced outcomes
    (models/numeric.py), once per instance, radius, inclination and
    device.

The camera screen is Kerr's Bardeen mapping at the observer with the
declared (M, a), so the metric must approach Kerr(M, a) far from the
hole; the momentum is then made exactly null through the user metric.

No CUDA kernel computes a user callable (`supports_kernel = False`):
`trace_batch` and the critical-angle bisection trace it on the plain
PyTorch loop on the rays' device, the card included, as the JAX package
traces it on XLA; the kernel wrappers refuse its class. The disk,
volumetric, stellar-surface and sequence modes keep the closed-form
families and reject it (cli/_shared.py `_reject_metric_py`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Callable

import numpy as np
import torch

from light_path_tracer_tpu_torch.models.kerr import (Kerr, _SIN2_FLOOR,
                                                     _scalar)


def kerr_covariant(M: float, a: float) -> Callable:
    """Kerr's covariant components in Boyer-Lindquist: the closure
    identity, CustomMetric(kerr_covariant(M, a)) traces like Kerr(M, a)."""
    def fn(r, th):
        sin2 = torch.clamp(torch.sin(th) ** 2, min=_SIN2_FLOOR)
        cos_th = torch.cos(th)
        Sigma = r * r + a * a * cos_th * cos_th
        Delta = r * r - 2.0 * M * r + a * a
        two_Mr = 2.0 * M * r
        g_tt = -(1.0 - two_Mr / Sigma)
        g_tphi = -a * two_Mr * sin2 / Sigma
        g_rr = Sigma / Delta
        g_thth = Sigma
        g_phiphi = (r * r + a * a
                    + a * a * two_Mr * sin2 / Sigma) * sin2
        return g_tt, g_tphi, g_rr, g_thth, g_phiphi
    return fn


def reissner_nordstrom_covariant(M: float, Q: float) -> Callable:
    """Static charged hole ds^2 = -f dt^2 + dr^2/f + r^2 dOmega^2 with
    f = 1 - 2M/r + Q^2/r^2: a diagonal-form oracle against the
    Reissner-Nordstrom orbit-equation family."""
    def fn(r, th):
        sin2 = torch.clamp(torch.sin(th) ** 2, min=_SIN2_FLOOR)
        f = 1.0 - 2.0 * M / r + (Q * Q) / (r * r)
        zero = torch.zeros_like(r * th)
        return (-f + zero, zero, 1.0 / f + zero,
                r * r + zero, r * r * sin2)
    return fn


def load_covariant_fn(spec: str) -> Callable:
    """Load a user covariant-components function from "FILE.py:ATTR":
    a callable (r, th) -> (g_tt, g_tphi, g_rr, g_thth, g_phiphi) written
    with torch. This imports and executes the named file, as `python
    FILE.py` would."""
    fn = _load_attr(spec)
    if not callable(fn):
        raise TypeError(f"{spec}: {attr_of(spec)} is not callable")
    return fn


def attr_of(spec: str) -> str:
    return spec.rsplit(":", 1)[1] if ":" in spec else spec


def _load_attr(spec: str):
    if ":" not in spec:
        raise ValueError(
            f"--metric-py expects FILE.py:ATTR, got {spec!r}")
    path, attr = spec.rsplit(":", 1)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = "_lpt_torch_user_metric_" + os.path.basename(path).replace(
        ".", "_")
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return getattr(module, attr)


def load_user_metric(spec: str, M: float = 1.0,
                     a: float = 0.0) -> "CustomMetric":
    """Load a user metric from "FILE.py:ATTR": a covariant-components
    callable (wrapped in CustomMetric with the given M, a) or a ready
    CustomMetric instance (returned as it is: its own M, a, capture and
    captured_fn win; the form for metrics that need more than the five
    components). Executes the file, as load_covariant_fn does."""
    obj = _load_attr(spec)
    if isinstance(obj, CustomMetric):
        return obj
    if not callable(obj):
        raise TypeError(
            f"{spec}: {attr_of(spec)} is neither a covariant-"
            f"components callable nor a CustomMetric instance")
    return CustomMetric(M=M, a=a, covariant_fn=obj, label=spec)


@dataclasses.dataclass(frozen=True)
class CustomMetric(Kerr):
    """A stationary axisymmetric metric from user covariant components.

    M, a: the asymptotic mass and spin the far field approaches; they
    calibrate the camera screen and the conserved-quantity seeds, the
    traced physics comes from `covariant_fn` alone (a = 0 for static
    metrics). covariant_fn: (r, th) -> (g_tt, g_tphi, g_rr, g_thth,
    g_phiphi), batched torch over same-shape tensors, finite and
    Lorentzian on the exterior. label: display name.
    capture_radius_override: an explicit capture radius for horizonless
    objects. captured_fn: (r, th) -> bool tensor, an end-of-trace capture
    predicate for trapped regions that are not a centred sphere (the
    loop's early exit stays the capture sphere: such rays run to their
    step budget). alpha_crit_override: a fixed critical angle (radians)
    for multi-centre metrics, where the bisection means nothing; it feeds
    statistics and palettes only.
    """

    covariant_fn: Callable = None
    label: str = "custom"
    capture_radius_override: float | None = None
    captured_fn: Callable | None = None
    alpha_crit_override: float | None = None

    #: No CUDA kernel computes a user callable: trace_batch traces this
    #: family on the plain loop on every device.
    supports_kernel: bool = dataclasses.field(
        default=False, init=False, repr=False)

    def __post_init__(self):
        super().__post_init__()
        if self.covariant_fn is None:
            raise ValueError(
                "CustomMetric requires covariant_fn=(r, th) -> "
                "(g_tt, g_tphi, g_rr, g_thth, g_phiphi)")
        if self.capture_radius_override is not None:
            r_cap = float(self.capture_radius_override)
            if r_cap <= 0.0:
                raise ValueError("capture_radius_override must be > 0")
        else:
            r_cap = max(1.01 * self.r_plus,
                        1.02 * self._signature_barrier())
        object.__setattr__(self, "_r_capture", r_cap)
        object.__setattr__(self, "_alpha_crit", {})

    def _signature_barrier(self) -> float:
        """Outermost radius where the user metric stops being a
        Lorentzian exterior (det of the (t, phi) block >= 0, g_rr <= 0,
        g_thth <= 0 or a non-finite component), from a host-side float64
        scan; the capture surface parks rays 2% outside it."""
        r = np.linspace(1e-3, max(4.0 * self.r_plus + 4.0,
                                  12.0 * self.M), 4001)
        th = np.linspace(1e-3, np.pi - 1e-3, 61)[:, None]
        out = self.covariant_fn(torch.as_tensor(r[None, :], dtype=torch.float64),
                                torch.as_tensor(th, dtype=torch.float64))
        g_tt, g_tphi, g_rr, g_thth, g_phiphi = (
            np.asarray(torch.as_tensor(c, dtype=torch.float64), np.float64)
            for c in out)
        det_tphi = g_tt * g_phiphi - g_tphi * g_tphi
        finite = (np.isfinite(g_tt) & np.isfinite(g_tphi)
                  & np.isfinite(g_rr) & np.isfinite(g_thth)
                  & np.isfinite(g_phiphi))
        bad = (~finite) | (g_rr <= 0.0) | (g_thth <= 0.0) \
            | (det_tphi >= 0.0)
        bad_any = np.broadcast_to(bad, (th.shape[0], r.shape[0])) \
            .any(axis=0)
        return float(r[bad_any.nonzero()[0].max()]) \
            if bad_any.any() else 0.0

    def capture_radius(self):
        return self._r_capture

    def reclass_radius(self):
        return self._r_capture * 1.1

    def _freeze_radius(self):
        # Just inside the capture surface: RK stages probing below it
        # stay on finite components.
        return 0.995 * self._r_capture

    def _inv_terms(self, r, th, M=None, a=None):
        """Exact contravariant components from the user's covariant ones:
        the (t, phi) block inverts as a 2x2 (g^tt = g_phiphi/D,
        g^tphi = -g_tphi/D, g^phiphi = g_tt/D with D = g_tt g_phiphi -
        g_tphi^2, |D| < 1e-30 replaced by 1e-30); r and theta are
        diagonal. M and a (the Kerr hook's arguments) are not read."""
        g_tt, g_tphi, g_rr, g_thth, g_phiphi = self.covariant_fn(r, th)
        D = g_tt * g_phiphi - g_tphi * g_tphi
        D_safe = torch.where(torch.abs(D) < 1e-30,
                             torch.full_like(D, 1e-30), D)
        return (g_phiphi / D_safe, -g_tphi / D_safe, 1.0 / g_rr,
                1.0 / g_thth, g_tt / D_safe)

    def rhs5(self, state5, p_t, p_phi):
        """The autograd Hamiltonian RHS over this class's `_inv_terms`:
        a user metric has no hand form."""
        return self.rhs5_autodiff(state5, p_t, p_phi)

    def rhs5_mu(self, state5, p_t, p_phi):
        raise NotImplementedError(
            "the mu = cos(theta) chart is wired for the hand-derived "
            "Kerr/Kerr-Newman RHS only; custom metrics integrate in "
            "theta form")

    def plunge_radii(self, r_obs, alphas, thetas, theta_obs):
        """The certain-plunge exit is off (radius 0 on every ray): its
        photon-orbit band argument needs Carter separability."""
        return torch.zeros_like(alphas)

    def extract_angle(self, state5, p_t, p_phi, captured):
        """Escape heading through the user metric: dr/dl = g^rr p_r,
        dth/dl = g^thth p_th, dphi/dl = g^tphi p_t + g^phiphi p_phi
        (Kerr's extraction is this with the components substituted by
        hand); Kerr's status and guard semantics, with captured_fn
        booking finite states as captured."""
        r_f, th_f, phi_f, p_r_f, p_th_f = state5
        M = _scalar(self.M, r_f)
        n_half = torch.floor(torch.abs(phi_f) / np.pi).to(torch.int32)
        is_captured = captured | (r_f <= self.reclass_radius())
        bad_state = ~(torch.isfinite(r_f) & torch.isfinite(th_f)
                      & torch.isfinite(phi_f))
        if self.captured_fn is not None:
            # A NaN coordinate stays INVALID, not captured.
            one = torch.ones_like(r_f)
            r_q = torch.where(bad_state, one, r_f)
            th_q = torch.where(bad_state, one, th_f)
            is_captured = is_captured | (~bad_state
                                         & self.captured_fn(r_q, th_q))

        sin_th = torch.sin(th_f)
        cos_th = torch.cos(th_f)
        r_s = torch.where(bad_state | is_captured, 10.0 * M + 10.0, r_f)
        g_tt_i, g_tphi_i, g_rr_i, g_thth_i, g_phiphi_i = self._inv_terms(
            r_s, th_f)
        dr_dl = g_rr_i * p_r_f
        dth_dl = g_thth_i * p_th_f
        dphi_dl = g_tphi_i * p_t + g_phiphi_i * p_phi

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

        invalid = bad_state | bad_v
        status = torch.where(
            is_captured, -1, torch.where(invalid, 0, 1)).to(torch.int32)
        final_alpha = torch.where(is_captured | invalid | tiny_v,
                                  torch.full_like(final_alpha, np.nan),
                                  final_alpha)
        n_half = torch.where(bad_state & ~is_captured,
                             torch.zeros_like(n_half), n_half)
        return status, final_alpha, n_half

    def alpha_crit(self, r_obs, theta_obs=None, n_azimuth: int = 16,
                   iters: int = 26, max_steps: int = 60000,
                   device=None) -> float:
        """Critical angle by bisection on traced outcomes on the plain
        loop on `device` (None: the card), kept for the instance's next
        call with the same arguments; alpha_crit_override short-circuits
        it."""
        if self.alpha_crit_override is not None:
            return float(self.alpha_crit_override)
        from light_path_tracer_tpu_torch.models.numeric import (
            alpha_crit_traced)
        dev = torch.device("cuda" if device is None else device)
        key = (float(r_obs), None if theta_obs is None else float(theta_obs),
               n_azimuth, iters, max_steps, str(dev))
        if key not in self._alpha_crit:
            self._alpha_crit[key] = alpha_crit_traced(
                self, r_obs, theta_obs, n_azimuth=n_azimuth, iters=iters,
                max_steps=max_steps, device=dev)
        return self._alpha_crit[key]
