"""Thin accretion-disk rendering with gravitational redshift and Doppler
beaming (BASELINE.json config 4).

The counterpart of `light_path_tracer_tpu.disk`: the still render
(`render_disk`), the photon-ring decomposition (`render_disk_decomposed`),
the hot-spot and textured-disk frames of one trace (`render_disk_frames`
with `HotSpot`, `hotspot_pattern`, `texture_pattern`), the jittered-AA
render (`render_disk_aa`), the composite of the lensed background and
the disk (`render_scene_with_disk`, `render_scene_with_disk_aa`) and
several planes in one trace (`render_multi_disk`).
Model: a geometrically thin disk of Keplerian circular orbits between
r_in (default r_isco) and r_out, in the equatorial plane or tilted
(`DiskConfig.tilt`, `tilt_azimuth`) or warped (`warp_radius`),
power-law emissivity eps(r) ~ r^-q or a Shakura-Sunyaev blackbody. The
trace records each ray's first max_hits in-disk crossings; each
contributes

    I_obs = g^p eps(r_c),   g = E_obs / E_em = 1 / (u^t (1 - Omega xi)),

with Omega the Keplerian angular velocity, u^t from the circular-orbit
normalisation and xi = L/E the ray's conserved azimuthal impact
parameter, so the redshift needs only the crossing radius and the ray's
conserved momenta.

The spacetime is Kerr, or Kerr-Newman when the scene is charged (a = 0
included); the ISCO, the Keplerian Omega and the emitter redshift take
the charge. The trace runs on the tensors' device: the hand-written CUDA
kernel's disk variant on a CUDA device (through the two-pass driver by
default), its plain PyTorch loop on the CPU. The emission and the tone
map are plain PyTorch on the same device. The ISCO is host NumPy. A
tilted, warped or second plane and the crossing-time recorder
(record_time) run the kernel's plane-recorder instances on the card. A
boosted camera aberrates the grids and multiplies each crossing's shift
by the pixel's Doppler factor. The multi-host render is not ported
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.models import Kerr, KerrNewman
from light_path_tracer_tpu_torch.ops.batch import _backend
from light_path_tracer_tpu_torch.ops.kerr_trace import CAPTURED, WarpedBasis
from light_path_tracer_tpu_torch.ops.types import DiskTraceResult
from light_path_tracer_tpu_torch.pipeline import _dtype_of, _source_tensor
from light_path_tracer_tpu_torch.render import render_lensed_image
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

__all__ = ["DiskConfig", "DiskTraceResult", "HotSpot", "r_isco",
           "disk_temperature", "keplerian_omega", "keplerian_redshift",
           "covariant_tphi_components", "hotspot_pattern",
           "texture_pattern", "disk_basis", "warped_basis",
           "trace_disk_rays", "trace_disk_rays_multi", "disk_emission",
           "decomposed_display", "composite_gamma_encode", "render_disk",
           "render_disk_decomposed", "render_disk_frames",
           "render_disk_aa", "render_multi_disk", "render_scene_with_disk",
           "render_scene_with_disk_aa"]


@dataclasses.dataclass(frozen=True)
class DiskConfig:
    """The JAX package's DiskConfig, field for field."""

    r_out: float = 20.0            # outer edge in units of M
    r_in: float | None = None      # None -> r_isco
    emissivity_index: float = 3.0  # eps(r) ~ r^-q (powerlaw spectrum)
    g_power: float = 3.0           # I_obs = g^p * eps (powerlaw spectrum)
    opaque: bool = True            # first crossing blocks deeper images
    prograde: bool = True          # orbit sense vs the BH spin
    # Tilted disk: the plane's inclination from the equator and the
    # azimuth of its line of nodes [rad]. The crossing geometry is exact;
    # the emitter keeps the equatorial Keplerian formulas at the crossing
    # radius with the ray's angular momentum about the normal (exact for
    # a = 0). warp_radius: a Bardeen-Petterson warp, the tilt growing as
    # tilt / (1 + (warp_radius / r)^4) (None: a flat plane).
    tilt: float = 0.0
    tilt_azimuth: float = 0.0
    warp_radius: float | None = None
    max_hits: int = 2
    tone_map: str = "asinh"        # "asinh" | "linear" | "sqrt"
    # "powerlaw": grayscale g^p r^-q; "blackbody": T_obs = g T_em with a
    # Shakura-Sunyaev profile, intensity ~ T_obs^4, utils/color.py colour.
    spectrum: str = "powerlaw"
    t_peak: float = 9000.0         # blackbody: peak disk temperature [K]


def disk_basis(tilt: float, tilt_azimuth: float):
    """(normal, e1, e2) of the disk plane as Python floats: the columns of
    R_z(tilt_azimuth) R_x(tilt) acting on (z, x, y). tilt = 0 gives n = z,
    e1 = x, e2 = y, so the in-plane azimuth is the chart's."""
    si, ci = np.sin(tilt), np.cos(tilt)
    sl, cl = np.sin(tilt_azimuth), np.cos(tilt_azimuth)
    n = (si * sl, -si * cl, ci)
    e1 = (cl, sl, 0.0)
    e2 = (-sl * ci, cl * ci, si)
    return (tuple(map(float, n)), tuple(map(float, e1)),
            tuple(map(float, e2)))


def warped_basis(tilt: float, tilt_azimuth: float, warp_radius: float,
                 power: float = 4.0):
    """The radius-dependent basis of a Bardeen-Petterson warp, iota(r) =
    tilt / (1 + (warp_radius / r)^power) in disk_basis's convention: a
    callable r -> ((n), (e1), (e2)) of tensors (ops.kerr_trace.WarpedBasis,
    whose numbers the CUDA kernel reads)."""
    return WarpedBasis(tilt, tilt_azimuth, warp_radius, power)


def _plane_of(disk: DiskConfig, metric) -> tuple:
    """(r_in, r_out, theta_plane, opaque) of a disk's recorder."""
    return (_r_in_of(disk, metric.M, metric.a, getattr(metric, "Q", 0.0)),
            float(disk.r_out), float(np.pi / 2), bool(disk.opaque))


def _normal_of(disk: DiskConfig):
    """The recorder's basis of a disk: warped, flat tilted or None."""
    if disk.warp_radius is not None:
        return warped_basis(disk.tilt, disk.tilt_azimuth, disk.warp_radius)
    if disk.tilt != 0.0:
        return disk_basis(disk.tilt, disk.tilt_azimuth)
    return None


def _scene_metric(scene: SceneConfig):
    """Kerr, or Kerr-Newman when the scene is charged, for the disk and
    volumetric renders. A charged scene at a = 0 is Kerr-Newman too: the
    crossing recorder lives in the 5-D trace, which the orbit-equation
    Reissner-Nordstrom class does not carry (same geodesics). A deformed
    scene raises the JAX package's ValueError (the orbital dynamics are
    Kerr/charged closed forms)."""
    if scene.eps3:
        raise ValueError("this path is not wired for Johannsen-Psaltis "
                         "(eps3 != 0): disk orbital dynamics (ISCO, "
                         "Omega, redshift) are Kerr/charged closed "
                         "forms and sequences trace (Traced)Kerr. "
                         "Deformed metrics support shadow/lens/"
                         "magnification/AA/trajectory surfaces.")
    if scene.Q:
        return KerrNewman(M=scene.M, a=scene.a, Q=scene.Q)
    return Kerr(M=scene.M, a=scene.a)


def _circular_orbit_energy(M, a, Q, r, prograde):
    """Specific energy E of an equatorial circular geodesic at radius r
    (host NumPy). E(r) has its minimum exactly at the ISCO."""
    x2 = M * r - Q * Q
    x = np.sqrt(np.maximum(x2, 0.0))
    s = 1.0 if prograde else -1.0
    omega = s * x / (r * r + s * a * x)
    w = (2.0 * M * r - Q * Q) / (r * r)
    g_tt = -(1.0 - w)
    g_tphi = -a * w
    g_phiphi = r * r + a * a + a * a * w
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    bad = (norm <= 1e-12) | (x2 <= 0.0)
    e = -(g_tt + omega * g_tphi) / np.sqrt(np.where(bad, 1.0, norm))
    return np.where(bad, np.inf, e)


def r_isco(M: float, a: float, prograde: bool = True,
           Q: float = 0.0) -> float:
    """Innermost stable circular orbit radius (host NumPy).

    Q = 0: the Bardeen-Press-Teukolsky closed form. Q != 0: the minimum
    of the circular-orbit energy E(r), bracketed on a grid and refined by
    ternary search (dE/dr = 0 is the marginal-stability condition).
    """
    if Q:
        r_plus = M + np.sqrt(max(M * M - a * a - Q * Q, 0.0))
        rs = np.linspace(1.005 * r_plus, 12.0 * M, 8001)
        e = _circular_orbit_energy(M, a, Q, rs, prograde)
        i = int(np.argmin(e))
        lo = rs[max(i - 1, 0)]
        hi = rs[min(i + 1, len(rs) - 1)]
        for _ in range(200):
            m1 = lo + (hi - lo) / 3.0
            m2 = hi - (hi - lo) / 3.0
            e1 = _circular_orbit_energy(M, a, Q, np.asarray(m1), prograde)
            e2 = _circular_orbit_energy(M, a, Q, np.asarray(m2), prograde)
            if e1 < e2:
                hi = m2
            else:
                lo = m1
        return float(0.5 * (lo + hi))
    chi = a / M
    z1 = 1.0 + (1.0 - chi**2) ** (1.0 / 3.0) * (
        (1.0 + chi) ** (1.0 / 3.0) + (1.0 - chi) ** (1.0 / 3.0))
    z2 = np.sqrt(3.0 * chi**2 + z1**2)
    sign = -1.0 if prograde else 1.0
    return float(M * (3.0 + z2 + sign * np.sqrt(
        (3.0 - z1) * (3.0 + z1 + 2.0 * z2))))


def disk_temperature(r_c, r_in, t_peak):
    """Shakura-Sunyaev thin-disk effective temperature, batched:
    T ~ [(1 - sqrt(r_in / r)) / r^3]^(1/4) (zero-torque inner edge),
    normalised so its maximum, at r = (49/36) r_in, is t_peak."""
    x = r_in / torch.clamp(r_c, min=r_in)
    f = x ** 3 * (1.0 - torch.sqrt(x))
    f_max = (36.0 / 49.0) ** 3 * (1.0 - 6.0 / 7.0)
    return t_peak * (torch.clamp(f, min=0.0) / f_max) ** 0.25


def keplerian_redshift(M, a, r_c, xi, prograde: bool = True,
                       Q: float = 0.0):
    """g = 1 / (u^t (1 - Omega xi)) of a Keplerian circular emitter,
    batched over crossing radii r_c and per-ray xi = L/E.

    Omega = +-sqrt(M) / (r^1.5 +- a sqrt(M)) (upper signs prograde);
    with charge, +-x / (r^2 +- a x), x = sqrt(M r - Q^2), and the
    equatorial covariant components gain (2Mr - Q^2)/r^2.
    """
    omega = keplerian_omega(M, a, r_c, prograde, Q=Q)
    if Q:
        w = (2.0 * M * r_c - Q * Q) / (r_c * r_c)
        g_tt = -(1.0 - w)
        g_tphi = -a * w
        g_phiphi = r_c * r_c + a * a + a * a * w
    else:
        g_tt = -(1.0 - 2.0 * M / r_c)
        g_tphi = -2.0 * M * a / r_c
        g_phiphi = r_c * r_c + a * a + 2.0 * M * a * a / r_c
    norm = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phiphi)
    u_t = 1.0 / torch.sqrt(torch.clamp(norm, min=1e-12))
    g = 1.0 / (u_t * (1.0 - omega * xi))
    return torch.clamp(g, min=0.0)


def covariant_tphi_components(metric, r, c):
    """Covariant Boyer-Lindquist (g_tt, g_tphi, g_phiphi) off the
    equatorial plane at (r, cos theta = c), batched over tensors r, c:
    the t-phi block of a circular emitter's redshift (volumetric flows),
    read through the metric's charge hook: W = 2 M r for Kerr,
    2 M r - Q^2 for Kerr-Newman."""
    M, a = float(metric.M), float(metric.a)
    s2 = torch.clamp(1.0 - c * c, min=1e-12)
    Sigma = r * r + a * a * c * c
    W = metric._two_M_r(r, M)
    ra2 = r * r + a * a
    g_tt = -(1.0 - W / Sigma)
    g_tph = -a * W * s2 / Sigma
    g_pp = (ra2 + a * a * W * s2 / Sigma) * s2
    return g_tt, g_tph, g_pp


def keplerian_omega(M, a, r, prograde: bool = True, Q: float = 0.0):
    """Keplerian angular velocity +-sqrt(M) / (r^1.5 +- a sqrt(M));
    charged: +-x / (r^2 +- a x), x = sqrt(M r - Q^2). r is a tensor or a
    Python float (then the result is a float)."""
    if isinstance(r, torch.Tensor):
        sqrt, clamp = torch.sqrt, torch.clamp
    else:
        r = float(r)

        def sqrt(x):
            return math.sqrt(x)

        def clamp(x, min):
            return max(x, min)
    if Q:
        x = sqrt(clamp(M * r - Q * Q, min=0.0))
        s = 1.0 if prograde else -1.0
        return s * x / (r * r + s * a * x)
    sqrt_m = math.sqrt(M)
    if prograde:
        return sqrt_m / (r ** 1.5 + a * sqrt_m)
    return -sqrt_m / (r ** 1.5 - a * sqrt_m)


@dataclasses.dataclass(frozen=True)
class HotSpot:
    """Orbiting Gaussian brightness feature on the disk surface (the JAX
    package's HotSpot, field for field)."""

    r0: float = 6.0         # orbit radius [M]
    phi0: float = 0.0       # azimuth at t = 0 [rad]
    sigma_r: float = 0.6    # radial Gaussian width [M]
    sigma_phi: float = 0.5  # azimuthal Gaussian width [rad]
    amplitude: float = 6.0  # peak emission multiplier - 1

    @property
    def period(self):
        """Coordinate-time orbital period at r0 for M = 1, a = 0 (other
        scenes scale by their own keplerian_omega)."""
        return 2.0 * np.pi / keplerian_omega(1.0, 0.0, self.r0)


def hotspot_pattern(spot: HotSpot, M, a, prograde: bool = True,
                    Q: float = 0.0):
    """Emission multiplier pattern(r, phi, t) of an orbiting Gaussian hot
    spot: a rigid blob at radius spot.r0 and azimuth spot.phi0 + Omega_K
    (spot.r0) t (coordinate time t in M, a tensor in the trace dtype or a
    Python number). The azimuth offset wraps to [-pi, pi) with floor
    semantics (torch.remainder, as jnp's %). The crossing azimuth is
    recorded at trace time, so frames at any t re-render one trace."""
    omega = float(keplerian_omega(M, a, spot.r0, prograde, Q=Q))

    def pattern(r, phi, t):
        dphi = phi - (spot.phi0 + omega * t)
        dphi = torch.remainder(dphi + np.pi, 2.0 * np.pi) - np.pi
        dr = r - spot.r0
        blob = torch.exp(-0.5 * ((dr / spot.sigma_r) ** 2
                                 + (dphi / spot.sigma_phi) ** 2))
        return 1.0 + spot.amplitude * blob

    return pattern


def texture_pattern(tex, r_in, r_out, M, a, shear: bool = True,
                    Q: float = 0.0, prograde: bool = True):
    """Emission multiplier pattern(r, phi, t) from an (Nr, Nphi) texture
    covering r in [r_in, r_out] (rows, linear) x phi in [0, 2 pi)
    (columns, periodic), sampled bilinearly. shear=True advects each
    annulus at its own Keplerian rate (a straight stripe winds into a
    trailing spiral); shear=False rotates it rigidly at Omega(r_in). The
    texture is float32 and is read on the rays' device."""
    tex = torch.as_tensor(np.asarray(tex, np.float32))
    n_r, n_phi = tex.shape
    omega_ref = float(keplerian_omega(M, a, r_in, prograde, Q=Q))
    two_pi = 2.0 * np.pi
    on_device = {}

    def pattern(r, phi, t):
        if r.device not in on_device:
            on_device[r.device] = tex.to(r.device)
        dev_tex = on_device[r.device]
        omega = (keplerian_omega(M, a, torch.clamp(r, min=r_in), prograde,
                                 Q=Q)
                 if shear else omega_ref)
        phi_m = torch.remainder(phi - omega * t, two_pi)
        pr = torch.clamp((r - r_in) / max(r_out - r_in, 1e-9), 0.0,
                         1.0) * (n_r - 1)
        pp = phi_m / two_pi * n_phi
        i0 = torch.clamp(pr.to(torch.int32), 0, n_r - 2).long()
        j0 = torch.remainder(pp.to(torch.int32), n_phi).long()
        j1 = torch.remainder(j0 + 1, n_phi)
        fr = pr - i0.to(pr.dtype)
        fp = pp - torch.floor(pp)
        v00 = dev_tex[i0, j0]
        v01 = dev_tex[i0, j1]
        v10 = dev_tex[i0 + 1, j0]
        v11 = dev_tex[i0 + 1, j1]
        return ((1 - fr) * ((1 - fp) * v00 + fp * v01)
                + fr * ((1 - fp) * v10 + fp * v11))

    return pattern


def _r_in_of(disk: DiskConfig, M, a, Q=0.0) -> float:
    return float(disk.r_in if disk.r_in is not None
                 else r_isco(M, a, disk.prograde, Q=Q))


def trace_disk_rays(metric, r_obs, alphas, thetas, theta_obs,
                    lambda_max: float, max_steps: int, disk: DiskConfig,
                    backend: str = "auto", precision: str = "fast",
                    method: str = "dp45", two_pass="auto",
                    pass1_steps: int = 512,
                    record_momentum: bool = False,
                    record_time: bool = False) -> DiskTraceResult:
    """Trace rays recording the disk's crossings; returns DiskTraceResult.

    The tensors' device picks the path (backend must be 'auto'): the
    CUDA kernel's disk variant for a CUDA tensor (its plane-recorder
    instances for a tilted or warped disk or with record_time), its plain
    loop for a CPU tensor. two_pass: straggler containment ('auto' = on,
    as in the JAX package, whose disk workloads come from jittered grids
    whose near-axis rays grind thousands of steps); pass1_steps caps the
    first pass. record_time adds t_hits (the coordinate time of each
    crossing from the camera) and t_end (at capture, escape or an opaque
    stop).
    """
    if method not in ("dp45", "dop853"):
        raise ValueError(
            f"disk mode supports integrator 'dp45' or 'dop853' (the "
            f"crossing recorder lives in the adaptive loop), got "
            f"{method!r}")
    _backend(backend, alphas)
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_cuda, trace_disk_rays_two_pass)
    args = (metric, float(r_obs), alphas, thetas, float(theta_obs),
            float(lambda_max), max_steps, _plane_of(disk, metric),
            disk.max_hits)
    kw = dict(precision=precision, record_momentum=record_momentum,
              method=method, disk_normal=_normal_of(disk),
              record_time=record_time)
    if two_pass if two_pass != "auto" else True:
        return trace_disk_rays_two_pass(*args, pass1_steps=pass1_steps, **kw)
    return trace_disk_rays_cuda(*args, **kw)


def trace_disk_rays_multi(metric, r_obs, alphas, thetas, theta_obs,
                          lambda_max: float, max_steps: int, disks,
                          precision: str = "fast", method: str = "dp45",
                          two_pass="auto", pass1_steps: int = 512):
    """Trace rays recording the crossings of several independent disk
    planes in one integration; returns a tuple of DiskTraceResult, one a
    disk, sharing the ray's status, heading and steps. A ray parks at its
    first in-disk crossing of any opaque plane, so planes behind it are
    occluded; every plane records max(max_hits) slots. On a CUDA tensor
    the kernel's plane-recorder instances take one or two planes and its
    broad instances more; the plain loop takes any number too."""
    if method not in ("dp45", "dop853"):
        raise ValueError(
            f"disk mode supports integrator 'dp45' or 'dop853', got "
            f"{method!r}")
    disks = tuple(disks)
    _backend("auto", alphas)
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_multi_cuda, trace_disk_rays_two_pass)
    planes = [(_plane_of(d, metric), _normal_of(d)) for d in disks]
    args = (metric, float(r_obs), alphas, thetas, float(theta_obs),
            float(lambda_max), max_steps, planes)
    max_hits = max(d.max_hits for d in disks)
    if two_pass if two_pass != "auto" else True:
        res = trace_disk_rays_two_pass(
            *args[:-1], planes[0][0], max_hits, pass1_steps=pass1_steps,
            precision=precision, method=method, disk_normal=planes[0][1],
            extra_disks=tuple(planes[1:]))
        return res if len(planes) > 1 else (res,)
    return trace_disk_rays_multi_cuda(*args, max_hits, precision=precision,
                                      method=method)


def _pow4(x):
    """x^4 as (x^2)^2, the product jnp's integer power forms."""
    x2 = x * x
    return x2 * x2


def disk_emission(scene: SceneConfig, disk: DiskConfig, r_in,
                  n_hits, r_hits, xi, doppler=None,
                  pattern=None, phi_hits=None, t=0.0, xi_hits=(),
                  delay_hits=(), per_slot: bool = False, annulus=None):
    """Per-ray disk emission from the recorded crossings.

    Returns (intensity, rgb): intensity (N,) is the summed un-tone-mapped
    emission over the visible crossings (the first only, for an opaque
    disk); rgb (N, 3) the intensity-weighted linear-sRGB sum for the
    blackbody spectrum, None for the power-law one. pattern(r, phi, t)
    multiplies each crossing's emission (needs phi_hits), evaluated at
    t - delay_hits[slot] where delays are given; per_slot returns the
    unsummed (n_slots, N) contributions; annulus=(r_lo, r_hi) masks each
    crossing's radius. doppler: the per-ray Doppler factor of a moving
    camera (camera.doppler_lookup), which multiplies each crossing's
    shift. xi_hits (a tilted disk) replace xi slot by slot.
    """
    color = disk.spectrum == "blackbody"
    if color:
        from light_path_tracer_tpu_torch.utils.color import blackbody_rgb
    slot_i, slot_rgb = [], []
    n_slots = 1 if disk.opaque else disk.max_hits
    for slot in range(n_slots):
        hit = n_hits > slot
        if annulus is not None:
            hit = hit & ((r_hits[slot] >= annulus[0])
                         & (r_hits[slot] <= annulus[1]))
        r_c = torch.clamp(r_hits[slot], min=r_in)
        xi_slot = xi_hits[slot] if len(xi_hits) > slot else xi
        g = keplerian_redshift(scene.M, scene.a, r_c, xi_slot,
                               disk.prograde, Q=scene.Q)
        if doppler is not None:
            g = g * doppler
        t_slot = t - delay_hits[slot] if len(delay_hits) > slot else t
        mult = (pattern(r_c, phi_hits[slot], t_slot)
                if pattern is not None else 1.0)
        if color:
            t_obs = g * disk_temperature(r_c, r_in, disk.t_peak)
            w = torch.where(hit, mult * _pow4(t_obs / disk.t_peak), 0.0)
            slot_rgb.append(w[:, None] * blackbody_rgb(t_obs))
            slot_i.append(w)
        else:
            eps = (r_c / r_in) ** (-disk.emissivity_index)
            slot_i.append(torch.where(
                hit, mult * g ** disk.g_power * eps, 0.0))
    if per_slot:
        return (torch.stack(slot_i),
                torch.stack(slot_rgb) if color else None)
    intensity = sum(slot_i[1:], slot_i[0])
    rgb = sum(slot_rgb[1:], slot_rgb[0]) if color else None
    return intensity, rgb


def _tone_map(x, mode: str, peak=None):
    """Tone map normalised to this frame's own maximum, or to `peak`
    (sequences pass their common maximum so frames are comparable)."""
    peak = torch.clamp(torch.max(x) if peak is None else peak, min=1e-12)
    if mode == "asinh":
        return torch.asinh(10.0 * x / peak) / math.asinh(10.0)
    if mode == "sqrt":
        return torch.sqrt(x / peak)
    return x / peak


def decomposed_display(layers, tone_map: str = "asinh"):
    """Tone map of image-order layers (n, H, W) for display, every order
    scaled by the peak over all of them, so the subrings'
    demagnification stays visible. Returns float32 in [0, 1]."""
    peak = torch.max(layers)
    return torch.stack([_tone_map(layer, tone_map, peak=peak)
                        for layer in layers]).to(torch.float32)


def _finish_image(intensity, rgb, resolution, tone_map: str):
    """Emission -> image: tone-map the luminance, keep the blackbody
    chromaticity (rgb is None for the power-law spectrum)."""
    resolution = tuple(resolution)
    if rgb is not None:
        lum = _tone_map(intensity, tone_map)
        chroma = rgb / torch.clamp(intensity, min=1e-12)[:, None]
        return (chroma * lum[:, None]).reshape(
            resolution + (3,)).to(torch.float32)
    return _tone_map(intensity, tone_map).reshape(resolution).to(
        torch.float32)


def render_disk(scene: SceneConfig, resolution,
                cfg: RenderConfig = RenderConfig(),
                disk: DiskConfig = DiskConfig(), device="cuda"):
    """Render the accretion-disk image; returns (image, stats).

    image: (H, W) float32 in [0, 1] (power-law) or (H, W, 3) linear sRGB
    (blackbody) on `device`. The observer inclination is scene.theta_obs
    (e.g. 80 degrees for the textbook bent disk). Stages build_lookup,
    precompute (the trace) and render (emission and tone map), each timed
    with the CUDA device synchronised at its end.
    """
    metric = _scene_metric(scene)
    timer = StageTimer(device)
    height, width = resolution

    with timer.stage("build_lookup"):
        _fov, alpha, theta = _grids(scene, cfg, resolution, device)

    with timer.stage("precompute"):
        res = _trace_grid(metric, scene, cfg, disk, alpha, theta)

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        intensity, rgb = disk_emission(
            scene, disk, r_in, res.n_hits, res.r_hits, res.xi,
            doppler=_doppler(scene, cfg, resolution, device),
            xi_hits=res.xi_hits)
        img = _finish_image(intensity, rgb, resolution, disk.tone_map)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        disk_pixels=int((res.n_hits > 0).sum()),
        timings=timer.finish(),
        **_common_stats(scene, disk, res, height * width))
    return img, stats


def _lambda_max(scene) -> float:
    return max(5000.0, 6.0 * scene.r_obs)


def _trace_grid(metric, scene, cfg, disk, alpha, theta, two_pass=None,
                record_momentum=False, record_time=False) -> DiskTraceResult:
    """The disk trace of the camera grids (alpha, theta), raveled."""
    return trace_disk_rays(
        metric, scene.r_obs, alpha.reshape(-1), theta.reshape(-1),
        scene.theta_obs, _lambda_max(scene), cfg.max_steps, disk,
        backend=cfg.backend, precision=cfg.precision, method=cfg.integrator,
        two_pass=cfg.two_pass if two_pass is None else two_pass,
        pass1_steps=cfg.pass1_steps, record_momentum=record_momentum,
        record_time=record_time)


def _grids(scene, cfg, resolution, device, pixel_offset=(0.0, 0.0)):
    """(fov, alpha, theta) of the scene's camera at `resolution` (a boost
    aberrates them)."""
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    grid = dict(psi=scene.psi, dtype=_dtype_of(cfg), device=device,
                pixel_offset=tuple(pixel_offset), boost=scene.boost)
    return (fov, camera.build_alpha_lookup(resolution, fov, **grid),
            camera.build_theta_lookup(resolution, fov, **grid))


def _doppler(scene, cfg, resolution, device, offsets=((0.0, 0.0),)):
    """The moving camera's per-ray Doppler factors of the passes at
    `offsets`, raveled in the trace's order; None for a static camera.
    The factor multiplies the disk's shift only: the lensed background
    of a composite is display-referred and takes the aberration alone."""
    if not scene.boosted:
        return None
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    return torch.cat([camera.doppler_lookup(
        resolution, fov, scene.boost, dtype=_dtype_of(cfg),
        pixel_offset=tuple(off), device=device).reshape(-1)
        for off in offsets])


def _common_stats(scene, disk, res, rays):
    return dict(r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
                captured=int((res.status == CAPTURED).sum()),
                integrator_steps=int(res.n_steps), total_rays=rays,
                traced_rays=rays)


def render_disk_decomposed(scene: SceneConfig, resolution,
                           cfg: RenderConfig = RenderConfig(),
                           disk: DiskConfig = DiskConfig(),
                           n_orders: int = 3, device="cuda"):
    """Photon-ring decomposition: the disk image split by image order.

    One trace records each ray's first n_orders equatorial crossings
    anywhere on the plane (a translucent recorder with r_in = 0 and r_out
    at the escape radius), so slot k is image order k; order k's layer is
    the emission of that crossing where it lands in [r_in, r_out]. The
    layers sum to the translucent render_disk intensity. On a CUDA
    device n_orders 5 to 8 trace through the kernel's wide instances,
    more through its plane recorder as one equatorial plane.

    Returns (layers, stats): layers (n_orders, H, W) linear intensity, or
    (n_orders, H, W, 3) linear sRGB for the blackbody spectrum, float32 on
    `device`; stats adds to render_disk's flux_per_order, flux_ratios,
    gamma_estimates (-ln ratio), mean_radius_rad and pixels_per_order,
    summed in float64 on the host as the JAX package sums them.
    """
    metric = _scene_metric(scene)
    rec = dataclasses.replace(disk, opaque=False, max_hits=n_orders,
                              r_in=0.0, r_out=2.0 * scene.r_obs)
    timer = StageTimer(device)
    height, width = resolution

    with timer.stage("build_lookup"):
        _fov, alpha, theta = _grids(scene, cfg, resolution, device)

    with timer.stage("precompute"):
        res = _trace_grid(metric, scene, cfg, rec, alpha, theta)

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        slot_i, slot_rgb = disk_emission(
            scene, rec, r_in, res.n_hits, res.r_hits, res.xi,
            doppler=_doppler(scene, cfg, resolution, device),
            xi_hits=res.xi_hits, per_slot=True, annulus=(r_in, disk.r_out))
        shape = (n_orders,) + tuple(resolution)
        layers = (slot_i.reshape(shape) if slot_rgb is None
                  else slot_rgb.reshape(shape + (3,))).to(torch.float32)

    slot_np = slot_i.detach().cpu().numpy().astype(np.float64)
    flux = slot_np.sum(axis=1)
    alpha_flat = alpha.detach().cpu().numpy().astype(np.float64).ravel()
    mean_radius = (slot_np @ alpha_flat) / np.maximum(flux, 1e-300)
    ratios = flux[1:] / np.maximum(flux[:-1], 1e-300)
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        disk_pixels=int((slot_np.sum(axis=0) > 0.0).sum()),
        pixels_per_order=[int((slot_np[k] > 0.0).sum())
                          for k in range(n_orders)],
        flux_per_order=flux.tolist(),
        flux_ratios=ratios.tolist(),
        gamma_estimates=(-np.log(np.maximum(ratios, 1e-300))).tolist(),
        mean_radius_rad=mean_radius.tolist(),
        timings=timer.finish(),
        **_common_stats(scene, disk, res, height * width))
    return layers, stats


def render_disk_frames(scene: SceneConfig, resolution, times,
                       cfg: RenderConfig = RenderConfig(),
                       disk: DiskConfig = DiskConfig(),
                       spot: HotSpot = HotSpot(), pattern=None,
                       device="cuda"):
    """Hot-spot or textured-disk frames from one trace.

    The trace records each crossing's (r, phi); a frame at coordinate
    time t re-evaluates the pattern (hotspot_pattern(spot) by default, or
    any pattern(r, phi, t) such as texture_pattern) at the advected
    azimuth, so the integration is paid once for the sequence. The times
    enter in the trace dtype; the frames share one tone-map peak, the
    largest emission of any frame.

    Returns (frames (T, H, W) or (T, H, W, 3) float32, stats); stats
    ["emission"] is the raw (T, H, W) float32 intensity. One orbit at
    spot.r0 is stats["orbit_period"] in M.
    """
    metric = _scene_metric(scene)
    timer = StageTimer(device)
    height, width = resolution
    times = list(times)
    dtype = _dtype_of(cfg)

    with timer.stage("build_lookup"):
        _fov, alpha, theta = _grids(scene, cfg, resolution, device)

    with timer.stage("precompute"):
        res = _trace_grid(metric, scene, cfg, disk, alpha, theta)

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        if pattern is None:
            pattern = hotspot_pattern(spot, scene.M, scene.a, disk.prograde,
                                      Q=scene.Q)
        ts = torch.tensor(times, dtype=dtype, device=device)
        color = disk.spectrum == "blackbody"
        dl = _doppler(scene, cfg, resolution, device)
        intensity, rgb = [], []
        for t in ts:
            i_t, rgb_t = disk_emission(scene, disk, r_in, res.n_hits,
                                       res.r_hits, res.xi, doppler=dl,
                                       pattern=pattern,
                                       phi_hits=res.phi_hits, t=t,
                                       xi_hits=res.xi_hits)
            intensity.append(i_t)
            rgb.append(rgb_t)
        shape = (len(times),) + tuple(resolution)
        intensity = torch.stack(intensity)              # (T, N)
        lum = _tone_map(intensity, disk.tone_map, torch.max(intensity))
        emission = intensity.reshape(shape).to(torch.float32)
        if color:
            chroma = torch.stack(rgb) / torch.clamp(intensity,
                                                    min=1e-12)[..., None]
            frames = (chroma * lum[..., None]).reshape(shape + (3,))
        else:
            frames = lum.reshape(shape)
        frames = frames.to(torch.float32)

    stats = dict(
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        disk_pixels=int((res.n_hits > 0).sum()),
        integrator_steps=int(res.n_steps),
        emission=emission,
        n_frames=len(times),
        orbit_period=abs(2.0 * np.pi / keplerian_omega(
            scene.M, scene.a, spot.r0, disk.prograde, Q=scene.Q)),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return frames, stats


def _disk_pixels(lum, intensity, rgb, resolution, grayscale: bool,
                 channels):
    """Tone-mapped disk layer shaped like the background image: the
    blackbody chromaticity carries the tone-mapped luminance (Rec. 601
    luma on a gray background, alpha channels padded with 1); power-law
    luminance is broadcast over the background's channels."""
    resolution = tuple(resolution)
    if rgb is not None:
        disk_px = rgb / torch.clamp(intensity, min=1e-12)[:, None] \
            * lum[:, None]
        if grayscale:
            luma = torch.tensor([0.299, 0.587, 0.114], dtype=disk_px.dtype,
                                device=disk_px.device)
            return (disk_px @ luma).reshape(resolution)
        if channels >= 3:
            pad = torch.ones((disk_px.shape[0], channels - 3),
                             dtype=disk_px.dtype, device=disk_px.device)
            disk_px = torch.cat([disk_px, pad], dim=1)
        else:
            disk_px = disk_px[:, :channels]
        return disk_px.reshape(resolution + (channels,))
    if grayscale:
        return lum.reshape(resolution)
    return lum.reshape(resolution)[..., None].expand(
        resolution + (channels,))


def _composite(background, disk_px, hit, opaque: bool):
    """The opaque disk replaces the background where a ray hit it; the
    translucent one adds to it and clips to [0, 1]. Returns float32."""
    hit_b = hit if background.dim() == 2 else hit[..., None]
    disk_px = disk_px.to(background.dtype)
    if opaque:
        out = torch.where(hit_b, disk_px, background)
    else:
        out = torch.clamp(background + disk_px, 0.0, 1.0)
    return out.to(torch.float32)


def _background(img, alpha, theta, res, rays, resolution, alpha_crit, fov,
                scene, cfg):
    """The lensed background of the rays `rays` (a slice) of a disk
    trace, from their final_alpha and half-orbit counts."""
    fa = res.final_alpha[rays].reshape(resolution).to(torch.float32)
    wind = torch.clamp(res.n_half[rays], 0, cfg.winding_max).to(
        torch.int32).reshape(resolution)
    return render_lensed_image(img, alpha, fa, wind, alpha_crit, fov,
                               cfg.render_loop_around, psi=scene.psi,
                               theta_lookup=theta, sampling=cfg.sampling)


def render_scene_with_disk(scene: SceneConfig, source_image,
                           cfg: RenderConfig = RenderConfig(),
                           disk: DiskConfig = DiskConfig(),
                           disk_gain: float = 1.0,
                           pixel_offset=(0.0, 0.0), device="cuda"):
    """Composite render: the lensed background image and the accretion
    disk from one trace a pixel (the disk trace's final heading drives the
    background gather). An opaque disk replaces the background where a
    ray met it; a translucent one adds its emission and clips. disk_gain
    scales the tone-mapped disk against the [0, 1] background. Returns
    (image float32 in the source's shape on `device`, stats); stats
    ["disk_mask"] is the (H, W) NumPy mask of disk pixels."""
    metric = _scene_metric(scene)
    timer = StageTimer(device)
    height, width = np.shape(source_image)[:2]
    resolution = (height, width)

    with timer.stage("load_image"):
        img = _source_tensor(source_image, device)

    with timer.stage("build_lookup"):
        fov, alpha, theta = _grids(scene, cfg, resolution, device,
                                   pixel_offset)
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                   device=device)

    with timer.stage("precompute"):
        res = _trace_grid(metric, scene, cfg, disk, alpha, theta)

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        everything = slice(None)
        background = _background(img, alpha, theta, res, everything,
                                 resolution, alpha_crit, fov, scene, cfg)
        intensity, rgb = disk_emission(
            scene, disk, r_in, res.n_hits, res.r_hits, res.xi,
            doppler=_doppler(scene, cfg, resolution, device,
                             (pixel_offset,)),
            xi_hits=res.xi_hits)
        lum = _tone_map(intensity, disk.tone_map) * disk_gain
        grayscale = background.dim() == 2
        disk_px = _disk_pixels(lum, intensity, rgb, resolution, grayscale,
                               None if grayscale else background.shape[2])
        hit = (res.n_hits > 0).reshape(resolution)
        composite = _composite(background, disk_px, hit, disk.opaque)

    mask = hit.cpu().numpy()
    stats = dict(
        alpha_crit=alpha_crit,
        disk_pixels=int(mask.sum()),
        disk_mask=mask,
        timings=timer.finish(),
        **_common_stats(scene, disk, res, height * width))
    return composite, stats


def composite_gamma_encode(image, disk_mask, gamma: float = 2.2):
    """Display-encode the disk pixels of a composite: clip(x, 0, 1)^(1 /
    gamma) where disk_mask holds (the background came display-encoded
    from its file; the disk layer is linear light). Approximate for a
    translucent disk, whose masked pixels mix both layers."""
    img = torch.as_tensor(image)
    mask = torch.as_tensor(np.asarray(disk_mask) if not isinstance(
        disk_mask, torch.Tensor) else disk_mask, device=img.device)
    enc = torch.clamp(img, 0.0, 1.0) ** (1.0 / gamma)
    m = mask if img.dim() == 2 else mask[..., None]
    return torch.where(m, enc, img)


def render_disk_aa(scene: SceneConfig, resolution,
                   cfg: RenderConfig = RenderConfig(),
                   disk: DiskConfig = DiskConfig(), aa_samples: int = 4,
                   device="cuda"):
    """Anti-aliased disk render: the jittered passes of aa.aa_offsets,
    stacked on the row axis and traced as one batch, averaged in linear
    emission space, then tone-mapped once. Returns (image, stats) as
    render_disk."""
    from light_path_tracer_tpu_torch.aa import _stacked_grids, aa_offsets

    metric = _scene_metric(scene)
    timer = StageTimer(device)
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)
    n_s = len(offsets)

    with timer.stage("build_lookup"):
        alpha, theta = _stacked_grids(metric, scene, cfg, resolution, fov,
                                      offsets, device=device)

    with timer.stage("precompute"):
        res = _trace_grid(metric, scene, cfg, disk, alpha, theta)

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        intensity, rgb = disk_emission(
            scene, disk, r_in, res.n_hits, res.r_hits, res.xi,
            doppler=_doppler(scene, cfg, resolution, device, offsets),
            xi_hits=res.xi_hits)
        intensity = intensity.reshape(n_s, height * width).mean(dim=0)
        if rgb is not None:
            rgb = rgb.reshape(n_s, height * width, 3).mean(dim=0)
        img = _finish_image(intensity, rgb, resolution, disk.tone_map)

    stats = dict(
        disk_pixels=int((res.n_hits.reshape(n_s, -1) > 0).any(dim=0).sum()),
        aa_samples=n_s,
        timings=timer.finish(),
        **_common_stats(scene, disk, res, n_s * height * width))
    return img, stats


def render_multi_disk(scene: SceneConfig, resolution,
                      cfg: RenderConfig = RenderConfig(),
                      disks=(DiskConfig(),), device="cuda"):
    """Several independent disks (e.g. equatorial and tilted) in one
    trace; returns (image, stats) as render_disk.

    Emission adds over the planes, each with its own r_in, emissivity and
    spectrum parameters (one spectrum type and tone map for all); an
    opaque plane occludes the planes a ray would cross after it, since
    the shared trace parks the ray there. render_multi_disk([d]) equals
    render_disk(d). stats adds disk_pixels_per_plane and n_disks.
    """
    disks = tuple(disks)
    if len({d.spectrum for d in disks}) != 1:
        raise ValueError("all disks must share a spectrum type")
    if len({d.tone_map for d in disks}) != 1:
        raise ValueError("all disks must share a tone_map")
    metric = _scene_metric(scene)
    timer = StageTimer(device)
    height, width = resolution

    with timer.stage("build_lookup"):
        _fov, alpha, theta = _grids(scene, cfg, resolution, device)

    with timer.stage("precompute"):
        results = trace_disk_rays_multi(
            metric, scene.r_obs, alpha.reshape(-1), theta.reshape(-1),
            scene.theta_obs, _lambda_max(scene), cfg.max_steps, disks,
            precision=cfg.precision, method=cfg.integrator,
            two_pass=cfg.two_pass, pass1_steps=cfg.pass1_steps)

    with timer.stage("render"):
        dl = _doppler(scene, cfg, resolution, device)
        intensity = rgb = None
        for disk, res in zip(disks, results):
            inten_p, rgb_p = disk_emission(
                scene, disk, _r_in_of(disk, scene.M, scene.a, scene.Q),
                res.n_hits, res.r_hits, res.xi, doppler=dl,
                xi_hits=res.xi_hits)
            intensity = inten_p if intensity is None else intensity + inten_p
            if rgb_p is not None:
                rgb = rgb_p if rgb is None else rgb + rgb_p
        img = _finish_image(intensity, rgb, resolution, disks[0].tone_map)

    any_hit = torch.zeros_like(results[0].n_hits, dtype=torch.bool)
    for res in results:
        any_hit |= res.n_hits > 0
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        disk_pixels=int(any_hit.sum()),
        disk_pixels_per_plane=[int((r.n_hits > 0).sum()) for r in results],
        n_disks=len(disks),
        timings=timer.finish(),
        **_common_stats(scene, disks[0], results[0], height * width))
    return img, stats


def _concat_disk_results(results):
    """Per-group DiskTraceResults concatenated along the ray axis (the
    hit tuples slot by slot; n_steps summed)."""
    if len(results) == 1:
        return results[0]

    def cat(field):
        first = getattr(results[0], field)
        if isinstance(first, tuple):
            return tuple(torch.cat([getattr(r, field)[i] for r in results])
                         for i in range(len(first)))
        return torch.cat([getattr(r, field) for r in results])

    return DiskTraceResult(**{
        f: (sum(r.n_steps for r in results) if f == "n_steps" else cat(f))
        for f in DiskTraceResult._fields})


def render_scene_with_disk_aa(scene: SceneConfig, source_image,
                              cfg: RenderConfig = RenderConfig(),
                              disk: DiskConfig = DiskConfig(),
                              disk_gain: float = 1.0, aa_samples: int = 4,
                              display_encode: bool = False,
                              stacked: bool = True, device="cuda"):
    """Anti-aliased composite: the average of jittered-subpixel
    composites, in display space (each pass's pixel is wholly disk or
    wholly background; with display_encode, blackbody passes are
    gamma-encoded before the average). Each pass tone-maps to its own
    peak; stats["disk_mask"] is the union of the passes' masks.

    stacked=True traces every pass's rays together, all in one batch up
    to aa._CHUNK_ABOVE rays and in pass-sized groups above (aa.py's
    rule; one ray's result does not depend on its batch), and renders on
    the device; stacked=False runs render_scene_with_disk once an
    offset, the equivalence reference. Returns (image, stats).
    """
    if stacked:
        return _render_scene_with_disk_aa_stacked(
            scene, source_image, cfg, disk, disk_gain, aa_samples,
            display_encode, device)
    return _render_scene_with_disk_aa_loop(
        scene, source_image, cfg, disk, disk_gain, aa_samples,
        display_encode, device)


def _render_scene_with_disk_aa_stacked(scene, source_image, cfg, disk,
                                       disk_gain, aa_samples,
                                       display_encode, device):
    from light_path_tracer_tpu_torch import aa

    metric = _scene_metric(scene)
    timer = StageTimer(device)
    height, width = np.shape(source_image)[:2]
    resolution = (height, width)
    offsets = aa.aa_offsets(aa_samples)
    n_s = len(offsets)
    n_px = height * width

    with timer.stage("load_image"):
        img = _source_tensor(source_image, device)

    with timer.stage("build_lookup"):
        grids = [_grids(scene, cfg, resolution, device, off)
                 for off in offsets]
        fov = grids[0][0]
        alphas = torch.stack([g[1] for g in grids])
        thetas = torch.stack([g[2] for g in grids])
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                   device=device)

    with timer.stage("precompute"):
        step = n_s if n_s * n_px <= aa._CHUNK_ABOVE else 1
        res = _concat_disk_results([
            _trace_grid(metric, scene, cfg, disk, alphas[s:s + step],
                        thetas[s:s + step])
            for s in range(0, n_s, step)])

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        intensity, rgb = disk_emission(
            scene, disk, r_in, res.n_hits, res.r_hits, res.xi,
            doppler=_doppler(scene, cfg, resolution, device, offsets),
            xi_hits=res.xi_hits)
        per_pass = intensity.reshape(n_s, n_px)
        peaks = per_pass.max(dim=1, keepdim=True).values
        lum = (_tone_map(per_pass, disk.tone_map, peaks)
               * disk_gain).reshape(-1)
        grayscale = img.dim() == 2
        channels = None if grayscale else img.shape[2]
        hit = (res.n_hits > 0).reshape(n_s, height, width)
        encode = bool(display_encode and disk.spectrum == "blackbody")
        acc = None
        for s in range(n_s):
            rays = slice(s * n_px, (s + 1) * n_px)
            background = _background(img, alphas[s], thetas[s], res, rays,
                                     resolution, alpha_crit, fov, scene,
                                     cfg)
            disk_px = _disk_pixels(lum[rays], intensity[rays],
                                   None if rgb is None else rgb[rays],
                                   resolution, grayscale, channels)
            comp = _composite(background, disk_px, hit[s], disk.opaque)
            if encode:
                comp = composite_gamma_encode(comp, hit[s])
            acc = comp if acc is None else acc + comp
        image = (acc / n_s).to(torch.float32)

    mask = hit.any(dim=0).cpu().numpy()
    stats = dict(
        alpha_crit=alpha_crit,
        disk_pixels=int(mask.sum()),
        disk_mask=mask,
        aa_samples=n_s,
        display_encoded=encode,
        timings=timer.finish(),
        **_common_stats(scene, disk, res, n_s * n_px))
    return image, stats


def _render_scene_with_disk_aa_loop(scene, source_image, cfg, disk,
                                    disk_gain, aa_samples, display_encode,
                                    device):
    from light_path_tracer_tpu_torch.aa import aa_offsets

    offsets = aa_offsets(aa_samples)
    encode = bool(display_encode and disk.spectrum == "blackbody")
    acc = mask = agg = None
    for off in offsets:
        img, stats = render_scene_with_disk(
            scene, source_image, cfg, disk, disk_gain=disk_gain,
            pixel_offset=tuple(off), device=device)
        if encode:
            img = composite_gamma_encode(img, stats["disk_mask"])
        acc = img if acc is None else acc + img
        mask = (stats["disk_mask"] if mask is None
                else mask | stats["disk_mask"])
        if agg is None:
            agg = dict(stats, timings=dict(stats["timings"]))
        else:
            agg["captured"] += stats["captured"]
            agg["integrator_steps"] += stats["integrator_steps"]
            for key, val in stats["timings"].items():
                agg["timings"][key] = agg["timings"].get(key, 0.0) + val
    agg.update(aa_samples=len(offsets),
               total_rays=agg["total_rays"] * len(offsets),
               traced_rays=agg["traced_rays"] * len(offsets),
               display_encoded=encode, disk_mask=mask,
               disk_pixels=int(mask.sum()))
    return (acc / len(offsets)).to(torch.float32), agg
