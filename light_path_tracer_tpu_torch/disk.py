"""Thin accretion-disk rendering with gravitational redshift and Doppler
beaming (BASELINE.json config 4).

The counterpart of `light_path_tracer_tpu.disk` for the still render
(`render_disk`). Model: a geometrically thin equatorial disk of Keplerian
circular orbits between r_in (default r_isco) and r_out, power-law
emissivity eps(r) ~ r^-q or a Shakura-Sunyaev blackbody. The trace
records each ray's first max_hits in-disk equatorial crossings; each
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
map are plain PyTorch on the same device. The ISCO is host NumPy.

Not ported yet (they raise, see ROADMAP.md): tilted and warped disks,
the crossing-time recorder, a boosted camera, the decomposed, frame, AA,
composite,
multi-disk and multi-host renders, and the hot-spot and texture patterns.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.models import Kerr, KerrNewman
from light_path_tracer_tpu_torch.ops.batch import _backend
from light_path_tracer_tpu_torch.ops.kerr_trace import CAPTURED
from light_path_tracer_tpu_torch.ops.types import DiskTraceResult
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

__all__ = ["DiskConfig", "DiskTraceResult", "r_isco", "disk_temperature",
           "keplerian_omega", "keplerian_redshift",
           "covariant_tphi_components", "trace_disk_rays", "disk_emission",
           "decomposed_display", "render_disk"]


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md, "
        f"Queue 1)")


@dataclasses.dataclass(frozen=True)
class DiskConfig:
    """The JAX package's DiskConfig, field for field."""

    r_out: float = 20.0            # outer edge in units of M
    r_in: float | None = None      # None -> r_isco
    emissivity_index: float = 3.0  # eps(r) ~ r^-q (powerlaw spectrum)
    g_power: float = 3.0           # I_obs = g^p * eps (powerlaw spectrum)
    opaque: bool = True            # first crossing blocks deeper images
    prograde: bool = True          # orbit sense vs the BH spin
    # Tilted / warped disk (not ported yet: nonzero values raise).
    tilt: float = 0.0
    tilt_azimuth: float = 0.0
    warp_radius: float | None = None
    max_hits: int = 2
    tone_map: str = "asinh"        # "asinh" | "linear" | "sqrt"
    # "powerlaw": grayscale g^p r^-q; "blackbody": T_obs = g T_em with a
    # Shakura-Sunyaev profile, intensity ~ T_obs^4, utils/color.py colour.
    spectrum: str = "powerlaw"
    t_peak: float = 9000.0         # blackbody: peak disk temperature [K]


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
    """Trace rays recording equatorial crossings; returns DiskTraceResult.

    The tensors' device picks the path (backend must be 'auto'): the
    CUDA kernel's disk variant for a CUDA tensor, its plain loop for a
    CPU tensor. two_pass: straggler containment ('auto' = on, as in the
    JAX package, whose disk workloads come from jittered grids whose
    near-axis rays grind thousands of steps); pass1_steps caps the first
    pass.
    """
    if method not in ("dp45", "dop853"):
        raise ValueError(
            f"disk mode supports integrator 'dp45' or 'dop853' (the "
            f"crossing recorder lives in the adaptive loop), got "
            f"{method!r}")
    if disk.tilt != 0.0 or disk.warp_radius is not None:
        raise _not_ported("tilted or warped disks")
    if record_time:
        raise _not_ported("the crossing-time recorder (record_time)")
    _backend(backend, alphas)
    plane = (_r_in_of(disk, metric.M, metric.a, getattr(metric, "Q", 0.0)),
             float(disk.r_out),
             float(np.pi / 2), bool(disk.opaque))
    from light_path_tracer_tpu_torch.ops.cuda.kerr_trace_kernel import (
        trace_disk_rays_cuda, trace_disk_rays_two_pass)
    args = (metric, float(r_obs), alphas, thetas, float(theta_obs),
            float(lambda_max), max_steps, plane, disk.max_hits)
    if two_pass if two_pass != "auto" else True:
        return trace_disk_rays_two_pass(
            *args, pass1_steps=pass1_steps, precision=precision,
            record_momentum=record_momentum, method=method)
    return trace_disk_rays_cuda(*args, precision=precision,
                                record_momentum=record_momentum,
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
    crossing's radius. doppler (a moving camera) is not ported yet.
    """
    if doppler is not None:
        raise _not_ported("the camera Doppler factor (boost)")
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
    if scene.boosted:
        raise _not_ported("a boosted camera (boost)")
    timer = StageTimer(device)
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32

    with timer.stage("build_lookup"):
        grid = dict(psi=scene.psi, dtype=dtype, device=device)
        alpha = camera.build_alpha_lookup(resolution, fov, **grid)
        theta = camera.build_theta_lookup(resolution, fov, **grid)

    with timer.stage("precompute"):
        res = trace_disk_rays(
            metric, scene.r_obs, alpha.reshape(-1), theta.reshape(-1),
            scene.theta_obs, max(5000.0, 6.0 * scene.r_obs),
            cfg.max_steps, disk, backend=cfg.backend,
            precision=cfg.precision, method=cfg.integrator,
            two_pass=cfg.two_pass, pass1_steps=cfg.pass1_steps)

    with timer.stage("render"):
        r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
        intensity, rgb = disk_emission(scene, disk, r_in, res.n_hits,
                                       res.r_hits, res.xi,
                                       xi_hits=res.xi_hits)
        img = _finish_image(intensity, rgb, resolution, disk.tone_map)

    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device),
        r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
        captured=int((res.status == CAPTURED).sum()),
        disk_pixels=int((res.n_hits > 0).sum()),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return img, stats
