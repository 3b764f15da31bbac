"""Compact-star surface imaging and pulse profiles (NICER-style).

The counterpart of `light_path_tracer_tpu.star`: an opaque stellar
surface at r = R with hot spots, imaged through the exterior metric (Kerr,
or Kerr-Newman for a charged scene), and the rotational pulse profile.
Backward-traced rays either miss the star (escaped) or end on its surface
(the capture event at r = R): the surface trace, on a CUDA device the
surface kernel (ops/cuda/surface_kernel.py), on the CPU its plain loop.
For a surface element rotating rigidly at Omega the observed intensity is
g^p T^4(theta_s, phi_s) with the circular-emitter redshift

    g = sqrt(-(g_tt + 2 Omega g_tphi + Omega^2 g_phiphi)) / (1 - Omega xi)

at the hit point (disk.covariant_tphi_components) and the photon's xi =
L/E, optionally limb-darkened by cos^k of the emission angle, cos sigma =
g |p_r| sqrt(g^rr). T^4 is the background plus sigmoid-edged circular
spots (colatitude, azimuth, angular radius, T), each centred at azimuth
az + phase. A pulse profile traces once and re-weights the surface map at
every phase in tensor operations over (phase, ray); with
light_travel_delay each element is seen at its retarded phase, phase -
Omega t_hit, from the trace's error-controlled coordinate time.

Precision follows the JAX package under x64, how its tests run: the
geodesic quantities in the trace dtype, the spot terms (whose NumPy
float64 constants promote there) in float64, so the brightness is
float64; the image is its tone map rounded to float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.disk import (_scene_metric, _tone_map,
                                              covariant_tphi_components)
from light_path_tracer_tpu_torch.ops.kerr_trace import CAPTURED, INVALID
from light_path_tracer_tpu_torch.pipeline import _dtype_of, _no_mesh
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

# Rays x phases of one pulse-profile batch (the phases go in batches of
# at most this many elements, each one set of tensor operations).
_PHASE_BATCH = 1 << 24


@dataclasses.dataclass(frozen=True)
class StarConfig:
    """Stellar surface model: geometry, rotation, temperature map."""

    radius: float = 5.0            # surface radius R [M]
    omega: float = 0.0             # rigid rotation Omega [c/M] (> 0 prograde)
    t_surface: float = 0.5         # background temperature (display units)
    # Hot spots: (colatitude_deg, azimuth_deg, angular_radius_deg, T).
    # Azimuth 0 = the sub-observer meridian at phase 0; overlapping spots
    # add in T^4.
    spots: tuple = ((30.0, 0.0, 20.0, 1.0),)
    edge_deg: float = 2.0          # spot edge smoothing [deg]
    g_power: float = 4.0           # bolometric redshift weight g^p
    limb_k: float = 0.0            # cos^k limb darkening (0 = isotropic)
    tone_map: str = "linear"       # display transfer


def _validate(metric, star: StarConfig):
    """ValueError for a deformed metric, a surface inside the horizon, an
    equator moving faster than light, or a spot that is not 4 numbers."""
    if getattr(metric, "eps3", 0.0):
        raise ValueError("star mode is not wired for Johannsen-Psaltis "
                         "(eps3 != 0): the emitter redshift is a "
                         "Kerr/charged closed form")
    M = float(metric.M)
    a = float(metric.a)
    Q = float(getattr(metric, "Q", 0.0))
    r_h = M + np.sqrt(max(M * M - a * a - Q * Q, 0.0))
    if star.radius <= r_h:
        raise ValueError(f"radius {star.radius} must exceed the "
                         f"horizon r_+ = {r_h:.4f}")
    R = float(star.radius)
    W = 2.0 * M * R - Q * Q
    g_tt = -(1.0 - W / (R * R))
    g_tph = -a * W / (R * R)
    g_pp = R * R + a * a + a * a * W / (R * R)
    den = -(g_tt + 2.0 * star.omega * g_tph + star.omega ** 2 * g_pp)
    if not den > 0.0:
        raise ValueError(f"omega {star.omega} is superluminal at the "
                         f"equator of radius {star.radius}")
    for spot in star.spots:
        if len(spot) != 4:
            raise ValueError("each spot is (colat_deg, az_deg, "
                             f"radius_deg, T), got {spot!r}")


def _mod(x, c):
    """x mod c with the divisor's sign, from the exact fmod (jnp.mod)."""
    r = torch.fmod(x, c)
    return torch.where((r != 0) & ((r < 0) != (c < 0)), r + c, r)


def _physical_angles(theta, phi):
    """Fold the integrator's double-cover chart onto the physical sphere:
    theta mod 2 pi reflected off the poles (passing over a pole advances
    the azimuth by pi), phi mod 2 pi."""
    two_pi = 2.0 * math.pi
    th = _mod(theta, two_pi)
    flip = th > math.pi
    th = torch.where(flip, two_pi - th, th)
    ph = torch.where(flip, phi + math.pi, phi)
    return th, _mod(ph, two_pi)


def temperature4_map(star: StarConfig, theta_s, phi_s, phase):
    """T^4(theta_s, phi_s) of the surface map rotated by `phase` [rad]
    (a tensor that broadcasts with the angles): the background plus each
    spot's sigmoid mask in cos d, d the great-circle distance to its
    centre, over a width of edge_deg. float64."""
    f64 = torch.float64
    t4 = torch.full(theta_s.shape, float(star.t_surface) ** 4,
                    dtype=theta_s.dtype, device=theta_s.device).to(f64)
    cth = torch.cos(theta_s).to(f64)
    sth = torch.sin(theta_s).to(f64)
    phi64 = phi_s.to(f64)
    phase = torch.as_tensor(phase, device=theta_s.device).to(f64)
    w = math.radians(max(float(star.edge_deg), 1e-3))
    for colat_deg, az_deg, rad_deg, t_spot in star.spots:
        colat = math.radians(float(colat_deg))
        rad = math.radians(float(rad_deg))
        az = math.radians(float(az_deg))
        cosd = (math.cos(colat) * cth
                + math.sin(colat) * sth * torch.cos(phi64 - az - phase))
        width = max(math.sin(rad), 1e-3) * w
        mask = torch.sigmoid((cosd - math.cos(rad)) / width)
        t4 = t4 + (float(t_spot) ** 4 - float(star.t_surface) ** 4) * mask
    return t4


def surface_redshift(metric, star: StarConfig, theta_s, xi):
    """g = nu_obs / nu_em of a surface element at colatitude theta_s
    rotating at Omega, seen by the photon of xi = L/E; clipped to
    [0, 10]."""
    r = torch.full((), float(star.radius), dtype=theta_s.dtype,
                   device=theta_s.device)
    g_tt, g_tph, g_pp = covariant_tphi_components(metric, r,
                                                  torch.cos(theta_s))
    om = float(star.omega)
    den = torch.clamp(-(g_tt + 2.0 * om * g_tph + om * om * g_pp),
                      min=1e-12)
    g = torch.sqrt(den) / torch.clamp(1.0 - om * xi, min=1e-3)
    return torch.clamp(g, 0.0, 10.0)


def _emission_cos(metric, star: StarConfig, theta_s, p_r, g):
    """cos of the emission angle in the emitter frame, g |p_r|
    sqrt(g^rr), clipped to [0, 1]."""
    like = theta_s
    r = torch.full((), float(star.radius), dtype=like.dtype,
                   device=like.device)
    M = torch.full((), float(metric.M), dtype=like.dtype, device=like.device)
    a = torch.full((), float(metric.a), dtype=like.dtype, device=like.device)
    g_rr_inv = metric._inv_terms(r, theta_s, M, a)[2]
    return torch.clamp(g * torch.abs(p_r) * torch.sqrt(g_rr_inv), 0.0, 1.0)


def _brightness(metric, star: StarConfig, theta_raw, phi_raw, p_r, xi,
                t_hit, status, phase, delay: bool = False):
    """Observed brightness g^p T^4 (limb-darkened) of each ray at the
    rotation phase, 0 off the surface; float64. `phase` is a tensor that
    broadcasts with the rays ((P, 1) for P phases gives (P, N)). With
    delay each element is seen at its retarded phase, phase - Omega
    t_hit."""
    th, ph = _physical_angles(theta_raw, phi_raw)
    g = surface_redshift(metric, star, th, xi)
    phase = torch.as_tensor(phase, device=th.device)
    eval_phase = phase - star.omega * t_hit if delay else phase
    t4 = temperature4_map(star, th, ph, eval_phase)
    b = g ** star.g_power * t4
    if star.limb_k:
        b = b * _emission_cos(metric, star, th, p_r, g) ** star.limb_k
    return torch.where(status == CAPTURED, b, torch.zeros((), dtype=b.dtype,
                                                          device=b.device))


def _surface_trace(metric, scene, cfg, alpha, theta, radius, record_time):
    from light_path_tracer_tpu_torch.ops.cuda.surface_kernel import (
        trace_rays_surface_cuda)
    return trace_rays_surface_cuda(
        metric, scene.r_obs, alpha.reshape(-1), theta.reshape(-1),
        scene.theta_obs, float(radius), max(5000.0, 6.0 * scene.r_obs),
        cfg.max_steps, precision=cfg.precision, method=cfg.integrator,
        record_time=record_time)


def render_star(scene: SceneConfig, resolution,
                cfg: RenderConfig = RenderConfig(),
                star: StarConfig = StarConfig(), phase: float = 0.0,
                mesh=None, device="cuda"):
    """Stellar-surface image; returns (image (H, W) float32 in [0, 1] on
    `device`, stats). stats['brightness'] holds the raw per-pixel g^p
    T^4 (float64, (H, W), on `device`) and stats['apparent_radius_rad']
    the captured disk's angular radius by pixel area: the light-bending
    enlarged size, R / sqrt(1 - 2M/R) in Schwarzschild."""
    _no_mesh(mesh, "render_star")
    metric = _scene_metric(scene)
    _validate(metric, star)
    timer = StageTimer(device)
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    grid = dict(psi=scene.psi, dtype=_dtype_of(cfg), boost=scene.boost,
                device=device)

    with timer.stage("build_lookup"):
        alpha = camera.build_alpha_lookup(resolution, fov, **grid)
        theta = camera.build_theta_lookup(resolution, fov, **grid)
    with timer.stage("precompute"):
        res = _surface_trace(metric, scene, cfg, alpha, theta, star.radius,
                             False)
    with timer.stage("render"):
        bright = _brightness(
            metric, star, res.theta, res.phi, res.p_r, res.xi, res.t_hit,
            res.status, torch.tensor(float(phase), dtype=alpha.dtype))
        image = _tone_map(bright, star.tone_map).reshape(
            tuple(resolution)).to(torch.float32)

    status = res.status
    n_cap = int((status == CAPTURED).sum())
    px_solid = (fov[0] / height) * (fov[1] / width)
    stats = dict(
        captured=n_cap,
        invalid=int((status == INVALID).sum()),
        brightness=bright.reshape(tuple(resolution)),
        apparent_radius_rad=float(np.sqrt(max(n_cap, 0) * px_solid / np.pi)),
        integrator_steps=int(res.n_steps),
        total_rays=height * width,
        traced_rays=height * width,
        timings=timer.finish())
    return image, stats


def pulse_profile(scene: SceneConfig, cfg: RenderConfig = RenderConfig(),
                  star: StarConfig = StarConfig(), n_phases: int = 64,
                  resolution=(128, 128), light_travel_delay=False,
                  device="cuda"):
    """Rotational light curve: one surface trace, then the surface map
    re-weighted at every phase in tensor operations over (phase, ray).
    Returns (phases (n,), flux (n,) over its mean, stats), NumPy float64.
    light_travel_delay records the coordinate time to the surface and
    sees each element at its retarded phase."""
    metric = _scene_metric(scene)
    _validate(metric, star)
    timer = StageTimer(device)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = _dtype_of(cfg)
    grid = dict(psi=scene.psi, dtype=dtype, boost=scene.boost, device=device)
    alpha = camera.build_alpha_lookup(resolution, fov, **grid)
    theta = camera.build_theta_lookup(resolution, fov, **grid)
    with timer.stage("precompute"):
        res = _surface_trace(metric, scene, cfg, alpha, theta, star.radius,
                             bool(light_travel_delay))

    phases = torch.as_tensor(np.linspace(0.0, 2.0 * np.pi, n_phases,
                                         endpoint=False)).to(dtype)
    with timer.stage("render"):
        rays = res.status.numel()
        per = max(1, _PHASE_BATCH // max(rays, 1))
        parts = []
        for s in range(0, n_phases, per):
            ph = phases[s:s + per].to(device)[:, None]
            parts.append(_brightness(
                metric, star, res.theta, res.phi, res.p_r, res.xi,
                res.t_hit, res.status, ph,
                delay=bool(light_travel_delay)).sum(dim=1))
        flux = torch.cat(parts)

    flux = flux.cpu().numpy().astype(np.float64)
    mean = flux.mean() if flux.mean() > 0 else 1.0
    stats = dict(
        captured=int((res.status == CAPTURED).sum()),
        integrator_steps=int(res.n_steps),
        modulation=float((flux.max() - flux.min())
                         / max(flux.max() + flux.min(), 1e-30)),
        timings=timer.finish())
    return phases.numpy().astype(np.float64), flux / mean, stats
