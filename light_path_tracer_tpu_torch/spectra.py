"""Relativistic disk spectroscopy: the emission-line profile and the
hot-spot light curve.

The counterpart of `light_path_tracer_tpu.spectra`. Both observables come
from the crossing record of one disk trace (disk.py), with no new
integration:

* `line_profile`: a monochromatic line emitted at rest energy E0 arrives
  at E_obs = g E0, g the Keplerian redshift that colours the disk image;
  binning every visible crossing's flux g^p (r / r_in)^-q by g gives the
  double-horned diskline with its gravitationally redshifted red wing.
  The histogram keeps numpy's semantics, as `jnp.histogram` does: edges
  from the JAX package's linspace rule in the data's dtype, a bin by
  searchsorted(side="right"), the last edge inclusive and values outside
  the range dropped. `torch.histogram` does not run on CUDA and
  `torch.histc` takes no weights, so the weights are summed with
  scatter_add.
* `hotspot_light_curve`: the total observed flux against coordinate time
  for an orbiting hot spot, the frames of `disk.render_disk_frames`
  summed over pixels instead of imaged.

The trace runs through the CUDA kernel's disk variant on a CUDA device and
its plain loop on the CPU; the retarded-time light curve
(light_travel_delay) records each crossing's coordinate time (the
kernel's plane-recorder instances on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.disk import (
    DiskConfig, HotSpot, _doppler, _r_in_of, _scene_metric, _trace_grid,
    disk_emission, hotspot_pattern, keplerian_omega, keplerian_redshift,
    r_isco)
from light_path_tracer_tpu_torch.ops.kerr_trace import CAPTURED
from light_path_tracer_tpu_torch.pipeline import _dtype_of
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer

__all__ = ["histogram_edges", "weighted_histogram", "line_profile",
           "hotspot_light_curve"]


def histogram_edges(lo, hi, n_bins: int, dtype, device="cpu"):
    """The n_bins + 1 edges of jnp.histogram over range (lo, hi) in
    `dtype`: the bounds rounded to dtype (widened by 0.5 each way if
    equal), then jnp.linspace's lo (1 - s) + hi s at s = i / n_bins, and
    hi last, as XLA on the CPU compiles it: s = i * (1 / n_bins), hi s =
    i (hi / n_bins), and the last product and sum fused into one rounding
    (in float32 that fused step is taken in float64, where the product is
    exact, so these edges are XLA's bit for bit; XLA contracts float64
    otherwise by vector width, so float64 edges may differ from its by an
    ulp)."""
    t = dict(dtype=dtype, device=device)
    lo, hi = torch.tensor(float(lo), **t), torch.tensor(float(hi), **t)
    if bool(lo == hi):
        lo, hi = lo - 0.5, hi + 0.5
    c = 1.0 / torch.tensor(float(n_bins), **t)
    i = torch.arange(n_bins, **t)
    low = lo * (1 - i * c)
    if dtype == torch.float32:
        inner = (i.double() * (hi * c).double() + low.double()).float()
    else:
        inner = low + i * (hi * c)
    return torch.cat([inner, hi[None]])


def weighted_histogram(values, weights, edges):
    """jnp.histogram's weighted counts of `values` over `edges`: the bin
    of a value is searchsorted(edges, value, side="right"), a value equal
    to the last edge falls in the last bin, and values below the first
    or above the last edge are dropped."""
    n = edges.numel()
    idx = torch.searchsorted(edges, values.contiguous(), right=True)
    idx = torch.where(values == edges[-1], n - 1, idx)
    counts = torch.zeros(n + 1, dtype=weights.dtype, device=weights.device)
    counts.scatter_add_(0, idx, weights)
    return counts[1:n]


def _trace_disk_grid(scene, resolution, cfg, disk, timer, aa_samples=1,
                     device="cuda", record_time=False):
    """Camera grids (aa_samples jittered passes stacked on the row axis,
    aa.aa_offsets) and one disk trace; returns (the DiskTraceResult, the
    moving camera's per-ray Doppler factors or None)."""
    from light_path_tracer_tpu_torch.aa import _stacked_grids, aa_offsets
    metric = _scene_metric(scene)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    offsets = aa_offsets(aa_samples)

    with timer.stage("build_lookup"):
        alpha, theta = _stacked_grids(metric, scene, cfg, resolution, fov,
                                      offsets, device=device)

    with timer.stage("precompute"):
        # Jittered grids force the two-pass straggler driver.
        two_pass = (cfg.two_pass if aa_samples == 1 or cfg.two_pass != "auto"
                    else True)
        res = _trace_grid(metric, scene, cfg, disk, alpha, theta,
                          two_pass=two_pass, record_time=record_time)
    return res, _doppler(scene, cfg, resolution, device, offsets)


def _disk_stats(scene, disk, res, rays, timer):
    return dict(r_isco=r_isco(scene.M, scene.a, disk.prograde, Q=scene.Q),
                disk_pixels=int((res.n_hits > 0).sum()),
                integrator_steps=int(res.n_steps), total_rays=rays,
                traced_rays=rays, timings=timer.finish())


def line_profile(scene: SceneConfig, resolution=(512, 512),
                 cfg: RenderConfig = RenderConfig(),
                 disk: DiskConfig = DiskConfig(), n_bins: int = 200,
                 g_lim=None, rest_energy: float = 6.4, aa_samples: int = 1,
                 device="cuda"):
    """Observed profile of a monochromatic disk emission line.

    Returns (energy_centers, flux, stats), NumPy float arrays: flux[i] is
    the summed line flux in energy bin i, the centres in the units of
    rest_energy (6.4 = Fe K-alpha in keV; 1.0 gives the profile in g).
    g_lim = (g_min, g_max) is the histogram range, None autoscaling to
    the seen g with 2 % margins. A crossing's weight is g^g_power (r /
    r_in)^-q, divided by aa_samples (jittered passes multiply the
    samples and keep the total). An empty field of view raises
    ValueError.
    """
    timer = StageTimer(device)
    res, dl = _trace_disk_grid(scene, resolution, cfg, disk, timer,
                               aa_samples=aa_samples, device=device)
    r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)

    with timer.stage("render"):
        gs, ws = [], []
        for slot in range(1 if disk.opaque else disk.max_hits):
            hit = res.n_hits > slot
            r_c = torch.clamp(res.r_hits[slot], min=r_in)
            xi = res.xi_hits[slot] if len(res.xi_hits) > slot else res.xi
            g = keplerian_redshift(scene.M, scene.a, r_c, xi,
                                   disk.prograde, Q=scene.Q)
            if dl is not None:
                g = g * dl
            eps = (r_c / r_in) ** (-disk.emissivity_index)
            ws.append(torch.where(hit, g ** disk.g_power * eps, 0.0)
                      / aa_samples)
            gs.append(torch.where(hit, g, torch.nan))
        g_all = torch.cat(gs)
        w_all = torch.cat(ws)
        if g_lim is None:
            seen = g_all[w_all > 0].cpu().numpy()
            if seen.size == 0:
                raise ValueError(
                    "no disk crossings in the field of view — the line "
                    "profile is empty (check theta_obs / r_out / fov)")
            lo, hi = float(seen.min()), float(seen.max())
            margin = 0.02 * max(hi - lo, 1e-6)
            g_lim = (lo - margin, hi + margin)
        edges = histogram_edges(g_lim[0], g_lim[1], n_bins, g_all.dtype,
                                g_all.device)
        flux = weighted_histogram(torch.nan_to_num(g_all, nan=-1.0), w_all,
                                  edges)

    e = edges.cpu().numpy()
    centers = 0.5 * (e[:-1] + e[1:])
    stats = dict(g_lim=tuple(g_lim), rest_energy=rest_energy,
                 captured=int((res.status == CAPTURED).sum()),
                 **_disk_stats(scene, disk, res, resolution[0]
                               * resolution[1] * aa_samples, timer))
    return (centers * rest_energy, flux.cpu().numpy().astype(np.float64),
            stats)


def hotspot_light_curve(scene: SceneConfig, resolution, times,
                        cfg: RenderConfig = RenderConfig(),
                        disk: DiskConfig = DiskConfig(),
                        spot: HotSpot = HotSpot(), pattern=None,
                        light_travel_delay: bool = False, device="cuda"):
    """Total observed flux against coordinate time for an orbiting hot
    spot: one trace, the pattern re-evaluated at each time (in the trace
    dtype) and the emission summed over pixels. Returns (times (T,),
    flux (T,), stats) as float64 NumPy arrays; one spot orbit is
    stats["orbit_period"] M.

    light_travel_delay=True records each crossing's coordinate time
    (record_time) and evaluates the pattern at the retarded time t -
    delay: the far side of the disk and the lensed secondary image are
    seen at older phases. Delays are referred to the earliest recorded
    first crossing among lit pixels (a constant offset only re-phases a
    periodic pattern); stats["delay_spread"] is their spread over the
    image in M.
    """
    timer = StageTimer(device)
    times = list(times)
    res, dl = _trace_disk_grid(scene, resolution, cfg, disk, timer,
                               device=device,
                               record_time=light_travel_delay)
    delay_hits, delay_spread = (), 0.0
    if light_travel_delay:
        hit0 = res.n_hits > 0
        if bool(hit0.any()):
            t0 = res.t_hits[0]
            big = torch.full_like(t0, np.inf)
            t_ref = torch.min(torch.where(hit0, t0, big))
            delay_hits = tuple(t - t_ref for t in res.t_hits)
            delay_spread = float(torch.max(torch.where(hit0, t0, -big))
                                 - t_ref)
    r_in = _r_in_of(disk, scene.M, scene.a, scene.Q)
    if pattern is None:
        pattern = hotspot_pattern(spot, scene.M, scene.a, disk.prograde,
                                  Q=scene.Q)

    with timer.stage("render"):
        ts = torch.tensor(times, dtype=_dtype_of(cfg), device=device)
        flux = torch.stack([disk_emission(
            scene, disk, r_in, res.n_hits, res.r_hits, res.xi, doppler=dl,
            pattern=pattern, phi_hits=res.phi_hits, t=t,
            xi_hits=res.xi_hits, delay_hits=delay_hits)[0].sum()
            for t in ts])

    stats = dict(orbit_period=abs(2.0 * np.pi / keplerian_omega(
                     scene.M, scene.a, spot.r0, disk.prograde, Q=scene.Q)),
                 n_samples=len(times), delay_spread=delay_spread,
                 **_disk_stats(scene, disk, res, resolution[0]
                               * resolution[1], timer))
    return (np.asarray(times, np.float64),
            flux.cpu().numpy().astype(np.float64), stats)
