"""360-degree equirectangular panorama renders (VR skyboxes, domes).

The counterpart of `light_path_tracer_tpu.pano`: the whole celestial
sphere around the observer, lensed through the black hole, in one
equirectangular (longitude x latitude) frame. Chart convention (camera
coords +x right, +y down, +z forward):

  * pixel centres at (px + 0.5, py + 0.5) of an (H, W) grid (W = 2H is
    the standard aspect; any aspect works);
  * longitude lon = (px + 0.5) / W 2 pi - pi, wrapping in x, 0 on +z;
  * latitude lat = pi/2 - (py + 0.5) / H pi, row 0 the zenith (-y), its
    bottom rows the exact negations of the top ones.

A pixel's view direction is (cos lat sin lon, -sin lat, cos lat cos lon).
The per-pixel (alpha, theta) about the hole feed ops/batch.trace_batch:
Kerr-family metrics the Kerr kernel (or the hybrid tracer with
formulation "mu"), spherically symmetric ones the orbit kernel, on a CUDA
device; their plain loops on the CPU. The top/bottom mirror fold applies
row for row for an equatorial observer. Escaped rays gather from an
equirectangular source sky by the inverse chart; unlike the pinhole
renderer every escape direction has a texel, and the winding palette is
an opt-in overlay.

Precision follows the JAX package under x64, how its tests run: the
chart in the trace dtype, the products with the float64 frame vectors,
arccos, arctan2 and the inverse chart in float64, rounded once. The JAX
package's fused one-program path is one eager body here; `mesh=` raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from light_path_tracer_tpu_torch import camera
from light_path_tracer_tpu_torch.operands import kernel_operand
from light_path_tracer_tpu_torch.ops.batch import trace_batch
from light_path_tracer_tpu_torch.pipeline import _dtype_of, _no_mesh, _use_tb
from light_path_tracer_tpu_torch.render import (WINDING_COLORS,
                                                _bilinear_gather,
                                                _frame_floats, _palette,
                                                _to_i32)
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig
from light_path_tracer_tpu_torch.utils.timing import StageTimer


# ---- the equirect chart ----

def pano_directions(image_dimension, dtype=torch.float32, device="cuda"):
    """Unit view-direction component grids (vx, vy, vz), each (H, W), in
    `dtype` on `device`."""
    height, width = image_dimension
    f = dict(dtype=dtype, device=device)
    lon = torch.arange(width, **f) + 0.5
    lon = lon / kernel_operand(width, lon) * (2 * math.pi) - math.pi
    half = (height + 1) // 2
    lat_top = torch.arange(half, **f) + 0.5
    lat_top = math.pi / 2 - lat_top / kernel_operand(height, lat_top) * math.pi
    lat = torch.cat([lat_top, -lat_top[:height // 2].flip(0)])
    cos_lat = torch.cos(lat)[:, None]
    vx = cos_lat * torch.sin(lon)[None, :]
    vy = (-torch.sin(lat))[:, None].expand(height, width)
    vz = cos_lat * torch.cos(lon)[None, :]
    return vx, vy, vz


def pano_pixel_coords(vx, vy, vz, image_dimension):
    """Inverse chart: directions -> continuous (px, py) source coordinates
    (the exact inverse of pano_directions at pixel centres; longitude
    wraps, latitude clamps)."""
    height, width = image_dimension
    lon = torch.arctan2(vx, vz)
    lat = torch.arcsin(torch.clamp(-vy, -1.0, 1.0))
    px = (lon + math.pi) / (2 * math.pi) * width - 0.5
    py = (math.pi / 2 - lat) / math.pi * height - 0.5
    return px, py


def build_pano_lookups(image_dimension, psi=(0.0, 0.0), dtype=torch.float32,
                       boost=None, device="cuda"):
    """Per-pixel (alpha, theta) about the BH direction on the equirect
    chart, (H, W) each in `dtype`: the chart in `dtype` (aberrated by a
    boost as the pinhole builders do), the frame products, arccos and
    arctan2 in float64, rounded once."""
    d, e_x, e_y = _frame_floats(camera.psi_frame(psi))
    vx, vy, vz = pano_directions(image_dimension, dtype, device)
    if camera._boosted(boost):
        vx, vy, vz = camera.aberrate_view(vx, vy, vz, boost)
    vx, vy, vz = (v.to(torch.float64) for v in (vx, vy, vz))
    cos_alpha = vx * d[0] + vy * d[1] + vz * d[2]
    alpha = torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))
    theta = torch.arctan2(vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
                          vx * e_y[0] + vy * e_y[1] + vz * e_y[2])
    return alpha.to(dtype), theta.to(dtype)


def pano_refine_mask(alpha, theta, refine_frac=0.07):
    """Boolean pole-risk band of the equirect chart: view directions
    within refine_frac pi of the vertical plane through the hole
    (sin(alpha) |sin(theta)| below the sine of that angle, compared in
    float64), never narrower than the pinhole band."""
    band = float(np.sin(min(refine_frac * np.pi, np.pi / 2)))
    dist = torch.sin(alpha) * torch.abs(torch.sin(theta))
    return dist.to(torch.float64) < band


def grid_sky(image_dimension, n_lat=18, n_lon=36):
    """Procedural equirect test sky: a lat/lon graticule over a two-tone
    gradient, with a red patch on the forward axis (the CLI's
    --grid-sky). Returns an (H, W, 3) float32 NumPy array in [0, 1]."""
    height, width = image_dimension
    py, px = np.mgrid[0:height, 0:width]
    lat_t = (py + 0.5) / height
    horizon = 1.0 - np.abs(lat_t - 0.5) * 2.0
    sky = np.stack([0.15 + 0.55 * horizon,
                    0.20 + 0.35 * horizon,
                    0.45 + 0.25 * (1.0 - horizon)], axis=-1)
    on_lon = (px * n_lon) // width != ((px + 1) * n_lon) // width
    on_lat = (py * n_lat) // height != ((py + 1) * n_lat) // height
    sky[on_lat] = (0.8, 0.8, 0.8)
    sky[on_lon] = (1.0, 1.0, 1.0)
    fy, fx = height // 2, width // 2
    r = max(1, height // 64)
    sky[max(0, fy - r):fy + r, max(0, fx - r):fx + r] = (1.0, 0.1, 0.1)
    return sky.astype(np.float32)


# ---- renderer ----

def _pano_render_core(source_pano, theta_lookup, final_alpha_lookup,
                      winding_lookup, d, e_x, e_y, sampling="nearest",
                      winding_overlay=False):
    """Equirect renderer body: the shadow stays black, every escaped ray
    gathers from the source sky by the inverse chart. d, e_x, e_y: the
    camera frame's float64 vectors."""
    if sampling not in ("nearest", "bilinear"):
        raise ValueError(f"sampling must be 'nearest' or 'bilinear', got "
                         f"{sampling!r}")
    height, width = source_pano.shape[:2]
    grayscale = source_pano.dim() == 2
    channels = 1 if grayscale else int(source_pano.shape[2])
    src = source_pano[..., None] if grayscale else source_pano
    compute_dtype = final_alpha_lookup.dtype

    valid = torch.isfinite(final_alpha_lookup)
    fa = torch.where(valid, final_alpha_lookup,
                     torch.zeros_like(final_alpha_lookup))
    th = theta_lookup.to(compute_dtype)

    f64 = torch.float64
    sin_fa, cos_fa = torch.sin(fa).to(f64), torch.cos(fa).to(f64)
    sin_th, cos_th = torch.sin(th).to(f64), torch.cos(th).to(f64)
    d, e_x, e_y = ([float(c) for c in v] for v in (d, e_x, e_y))
    sx = sin_th * e_x[0] + cos_th * e_y[0]
    sy = sin_th * e_x[1] + cos_th * e_y[1]
    sz = sin_th * e_x[2] + cos_th * e_y[2]
    px, py = pano_pixel_coords(cos_fa * d[0] + sin_fa * sx,
                               cos_fa * d[1] + sin_fa * sy,
                               cos_fa * d[2] + sin_fa * sz, (height, width))
    src_flat = src.reshape(height * width, channels)
    if sampling == "bilinear":
        texture = _bilinear_gather(src_flat, px, py, height, width,
                                   (False, True))
    else:
        src_x = torch.remainder(_to_i32(torch.round(px)), width)
        src_y = torch.clamp(_to_i32(torch.round(py)), 0, height - 1)
        texture = src_flat[src_y.to(torch.int64) * width
                           + src_x.to(torch.int64)]

    out = torch.where(valid[..., None], texture,
                      torch.zeros((), dtype=src.dtype, device=src.device))
    if winding_overlay:
        palette = _palette(channels, grayscale, src.device).to(src.dtype)
        w = winding_lookup.to(torch.int64)
        ring = valid & (w >= 1)
        out = torch.where(ring[..., None],
                          palette[torch.clamp(w, 0, len(WINDING_COLORS) - 1)],
                          out)
    return out[..., 0] if grayscale else out


def render_pano_image(source_pano, final_alpha_lookup, winding_lookup,
                      psi=(0.0, 0.0), theta_lookup=None,
                      sampling="nearest", winding_overlay=False):
    """Render an equirect frame from traced lookup tables on one device.
    `source_pano` is the equirect sky (H, W[, C]); the output has the
    shape of `final_alpha_lookup`, which need not match the source's."""
    device = final_alpha_lookup.device
    if theta_lookup is None:
        _, theta_lookup = build_pano_lookups(
            tuple(final_alpha_lookup.shape), psi=psi,
            dtype=final_alpha_lookup.dtype, device=device)
    if winding_lookup is None:
        winding_lookup = torch.zeros(final_alpha_lookup.shape,
                                     dtype=torch.int32, device=device)
    frame = camera.psi_frame(psi)
    return _pano_render_core(
        torch.as_tensor(source_pano, device=device), theta_lookup,
        final_alpha_lookup, winding_lookup, frame.d, frame.e_x, frame.e_y,
        sampling, winding_overlay)


# ---- pipeline driver ----

@dataclasses.dataclass
class PanoOutput:
    image: object                 # (H, W[, C]) lensed equirect frame
    final_alpha: object           # (H, W) float32, NaN = shadow
    winding: object               # (H, W) uint16
    alpha_crit: float
    total_rays: int
    traced_rays: int
    integrator_steps: object
    timings: dict
    scene: SceneConfig
    render_cfg: RenderConfig


def _pano_precompute(scene, cfg, image_dimension, mesh=None, device="cuda"):
    """Trace one ray per chart pixel (the top (H + 1) // 2 rows under the
    mirror fold) -> (final_alpha float32, winding uint16, steps, traced
    rays). The mirror fold takes the pinhole fold's conditions
    (pipeline._use_tb): lat -> -lat mirrors the rows exactly."""
    _no_mesh(mesh, "_pano_precompute")
    metric = scene.metric()
    height, width = image_dimension
    alpha, theta = build_pano_lookups(image_dimension, psi=scene.psi,
                                      dtype=_dtype_of(cfg), boost=scene.boost,
                                      device=device)
    use_tb = _use_tb(scene, cfg)
    rows = (height + 1) // 2 if use_tb else height
    if metric.is_spherically_symmetric:
        res = trace_batch(metric, scene.r_obs, alpha[:rows].reshape(-1),
                          chunk_size=cfg.chunk_size, phi_max=cfg.phi_max,
                          h_max=cfg.h_max, backend=cfg.backend,
                          progress=cfg.progress)
    else:
        refine = pano_refine_mask(alpha[:rows], theta[:rows],
                                  cfg.axis_refine_frac)
        res = trace_batch(
            metric, scene.r_obs, alpha[:rows].reshape(-1),
            theta[:rows].reshape(-1), scene.theta_obs, refine.reshape(-1),
            chunk_size=cfg.chunk_size,
            sort_by_difficulty=cfg.sort_by_difficulty,
            max_steps=cfg.max_steps, backend=cfg.backend,
            integrator=cfg.integrator, event_interp=cfg.event_interp,
            two_pass=cfg.two_pass, pass1_steps=cfg.pass1_steps,
            formulation=cfg.formulation, precision=cfg.precision,
            progress=cfg.progress)
    fa = res.final_alpha.reshape(rows, width).to(torch.float32)
    wind = torch.clamp(res.n_half_orbits, 0, cfg.winding_max).to(
        torch.int32).reshape(rows, width)
    if use_tb and height > rows:
        bottom = height - rows   # rows mirrored from the top
        fa = torch.cat([fa, fa[:bottom].flip(0)])
        wind = torch.cat([wind, wind[:bottom].flip(0)])
    return fa, wind.to(torch.uint16), res.n_steps, rows * width


def render_panorama(scene: SceneConfig, source_pano, resolution=None,
                    cfg: RenderConfig = RenderConfig(),
                    winding_overlay=False, mesh=None,
                    device="cuda") -> PanoOutput:
    """Full 360-degree lensed panorama of an equirect source sky.

    `resolution` defaults to the source sky's (H, W) (2:1 for a standard
    equirect frame). Stages: load_image, precompute (chart and trace),
    render (the theta chart and the gather), each timed with the device
    synchronised. `mesh=` raises (not ported).
    """
    _no_mesh(mesh, "render_panorama")
    metric = scene.metric()
    timer = StageTimer(device)
    if resolution is None:
        resolution = source_pano.shape[:2]
    resolution = (int(resolution[0]), int(resolution[1]))
    height, width = resolution
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs,
                                    device=device)

    with timer.stage("load_image"):
        img = torch.as_tensor(source_pano, device=device)
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) / 255.0
    with timer.stage("precompute"):
        fa, wind, steps, traced = _pano_precompute(scene, cfg, resolution,
                                                   device=device)
    with timer.stage("render"):
        _, theta_r = build_pano_lookups(
            resolution, psi=scene.psi,
            dtype=_dtype_of(cfg) if scene.boosted else fa.dtype,
            boost=scene.boost if scene.boosted else None, device=device)
        pano = render_pano_image(img, fa, wind, psi=scene.psi,
                                 theta_lookup=theta_r, sampling=cfg.sampling,
                                 winding_overlay=winding_overlay)
    timings = timer.finish()
    timings.setdefault("build_lookup", 0.0)
    return PanoOutput(pano, fa, wind, alpha_crit, height * width, traced,
                      steps, timings, scene, cfg)
