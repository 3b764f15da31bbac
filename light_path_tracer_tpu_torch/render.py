"""Lensed-image renderer: lookup tables -> output image.

The PyTorch counterpart of `light_path_tracer_tpu.render` for the lensed
render, a gather over the whole grid in plain PyTorch (the JAX package
runs it outside any Pallas kernel too):
  * NaN final_alpha (captured/invalid rays) stays black: the shadow.
  * Escaped rays with final_alpha > pi/2 get a winding-number colour from
    the 5-entry palette (WINDING_COLORS), clipped to its range; grayscale
    sources use the luma projection.
  * Escaped rays with final_alpha <= pi/2 reconstruct the source direction
    in the (d, e_x, e_y) frame and project back through the pinhole;
    out-of-bounds or behind-camera pixels become the magenta sentinel, or
    wrap modulo the image with render_loop_around (where behind-camera
    rays sample the image-centre pixel, as the reference does).

Precision: sin/cos of the lookups are taken in the lookup dtype, then the
frame products, the projection, `rint` and the bilinear weights in
float64 on the device. That is what the JAX package computes under x64,
where its float64 NumPy frame vectors promote the products (how its
tests run), so both renderers pick the same texels from the same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch.camera import focal_lengths, psi_frame

WINDING_COLORS = np.array([
    [0.0, 0.2, 1.0],   # blue
    [0.0, 0.7, 1.0],   # sky blue
    [0.0, 1.0, 0.4],   # green
    [1.0, 1.0, 0.0],   # yellow
    [1.0, 0.4, 0.0],   # orange
], dtype=np.float32)

_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)

_I32_MIN, _I32_MAX = -2.0**31, 2.0**31 - 1


def _to_i32(x):
    """float -> int32 with saturation, as XLA converts out-of-range
    values (a bare cast of such values is undefined)."""
    return torch.clamp(x, _I32_MIN, _I32_MAX).to(torch.int32)


def _palette(channels: int, grayscale: bool, device):
    """Winding palette as (5, C) float32 (luma column for grayscale)."""
    if grayscale:
        pal = (WINDING_COLORS @ _LUMA)[:, None]
    elif channels < 3:
        pal = WINDING_COLORS[:, :channels]
    elif channels > 3:
        pal = np.concatenate(
            [WINDING_COLORS,
             np.ones((len(WINDING_COLORS), channels - 3), np.float32)],
            axis=1)
    else:
        pal = WINDING_COLORS
    return torch.as_tensor(np.ascontiguousarray(pal), device=device)


def _bilinear_gather(src_flat, px, py, height, width, wrap):
    """Bilinear texture fetch at continuous (float64) source coordinates.

    Texel i's centre sits at coordinate i (the nearest rule is rint), so
    the unit cell is [i, i+1) with weight px - floor(px). wrap=True wraps
    corners modulo the image, otherwise they clamp to the edge. The blend
    runs in float64 and rounds once to the source dtype.
    """
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    tx = (px - x0f)[..., None]
    ty = (py - y0f)[..., None]
    x0 = _to_i32(x0f).to(torch.int64)
    y0 = _to_i32(y0f).to(torch.int64)

    def at(yy, xx):
        if wrap:
            yy, xx = torch.remainder(yy, height), torch.remainder(xx, width)
        else:
            yy = torch.clamp(yy, 0, height - 1)
            xx = torch.clamp(xx, 0, width - 1)
        return src_flat[yy * width + xx].to(torch.float64)

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    return (top * (1.0 - ty) + bot * ty).to(src_flat.dtype)


def _render_core(source_image, theta_lookup, final_alpha_lookup,
                 winding_lookup, d, e_x, e_y, image_dimension, fov,
                 render_loop_around, sampling="nearest"):
    """Renderer body: (H, W[, C]) source and (H, W) tables on one device
    -> (H, W[, C]) image in the source's dtype. d, e_x, e_y: the camera
    frame's float64 NumPy vectors."""
    if sampling not in ("nearest", "bilinear"):
        raise ValueError(f"sampling must be 'nearest' or 'bilinear', got "
                         f"{sampling!r}")
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    device = final_alpha_lookup.device

    grayscale = source_image.dim() == 2
    channels = 1 if grayscale else int(source_image.shape[2])
    src = source_image[..., None] if grayscale else source_image
    compute_dtype = final_alpha_lookup.dtype

    valid = torch.isfinite(final_alpha_lookup)
    fa = torch.where(valid, final_alpha_lookup,
                     torch.zeros_like(final_alpha_lookup))
    th = theta_lookup.to(compute_dtype)

    winding_mask = valid & (final_alpha_lookup > np.pi / 2)
    escaped_mask = valid & (final_alpha_lookup <= np.pi / 2)

    # -- winding colour layer --
    w_idx = torch.clamp(winding_lookup.to(torch.int64), 0,
                        len(WINDING_COLORS) - 1)
    winding_rgb = _palette(channels, grayscale, device)[w_idx]

    # -- escaped layer: source-direction reconstruction + pinhole gather --
    f64 = torch.float64
    sin_fa, cos_fa = torch.sin(fa).to(f64), torch.cos(fa).to(f64)
    sin_th, cos_th = torch.sin(th).to(f64), torch.cos(th).to(f64)
    d, e_x, e_y = ([float(c) for c in v] for v in (d, e_x, e_y))
    sx = sin_th * e_x[0] + cos_th * e_y[0]
    sy = sin_th * e_x[1] + cos_th * e_y[1]
    sz = sin_th * e_x[2] + cos_th * e_y[2]
    src_vx = cos_fa * d[0] + sin_fa * sx
    src_vy = cos_fa * d[1] + sin_fa * sy
    src_vz = cos_fa * d[2] + sin_fa * sz

    front = src_vz > 1e-12
    vz_safe = torch.where(front, src_vz, torch.ones_like(src_vz))
    x_cam = src_vx / vz_safe
    y_cam = src_vy / vz_safe
    if render_loop_around:
        # Behind-camera rays project with x_cam = y_cam = 0, i.e. they
        # sample the image-centre pixel.
        x_cam = torch.where(front, x_cam, torch.zeros_like(x_cam))
        y_cam = torch.where(front, y_cam, torch.zeros_like(y_cam))
    px = x_cam * fx + width / 2
    py = y_cam * fy + height / 2
    src_x = _to_i32(torch.round(px))
    src_y = _to_i32(torch.round(py))
    if render_loop_around:
        src_x = torch.remainder(src_x, width)
        src_y = torch.remainder(src_y, height)
        in_bounds = torch.ones_like(front)
    else:
        in_bounds = (front & (src_y >= 0) & (src_y < height)
                     & (src_x >= 0) & (src_x < width))

    src_flat = src.reshape(height * width, channels)
    if sampling == "bilinear":
        # The in_bounds/sentinel classification stays the nearest rule.
        texture = _bilinear_gather(src_flat, px, py, height, width,
                                   render_loop_around)
    else:
        flat_idx = (torch.clamp(src_y, 0, height - 1).to(torch.int64) * width
                    + torch.clamp(src_x, 0, width - 1).to(torch.int64))
        texture = src_flat[flat_idx]

    # Magenta sentinel: R = 1 (plus B = 1 with >= 3 channels); 1.0 for
    # grayscale.
    magenta = np.zeros((channels,), dtype=np.float32)
    magenta[0] = 1.0
    if channels > 2:
        magenta[2] = 1.0
    magenta_px = torch.as_tensor(magenta, device=device).to(src.dtype)

    escaped_rgb = torch.where(in_bounds[..., None], texture, magenta_px)
    out = torch.zeros(escaped_rgb.shape, dtype=src.dtype, device=device)
    out = torch.where(winding_mask[..., None], winding_rgb.to(src.dtype),
                      out)
    out = torch.where(escaped_mask[..., None], escaped_rgb, out)
    return out[..., 0] if grayscale else out


def render_lensed_image(source_image, alpha_lookup, final_alpha_lookup,
                        winding_lookup, alpha_crit, fov,
                        render_loop_around=False, psi=(0.0, 0.0),
                        theta_lookup=None, sampling="nearest"):
    """Render the lensed output image from precomputed lookup tables.

    Signature of the JAX package's (alpha_lookup and alpha_crit are
    accepted for compatibility). The tables and the source lie on one
    device; theta is built from the camera grids in the final-alpha
    dtype unless `theta_lookup` is supplied. sampling: "nearest" or
    "bilinear".
    """
    from light_path_tracer_tpu_torch.camera import build_theta_lookup
    height, width = source_image.shape[:2]
    device = final_alpha_lookup.device
    if theta_lookup is None:
        theta_lookup = build_theta_lookup(
            (height, width), fov, psi=psi, dtype=final_alpha_lookup.dtype,
            device=device)
    if winding_lookup is None:
        winding_lookup = torch.zeros((height, width), dtype=torch.int32,
                                     device=device)
    frame = psi_frame(psi)
    return _render_core(torch.as_tensor(source_image, device=device),
                        theta_lookup, final_alpha_lookup, winding_lookup,
                        frame.d, frame.e_x, frame.e_y, (height, width),
                        tuple(fov), bool(render_loop_around), str(sampling))
