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
    corners modulo the image, otherwise they clamp to the edge; a
    (wrap_y, wrap_x) pair sets each axis (the equirect panorama wraps in
    longitude and clamps at the poles). The blend runs in float64 and
    rounds once to the source dtype.
    """
    wrap_y, wrap_x = wrap if isinstance(wrap, tuple) else (wrap, wrap)
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    tx = (px - x0f)[..., None]
    ty = (py - y0f)[..., None]
    x0 = _to_i32(x0f).to(torch.int64)
    y0 = _to_i32(y0f).to(torch.int64)

    def at(yy, xx):
        yy = (torch.remainder(yy, height) if wrap_y
              else torch.clamp(yy, 0, height - 1))
        xx = (torch.remainder(xx, width) if wrap_x
              else torch.clamp(xx, 0, width - 1))
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


# ---- photon-ring layers and the lens-map products ----
#
# The counterparts of light_path_tracer_tpu.render's map products, in
# plain PyTorch on the tables' device: they gather, difference and
# deposit the traced maps, and the JAX package runs them outside any
# Pallas kernel too. Each works in the dtype of its input maps; the
# camera frame enters as Python floats (the JAX package's frame arrays
# in that dtype round them alike).


def ring_labels(max_order: int):
    """Layer labels in ring_decomposition's order: orders 0..max_order-1,
    then ">= max_order", then the shadow."""
    return ([f"order_{k}" for k in range(max_order)]
            + [f"order_ge_{max_order}", "shadow"])


def ring_decomposition(final_alpha, winding, max_order: int = 3):
    """Separate an image by photon-ring order (winding half-orbits).

    Returns (masks (max_order + 2, H, W) bool: orders 0..max_order-1,
    ">= max_order", the shadow; composite (H, W, 3) float32: the shadow
    black, the direct image light gray, order k the winding palette's
    entry k - 1)."""
    fa = torch.as_tensor(final_alpha)
    w = torch.as_tensor(winding, device=fa.device).to(torch.int32)
    escaped = ~torch.isnan(fa)
    masks = [escaped & (w == k) for k in range(max_order)]
    masks.append(escaped & (w >= max_order))
    masks.append(~escaped)
    masks = torch.stack(masks)

    h, wd = fa.shape
    composite = torch.zeros((h, wd, 3), dtype=torch.float32,
                            device=fa.device)
    direct = torch.tensor([0.85, 0.85, 0.85], dtype=torch.float32,
                          device=fa.device)
    composite = torch.where(masks[0][..., None], direct, composite)
    palette = torch.as_tensor(WINDING_COLORS, device=fa.device)
    for k in range(1, max_order + 1):
        color = palette[min(k - 1, len(WINDING_COLORS) - 1)]
        composite = torch.where(masks[k][..., None], color, composite)
    return masks, composite


def _frame_floats(frame):
    return tuple([float(c) for c in v] for v in (frame.d, frame.e_x,
                                                 frame.e_y))


def escape_directions(final_alpha_lookup, theta_lookup, frame):
    """Per-pixel escape unit vectors (camera coordinates) from the
    (final_alpha, theta) chart in the (d, e_x, e_y) frame, for every
    escaped ray of any winding; NaN where captured or invalid."""
    fa = final_alpha_lookup
    th = theta_lookup.to(fa.dtype)
    d, e_x, e_y = _frame_floats(frame)
    sin_fa, cos_fa = torch.sin(fa), torch.cos(fa)
    sin_th, cos_th = torch.sin(th), torch.cos(th)
    sx = sin_th * e_x[0] + cos_th * e_y[0]
    sy = sin_th * e_x[1] + cos_th * e_y[1]
    sz = sin_th * e_x[2] + cos_th * e_y[2]
    return (cos_fa * d[0] + sin_fa * sx,
            cos_fa * d[1] + sin_fa * sy,
            cos_fa * d[2] + sin_fa * sz)


def _view_grids_as(image_dimension, fov, dtype, device):
    """The pinhole unit view directions (vx, vy, vz), each (H, W) in
    `dtype` (camera._view_grids' float64 grids rounded once)."""
    from light_path_tracer_tpu_torch.camera import _view_grids
    return tuple(v.to(dtype) for v in _view_grids(image_dimension, fov,
                                                  device))


def _solid_angle_element(vx, vy, vz):
    """Signed celestial solid-angle element |dv/di x dv/dj| . v per pixel
    of a unit-vector field, by central differences (one-sided at the
    grid edges, as torch.gradient and jnp.gradient both take them)."""
    dvx_i, dvx_j = torch.gradient(vx)
    dvy_i, dvy_j = torch.gradient(vy)
    dvz_i, dvz_j = torch.gradient(vz)
    cx = dvy_i * dvz_j - dvz_i * dvy_j
    cy = dvz_i * dvx_j - dvx_i * dvz_j
    cz = dvx_i * dvy_j - dvy_i * dvx_j
    return cx * vx + cy * vy + cz * vz


def _signed_floor(a):
    """a with |a| floored at 1e-30, keeping its sign (0 reads +)."""
    tiny = torch.full_like(a, 1e-30)
    return torch.where(torch.abs(a) < 1e-30,
                       torch.where(a < 0, -tiny, tiny), a)


def magnification_map(final_alpha_lookup, theta_lookup, frame,
                      image_dimension, fov):
    """Signed per-pixel magnification of the celestial lens map: the
    solid-angle ratio (du_i x du_j).u / (dv_i x dv_j).v of the pinhole
    view directions u and the escape directions v, both by central
    differences (mu < 0: parity-flipped images; |mu| -> inf on the
    critical curves; mu -> 1 far from the hole). Returns (H, W)
    float32, NaN where the ray was captured (the 1-px rim around the
    shadow inherits NaN from the stencil)."""
    vx, vy, vz = escape_directions(final_alpha_lookup, theta_lookup,
                                   frame)
    ux, uy, uz = _view_grids_as(image_dimension, fov,
                                final_alpha_lookup.dtype, vx.device)
    a_img = _solid_angle_element(ux, uy, uz)
    a_src = _solid_angle_element(vx, vy, vz)
    mu = (a_img / _signed_floor(a_src)).to(torch.float32)
    return torch.where(torch.isfinite(final_alpha_lookup), mu,
                       torch.full_like(mu, float("nan")))


def _tangent_chart(vx, vy, vz, frame):
    """Gnomonic coordinates ((v.e_x)/(v.d), (v.e_y)/(v.d)) of directions
    v about the frame's d; NaN where v.d <= 1e-12."""
    d, e_x, e_y = _frame_floats(frame)
    vd = vx * d[0] + vy * d[1] + vz * d[2]
    front = vd > 1e-12
    vd_safe = torch.where(front, vd, torch.ones_like(vd))
    nan = torch.full_like(vd, float("nan"))
    return (torch.where(front,
                        (vx * e_x[0] + vy * e_x[1] + vz * e_x[2]) / vd_safe,
                        nan),
            torch.where(front,
                        (vx * e_y[0] + vy * e_y[1] + vz * e_y[2]) / vd_safe,
                        nan))


def _source_plane_coords(final_alpha_lookup, theta_lookup, frame):
    """Per-pixel gnomonic source coordinates about the BH direction from
    the collapsed (final_alpha, theta) chart; NaN where captured or in
    the back hemisphere."""
    return _tangent_chart(*escape_directions(final_alpha_lookup,
                                             theta_lookup, frame), frame)


def _escape_velocity(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi):
    """BH-centred Cartesian coordinate velocity of the raw state at the
    escape sphere r_e, through the metric's own contravariant
    components (p_t = -1)."""
    r_b = torch.full_like(theta_f, float(r_e))
    g_tt, g_tphi, g_rr, g_thth, g_phiphi = metric._inv_terms(
        r_b, theta_f, float(metric.M), float(metric.a))
    dr = g_rr * p_r_f
    dth = g_thth * p_th_f
    dphi = g_tphi * -1.0 + g_phiphi * xi
    sin_th, cos_th = torch.sin(theta_f), torch.cos(theta_f)
    sin_ph, cos_ph = torch.sin(phi_f), torch.cos(phi_f)
    vx = (sin_th * cos_ph * dr + r_e * cos_th * cos_ph * dth
          - r_e * sin_th * sin_ph * dphi)
    vy = (sin_th * sin_ph * dr + r_e * cos_th * sin_ph * dth
          + r_e * sin_th * cos_ph * dphi)
    vz = cos_th * dr - r_e * sin_th * dth
    return vx, vy, vz, (sin_th, cos_th, sin_ph, cos_ph)


def world_escape_beta(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi,
                      escaped, theta_obs):
    """Side-exact gnomonic source coordinates from the raw escape state:
    the escape vector rebuilt at r_e and projected on the observer's
    BH-centred screen basis d = -r_hat(theta_obs), e_x = +phi_hat,
    e_y = -theta_hat. Returns (bx, by), NaN where not escaped or outside
    the front-hemisphere tangent chart."""
    r_e = float(r_e)
    vx, vy, vz, _trig = _escape_velocity(metric, r_e, theta_f, phi_f,
                                         p_r_f, p_th_f, xi)
    obs = torch.full((), float(theta_obs), dtype=theta_f.dtype,
                     device=theta_f.device)
    so, co = torch.sin(obs), torch.cos(obs)
    vd = -(so * vx + co * vz)
    vex = vy
    vey = -co * vx + so * vz
    ok = escaped & (vd > 1e-12) & torch.isfinite(vd)
    nan = torch.full_like(vd, float("nan"))
    vd_safe = torch.where(ok, vd, torch.ones_like(vd))
    return (torch.where(ok, vex / vd_safe, nan),
            torch.where(ok, vey / vd_safe, nan))


def image_gnomonic_grids(image_dimension, fov, psi=(0.0, 0.0),
                         dtype=torch.float32, boost=None, device="cuda"):
    """Per-pixel image-plane gnomonic coordinates about the BH direction
    of the pinhole view directions (aberrated by `boost`): the unlensed
    counterpart of the source chart. NaN behind the tangent chart."""
    from light_path_tracer_tpu_torch.camera import aberrate_view
    vx, vy, vz = _view_grids_as(image_dimension, fov, dtype, device)
    if boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    return _tangent_chart(vx, vy, vz, psi_frame(psi))


def lens_jacobian_decomposition(bx, by, xb, yb):
    """Convergence, shear and rotation maps of the traced lens map:
    A = dbeta/dx = [[1 - kappa - gamma1, -gamma2 + omega],
                    [-gamma2 - omega, 1 - kappa + gamma1]]
    with A = (dbeta/dpixel) (dx/dpixel)^-1, both pixel Jacobians by
    central differences (one-sided at the edges, NaN within one pixel of
    the shadow). Returns (kappa, gamma1, gamma2, omega), each (H, W)."""
    dbx_dpy, dbx_dpx = torch.gradient(bx)
    dby_dpy, dby_dpx = torch.gradient(by)
    dxb_dpy, dxb_dpx = torch.gradient(xb)
    dyb_dpy, dyb_dpx = torch.gradient(yb)
    safe = _signed_floor(dxb_dpx * dyb_dpy - dxb_dpy * dyb_dpx)
    # A = B X^-1, X^-1 = adj(X) / det(X).
    a11 = (dbx_dpx * dyb_dpy - dbx_dpy * dyb_dpx) / safe
    a12 = (dbx_dpy * dxb_dpx - dbx_dpx * dxb_dpy) / safe
    a21 = (dby_dpx * dyb_dpy - dby_dpy * dyb_dpx) / safe
    a22 = (dby_dpy * dxb_dpx - dby_dpx * dxb_dpy) / safe
    kappa = 1.0 - (a11 + a22) / 2.0
    gamma1 = -(a11 - a22) / 2.0
    gamma2 = -(a12 + a21) / 2.0
    omega = (a21 - a12) / 2.0
    return kappa, gamma1, gamma2, omega


def fermat_tau(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi, t_hit,
               escaped):
    """Plane-wave-referenced (Fermat) arrival time per ray: the
    coordinate time at the escape sphere minus X.v_hat (X the escape
    position, v the escape coordinate velocity); differences between
    rays imaging one source position are the physical delays. NaN where
    not escaped."""
    r_e = float(r_e)
    vx, vy, vz, (sin_th, cos_th, sin_ph, cos_ph) = _escape_velocity(
        metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi)
    v_safe = torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz),
                         min=1e-30)
    xdotv = r_e * (sin_th * cos_ph * vx + sin_th * sin_ph * vy
                   + cos_th * vz) / v_safe
    return torch.where(escaped, t_hit - xdotv,
                       torch.full_like(xdotv, float("nan")))


def _image_solid_angle(image_dimension, fov, dtype, device):
    """|image-plane solid angle| per pixel of the pinhole view grid."""
    return torch.abs(_solid_angle_element(
        *_view_grids_as(image_dimension, fov, dtype, device)))


def source_plane_map(bx, by, image_dimension, fov, beta_max,
                     bins: int = 256):
    """Source-plane magnification (caustic) map by inverse ray shooting:
    each escaped pixel's image-plane solid angle, deposited cloud-in-cell
    on a bins x bins grid of the gnomonic source chart (index_add_; on a
    CUDA tensor the atomic adds sum in no fixed order), over each bin's
    exact gnomonic solid angle dbx dby / (1 + bx^2 + by^2)^(3/2) at its
    centre. Returns (A (bins, bins) float32, row i = beta_y, column j =
    beta_x; extent (-beta_max, beta_max))."""
    dtype, device = bx.dtype, bx.device
    a_img = _image_solid_angle(image_dimension, fov, dtype, device)
    width = 2.0 * beta_max / bins
    fx = (bx + beta_max) / width - 0.5
    fy = (by + beta_max) / width - 0.5
    ix0 = torch.floor(fx)
    iy0 = torch.floor(fy)
    tx = fx - ix0
    ty = fy - iy0
    finite = torch.isfinite(bx) & torch.isfinite(by)
    acc = torch.zeros(bins * bins, dtype=dtype, device=device)
    for dy_, dx_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
        gx = ix0 + dx_
        gy = iy0 + dy_
        wgt = (tx if dx_ else 1.0 - tx) * (ty if dy_ else 1.0 - ty)
        valid = (finite & (gx >= 0) & (gx < bins)
                 & (gy >= 0) & (gy < bins))
        flat = torch.where(valid, gy * bins + gx,
                           torch.zeros_like(gx)).to(torch.int64)
        w = torch.where(valid, a_img * wgt, torch.zeros_like(wgt))
        acc.index_add_(0, flat.reshape(-1), w.reshape(-1))
    acc = acc.reshape(bins, bins)
    centers = ((torch.arange(bins, dtype=dtype, device=device) + 0.5)
               * width - beta_max)
    cx = centers[None, :]
    cy = centers[:, None]
    d_omega = width * width / (1.0 + cx * cx + cy * cy) ** 1.5
    return (acc / d_omega).to(torch.float32), (-beta_max, beta_max)


# Track positions a broadcast of microlens_light_curve takes at once.
_TRACK_CHUNK = 16


def microlens_light_curve(bx, by, image_dimension, fov, track,
                          source_radius):
    """Total magnification A(t) of a finite circular source moving along
    `track` ((T, 2) source positions (beta_x, beta_y), radians): the
    image-plane solid angle landing within a Gaussian-tapered source
    disk (sigma = radius / 2, cut at the radius), over the window's
    source-plane integral, the arrivals weighed by the gnomonic Jacobian
    (1 + beta^2)^(3/2). The track runs in chunks of _TRACK_CHUNK
    positions, each one broadcast over the grid. Returns (T,) float32."""
    dtype, device = bx.dtype, bx.device
    a_img = _image_solid_angle(image_dimension, fov, dtype, device)
    valid = torch.isfinite(bx) & torch.isfinite(by)
    far = torch.full_like(bx, 1e6)
    bx = torch.where(valid, bx, far)
    by = torch.where(valid, by, far)
    jac = (1.0 + bx * bx + by * by) ** 1.5
    w_img = torch.where(valid, a_img * jac,
                        torch.zeros_like(jac)).reshape(-1)
    bx = bx.reshape(-1)
    by = by.reshape(-1)

    track = torch.as_tensor(np.asarray(track), dtype=dtype, device=device)
    r = torch.full((), float(source_radius), dtype=dtype, device=device)
    sigma = r / 2.0
    norm = 2.0 * np.pi * sigma * sigma * (
        1.0 - torch.exp(-(r * r) / (2.0 * sigma * sigma)))
    curve = []
    for pos in track.split(_TRACK_CHUNK):
        dx = bx[None, :] - pos[:, :1]
        dy = by[None, :] - pos[:, 1:]
        d2 = dx * dx + dy * dy
        win = torch.where(d2 <= r * r,
                          torch.exp(-d2 / (2.0 * sigma * sigma)),
                          torch.zeros_like(d2))
        curve.append((w_img[None, :] * win).sum(dim=1) / norm)
    return torch.cat(curve).to(torch.float32)


def magnification_display(mu, clip_percentile: float = 99.5):
    """Display encoding of a signed magnification map: sign(mu)
    log10(1 + |mu|), clipped at the `clip_percentile` of its magnitude,
    on the RdBu_r colour table (utils/color.py), the shadow (NaN) black.
    Returns (H, W, 3) float64 RGB in NumPy."""
    from light_path_tracer_tpu_torch.utils.color import colormap
    mu_np = np.asarray(torch.as_tensor(mu).cpu(), np.float64)
    disp = np.sign(mu_np) * np.log10(1.0 + np.abs(mu_np))
    finite = np.isfinite(disp)
    lim = (np.percentile(np.abs(disp[finite]), clip_percentile)
           if finite.any() else 1.0)
    if not np.isfinite(lim) or lim <= 0.0:
        lim = 1.0
    scaled = np.where(finite, disp, 0.0)
    rgb = colormap("RdBu_r", 0.5 * (np.clip(scaled / lim, -1.0, 1.0) + 1.0))
    rgb[~finite] = 0.0
    return rgb
