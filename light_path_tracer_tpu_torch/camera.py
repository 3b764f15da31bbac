"""Pinhole camera model with off-axis black hole (psi offset).

The conventions of `light_path_tracer_tpu.camera`: every pixel coordinate
pair is (y, x); every FOV pair is (horizontal, vertical); camera axes are
+x right, +y down, +z forward.

The scalar frame math (psi -> BH direction + tangent screen basis) runs
on the host in float64 NumPy. The per-pixel grids are built on the
requested device in float64 and rounded once to the requested dtype, so a
float32 grid is the correctly rounded float64 one. (The JAX package's
float32 grids promote to float64 through its NumPy scalars whenever x64
is enabled, which is how its tests run; that is the reference here.)

A camera boost (the moving observer's aberration, `aberrate_view`, and
its Doppler factor, `doppler_lookup`) keeps the JAX package's split: the
Lorentz factor and |beta|^2 are Python floats, the grids float64 tensors
rounded once. Alpha rounding (`decimals`) is not ported and raises.

The run-time camera of the sequences (`psi_frame_dynamic`,
`aberrate_view_dynamic`, `build_angle_lookups_dynamic`) computes in the
trace dtype throughout, as the JAX package's traced-psi variants do: the
frame from the pointing's sin and cos in that dtype, the view grids, the
Lorentz factor and the arccos and arctan2 all in it. It has no
axis-refine band and no mirror fold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from light_path_tracer_tpu_torch.operands import kernel_operand


class PsiFrame(NamedTuple):
    d: np.ndarray     # BH direction in camera coords (3,)
    e_x: np.ndarray   # screen-tangent basis, aligns with +x image axis
    e_y: np.ndarray   # screen-tangent basis, aligns with +y image axis
    in_front: bool


def psi_to_bh_direction(psi):
    """psi = (pitch_up, yaw_right) [rad] -> BH unit direction in camera
    coords. psi_y > 0 moves the BH up (-y)."""
    psi_y, psi_x = psi
    sin_pitch, cos_pitch = np.sin(psi_y), np.cos(psi_y)
    sin_yaw, cos_yaw = np.sin(psi_x), np.cos(psi_x)
    return np.array([sin_yaw * cos_pitch, -sin_pitch, cos_yaw * cos_pitch],
                    dtype=np.float64)


def psi_frame(psi) -> PsiFrame:
    """Gram-Schmidt tangent basis around the BH direction; e_x/e_y align
    with the image axes at psi = 0."""
    d = psi_to_bh_direction(psi)
    in_front = bool(d[2] > 1e-12)

    cam_x = np.array([1.0, 0.0, 0.0])
    cam_y = np.array([0.0, 1.0, 0.0])

    e_x = cam_x - np.dot(cam_x, d) * d
    e_x_norm = np.linalg.norm(e_x)
    if e_x_norm < 1e-12:
        e_x = cam_y - np.dot(cam_y, d) * d
        e_x_norm = np.linalg.norm(e_x)
    e_x = e_x / max(e_x_norm, 1e-12)

    e_y = cam_y - np.dot(cam_y, d) * d - np.dot(cam_y, e_x) * e_x
    e_y_norm = np.linalg.norm(e_y)
    if e_y_norm < 1e-12:
        e_y = np.cross(d, e_x)
        e_y_norm = np.linalg.norm(e_y)
    e_y = e_y / max(e_y_norm, 1e-12)

    return PsiFrame(d, e_x, e_y, in_front)


def psi_to_cam_projection(psi):
    """BH direction projected onto the pinhole plane.
    Returns (y_cam, x_cam, in_front)."""
    frame = psi_frame(psi)
    if not frame.in_front:
        return (np.nan, np.nan, False)
    d = frame.d
    return (float(d[1] / d[2]), float(d[0] / d[2]), True)


def focal_lengths(image_dimension, fov):
    """(fx, fy) of the pinhole model; (y, x) / (h, v) conventions."""
    height, width = image_dimension
    horizontal_fov, vertical_fov = fov
    fx = (width / 2) / np.tan(horizontal_fov / 2)
    fy = (height / 2) / np.tan(vertical_fov / 2)
    return float(fx), float(fy)


def fov_from_vertical(vertical_fov, image_dimension):
    """(horizontal, vertical) FOV from the vertical FOV and aspect ratio."""
    height, width = image_dimension
    horizontal = 2.0 * np.arctan(np.tan(vertical_fov / 2) * width / height)
    return (float(horizontal), float(vertical_fov))


def _boosted(boost) -> bool:
    return boost is not None and any(float(b) != 0.0 for b in boost)


def _reject_unported(decimals=None):
    if decimals is not None:
        raise NotImplementedError(
            "alpha rounding (decimals) is not ported: the dedup it fed "
            "was retired in the JAX package")


# ---- relativistic aberration (observer at finite velocity) ----

def aberrate_view(vx, vy, vz, boost):
    """Special-relativistic aberration of unit view directions (observer
    toward sky), moving-camera frame -> static frame, batched over tensors
    that broadcast together.

    `boost`: the camera's 3-velocity in units of c in camera coordinates
    (+x right, +y down, +z forward), |boost| < 1. The photon propagates
    along -v, so k' = -v goes through the propagation-vector map

        k = (k'/gamma + (1 - 1/gamma)(bhat.k') bhat + beta) / (1 + beta.k')

    and is renormalised. Flying toward the hole spreads camera directions
    outward in the static frame: the shadow looks smaller. gamma and
    |beta|^2 are Python floats, as in the JAX package.
    """
    bx, by, bz = (float(boost[0]), float(boost[1]), float(boost[2]))
    b2 = bx * bx + by * by + bz * bz
    if b2 >= 1.0:
        raise ValueError("|boost| must be < 1 (units of c)")
    if b2 == 0.0:
        return vx, vy, vz
    gamma = 1.0 / np.sqrt(1.0 - b2)
    kx, ky, kz = -vx, -vy, -vz
    bdotk = bx * kx + by * ky + bz * kz
    coef = (1.0 - 1.0 / gamma) / b2 * bdotk
    denom = 1.0 + bdotk
    kx = (kx / gamma + coef * bx + bx) / denom
    ky = (ky / gamma + coef * by + by) / denom
    kz = (kz / gamma + coef * bz + bz) / denom
    n = torch.sqrt(kx * kx + ky * ky + kz * kz)
    return -kx / n, -ky / n, -kz / n


def _view_grids(image_dimension, fov, device, pixel_offset=(0.0, 0.0)):
    """Unit view-direction component grids (vx, vy, vz), float64, each
    (H, W)."""
    x_cam, y_cam = _cam_grids(image_dimension, fov, device, pixel_offset)
    return _view_at(x_cam[None, :], y_cam[:, None])


def _view_at(x_cam, y_cam):
    """Unit view directions at camera-plane points (float64 tensors that
    broadcast together), broadcast to their common shape."""
    denom = torch.sqrt(1.0 + x_cam ** 2 + y_cam ** 2)
    vx, vy, vz = x_cam / denom, y_cam / denom, 1.0 / denom
    return torch.broadcast_tensors(vx, vy, vz)


def doppler_lookup(image_dimension, fov, boost, dtype=torch.float32,
                   pixel_offset=(0.0, 0.0), device="cuda"):
    """Per-pixel Doppler factor delta = nu_cam / nu_static, (H, W):
    gamma (1 + beta . v_static) with v_static the pixel's aberrated view
    direction. Looking along the motion gives sqrt((1 + b) / (1 - b));
    intensities scale as delta^4, blackbody temperatures as delta."""
    bx, by, bz = (float(boost[0]), float(boost[1]), float(boost[2]))
    b2 = bx * bx + by * by + bz * bz
    vx, vy, vz = _view_grids(image_dimension, fov, device, pixel_offset)
    if b2 == 0.0:
        return torch.ones(vx.shape, dtype=dtype, device=vx.device)
    gamma = 1.0 / np.sqrt(1.0 - b2)
    vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    return (gamma * (1.0 + bx * vx + by * vy + bz * vz)).to(dtype)


# ---- batched per-pixel grids (float64 on the device) ----

def _cam_grids(image_dimension, fov, device, pixel_offset=(0.0, 0.0)):
    """Normalized camera-plane coordinate grids (float64); `pixel_offset`
    = (dy, dx) subpixel shift in pixels."""
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    oy, ox = pixel_offset
    f64 = dict(dtype=torch.float64, device=device)
    x_cam = (torch.arange(width, **f64) - width / 2 + ox) / fx
    y_cam = (torch.arange(height, **f64) - height / 2 + oy) / fy
    return x_cam, y_cam


def _alpha_at(x_cam, y_cam, psi, boost=None):
    """Viewing angle to the BH direction at camera-plane points (float64
    tensors that broadcast together); a boost aberrates the view
    directions into the static frame first."""
    d = psi_frame(psi).d
    if _boosted(boost):
        vx, vy, vz = aberrate_view(*_view_at(x_cam, y_cam), boost)
        cos_alpha = vx * float(d[0]) + vy * float(d[1]) + vz * float(d[2])
    else:
        denom = torch.sqrt(1.0 + x_cam ** 2 + y_cam ** 2)
        cos_alpha = (x_cam * float(d[0]) + y_cam * float(d[1])
                     + float(d[2])) / denom
    return torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))


def _theta_at(x_cam, y_cam, psi, boost=None):
    """Screen azimuth about the BH direction at camera-plane points
    (float64 tensors that broadcast together), of the aberrated view
    directions under a boost."""
    frame = psi_frame(psi)
    e_x = [float(c) for c in frame.e_x]
    e_y = [float(c) for c in frame.e_y]
    denom = torch.sqrt(1.0 + x_cam ** 2 + y_cam ** 2)
    vx, vy, vz = x_cam / denom, y_cam / denom, 1.0 / denom
    if _boosted(boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    return torch.arctan2(
        vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
        vx * e_y[0] + vy * e_y[1] + vz * e_y[2],
    )


def build_alpha_lookup(image_dimension, fov, decimals=None, psi=(0.0, 0.0),
                       dtype=torch.float32, pixel_offset=(0.0, 0.0),
                       boost=None, device="cuda"):
    """Per-pixel viewing angle alpha to the BH direction, (H, W); `boost`
    (camera 3-velocity, units of c) aberrates each view direction into
    the static frame first (aberrate_view)."""
    _reject_unported(decimals)
    x_cam, y_cam = _cam_grids(image_dimension, fov, device, pixel_offset)
    return _alpha_at(x_cam[None, :], y_cam[:, None], psi, boost).to(dtype)


def build_theta_lookup(image_dimension, fov, psi=(0.0, 0.0),
                       dtype=torch.float32, pixel_offset=(0.0, 0.0),
                       boost=None, device="cuda"):
    """Per-pixel screen azimuth theta about the BH direction, (H, W);
    `boost` as in build_alpha_lookup."""
    x_cam, y_cam = _cam_grids(image_dimension, fov, device, pixel_offset)
    return _theta_at(x_cam[None, :], y_cam[:, None], psi, boost).to(dtype)


def pixel_angles_at(py, px, image_dimension, fov, psi=(0.0, 0.0),
                    dtype=torch.float32, pixel_offset=(0.0, 0.0),
                    boost=None):
    """Batched (alpha, theta) at arbitrary pixel coordinates.

    `py`/`px`: integer or float tensors of pixel rows and columns on one
    device; returns (alpha, theta) of their shape in `dtype` on that
    device. The grid builders' own maths (_alpha_at, _theta_at) in
    float64 at scattered pixels instead of the whole grid, so each value
    equals the grid's at its pixel (the adaptive-AA refinement traces
    extra samples only at edge pixels). `boost` as in build_alpha_lookup.
    """
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    oy, ox = pixel_offset
    x_cam = (torch.as_tensor(px).to(torch.float64) - width / 2 + ox) / fx
    y_cam = (torch.as_tensor(py).to(torch.float64) - height / 2 + oy) / fy
    return (_alpha_at(x_cam, y_cam, psi, boost).to(dtype),
            _theta_at(x_cam, y_cam, psi, boost).to(dtype))


def axis_refine_columns(image_dimension, fov, psi=(0.0, 0.0),
                        refine_frac=0.07, boost=None, device="cuda"):
    """Boolean (W,) mask of columns near the BH's screen column, where
    tighter integrator tolerances are used (refine_frac of the widest
    column offset). Under a boost the band is measured in the static
    frame, where the near-axis rays live: each column's centre-row view
    direction is aberrated before its offset from the BH's column is
    taken."""
    height, width = image_dimension
    fx, _fy = focal_lengths(image_dimension, fov)
    x_cam = (np.arange(width) - width / 2) / fx
    _bh_y, bh_x_cam, in_front = psi_to_cam_projection(psi)
    if not in_front:
        return torch.zeros(width, dtype=torch.bool, device=device)
    if _boosted(boost):
        denom = np.sqrt(1.0 + x_cam ** 2)
        f64 = dict(dtype=torch.float64, device=device)
        vx = torch.as_tensor(x_cam / denom, **f64)
        wx, _wy, wz = aberrate_view(vx, torch.zeros_like(vx),
                                    torch.as_tensor(1.0 / denom, **f64),
                                    boost)
        x_rel = wx / torch.clamp(wz, min=1e-12) - bh_x_cam
        x_abs_max = torch.clamp(torch.max(torch.abs(x_rel)), min=1e-12)
        return torch.abs(x_rel) <= refine_frac * x_abs_max
    x_rel = x_cam - bh_x_cam
    x_abs_max = max(float(np.max(np.abs(x_rel))), 1e-12)
    return torch.as_tensor(np.abs(x_rel) <= refine_frac * x_abs_max,
                           device=device)


# ---- run-time psi and boost (the sequences: no mirror fold, no band) ----

def _norm3(v):
    return torch.sqrt(torch.sum(v * v))


def psi_frame_dynamic(psi_y, psi_x, dtype=torch.float32):
    """psi_frame computed in `dtype`: (d, e_x, e_y) as (3,) CPU tensors,
    the Gram-Schmidt basis of the JAX package's psi_frame_dynamic with
    its fallbacks selected where the norms fall below 1e-12."""
    f = dict(dtype=dtype)
    py, px = torch.tensor(float(psi_y), **f), torch.tensor(float(psi_x), **f)
    sin_p, cos_p = torch.sin(py), torch.cos(py)
    sin_yw, cos_yw = torch.sin(px), torch.cos(px)
    d = torch.stack([sin_yw * cos_p, -sin_p, cos_yw * cos_p])
    cam_x = torch.tensor([1.0, 0.0, 0.0], **f)
    cam_y = torch.tensor([0.0, 1.0, 0.0], **f)

    e_x = cam_x - torch.dot(cam_x, d) * d
    e_x_alt = cam_y - torch.dot(cam_y, d) * d
    e_x = torch.where(_norm3(e_x) < 1e-12, e_x_alt, e_x)
    e_x = e_x / torch.clamp(_norm3(e_x), min=1e-12)

    e_y = cam_y - torch.dot(cam_y, d) * d - torch.dot(cam_y, e_x) * e_x
    e_y = torch.where(_norm3(e_y) < 1e-12, torch.linalg.cross(d, e_x), e_y)
    e_y = e_y / torch.clamp(_norm3(e_y), min=1e-12)
    return d, e_x, e_y


def aberrate_view_dynamic(vx, vy, vz, bx, by, bz):
    """aberrate_view with the boost's scalars in the grids' dtype (the
    flyby's per-frame boost): |b|^2, the Lorentz factor and the
    projection coefficient are formed in that dtype, with the 0/0 of the
    bhat projection guarded (tiny 1e-30), and b = 0 is the identity. |b|
    >= 1 is not checked here; callers validate first."""
    f = dict(dtype=vx.dtype)
    bx, by, bz = (torch.tensor(float(b), **f) for b in (bx, by, bz))
    b2 = bx * bx + by * by + bz * bz
    if float(b2) == 0.0:
        return vx, vy, vz
    tiny = torch.tensor(1e-30, **f)
    gamma = 1.0 / torch.sqrt(torch.maximum(1.0 - b2, tiny))
    c = (1.0 - 1.0 / gamma) / torch.maximum(b2, tiny)
    bx, by, bz, c = (float(x) for x in (bx, by, bz, c))
    g = kernel_operand(float(gamma), vx)
    kx, ky, kz = -vx, -vy, -vz
    bdotk = bx * kx + by * ky + bz * kz
    coef = c * bdotk
    denom = 1.0 + bdotk
    akx = (kx / g + coef * bx + bx) / denom
    aky = (ky / g + coef * by + by) / denom
    akz = (kz / g + coef * bz + bz) / denom
    n = torch.sqrt(akx * akx + aky * aky + akz * akz)
    return -akx / n, -aky / n, -akz / n


def _view_grids_in(image_dimension, fov, dtype, device):
    """Unit view-direction grids (vx, vy, vz), each (H, W), computed in
    `dtype` on `device` (the sequences' grids)."""
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    f = dict(dtype=dtype, device=device)
    x_cam = torch.arange(width, **f) - width / 2
    y_cam = torch.arange(height, **f) - height / 2
    x_cam = (x_cam / kernel_operand(fx, x_cam))[None, :]
    y_cam = (y_cam / kernel_operand(fy, y_cam))[:, None]
    denom = torch.sqrt(1.0 + x_cam ** 2 + y_cam ** 2)
    return torch.broadcast_tensors(x_cam / denom, y_cam / denom,
                                   1.0 / denom)


def build_angle_lookups_dynamic(image_dimension, fov, psi_y, psi_x,
                                dtype=torch.float32, boost=None,
                                boost_dynamic=None, device="cuda"):
    """(alpha, theta) per-pixel grids, (H, W) each, of a sequence frame
    pointed at (psi_y, psi_x), computed in `dtype` on `device`. `boost`
    (one per sequence) aberrates the views as aberrate_view does;
    `boost_dynamic` = (bx, by, bz) of this frame through
    aberrate_view_dynamic instead (flybys)."""
    d, e_x, e_y = ([float(c) for c in v]
                   for v in psi_frame_dynamic(psi_y, psi_x, dtype))
    vx, vy, vz = _view_grids_in(image_dimension, fov, dtype, device)
    if boost_dynamic is not None:
        vx, vy, vz = aberrate_view_dynamic(vx, vy, vz, *boost_dynamic)
    elif _boosted(boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    cos_alpha = vx * d[0] + vy * d[1] + vz * d[2]
    alpha = torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))
    theta = torch.arctan2(vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
                          vx * e_y[0] + vy * e_y[1] + vz * e_y[2])
    return alpha.to(dtype), theta.to(dtype)
