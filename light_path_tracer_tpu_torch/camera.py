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

A camera boost (aberration) and alpha rounding (`decimals`) are not
ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def _reject_unported(boost=None, decimals=None):
    if boost is not None and any(float(b) != 0.0 for b in boost):
        raise NotImplementedError(
            "camera boost (aberration) is not ported to the PyTorch "
            "package yet (ROADMAP.md, Queue 1)")
    if decimals is not None:
        raise NotImplementedError(
            "alpha rounding (decimals) is not ported: the dedup it fed "
            "was retired in the JAX package")


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


def _view_grids(image_dimension, fov, device, pixel_offset=(0.0, 0.0)):
    """Broadcast unit view-direction component grids (vx, vy, vz)."""
    x_cam, y_cam = _cam_grids(image_dimension, fov, device, pixel_offset)
    denom = torch.sqrt(1.0 + x_cam[None, :] ** 2 + y_cam[:, None] ** 2)
    vx = x_cam[None, :] / denom
    vy = y_cam[:, None] / denom
    vz = 1.0 / denom
    return vx, vy, vz


def build_alpha_lookup(image_dimension, fov, decimals=None, psi=(0.0, 0.0),
                       dtype=torch.float32, pixel_offset=(0.0, 0.0),
                       boost=None, device="cuda"):
    """Per-pixel viewing angle alpha to the BH direction, (H, W)."""
    _reject_unported(boost, decimals)
    x_cam, y_cam = _cam_grids(image_dimension, fov, device, pixel_offset)
    d = psi_frame(psi).d
    denom = torch.sqrt(1.0 + x_cam[None, :] ** 2 + y_cam[:, None] ** 2)
    cos_alpha = (x_cam[None, :] * float(d[0])
                 + y_cam[:, None] * float(d[1]) + float(d[2])) / denom
    alpha = torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))
    return alpha.to(dtype)


def build_theta_lookup(image_dimension, fov, psi=(0.0, 0.0),
                       dtype=torch.float32, pixel_offset=(0.0, 0.0),
                       boost=None, device="cuda"):
    """Per-pixel screen azimuth theta about the BH direction, (H, W)."""
    _reject_unported(boost)
    frame = psi_frame(psi)
    e_x = [float(c) for c in frame.e_x]
    e_y = [float(c) for c in frame.e_y]
    vx, vy, vz = _view_grids(image_dimension, fov, device, pixel_offset)
    theta = torch.arctan2(
        vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
        vx * e_y[0] + vy * e_y[1] + vz * e_y[2],
    )
    return theta.to(dtype)


def axis_refine_columns(image_dimension, fov, psi=(0.0, 0.0),
                        refine_frac=0.07, boost=None, device="cuda"):
    """Boolean (W,) mask of columns near the BH's screen column, where
    tighter integrator tolerances are used (refine_frac of the widest
    column offset)."""
    _reject_unported(boost)
    height, width = image_dimension
    fx, _fy = focal_lengths(image_dimension, fov)
    x_cam = (np.arange(width) - width / 2) / fx
    _bh_y, bh_x_cam, in_front = psi_to_cam_projection(psi)
    if not in_front:
        return torch.zeros(width, dtype=torch.bool, device=device)
    x_rel = x_cam - bh_x_cam
    x_abs_max = max(float(np.max(np.abs(x_rel))), 1e-12)
    return torch.as_tensor(np.abs(x_rel) <= refine_frac * x_abs_max,
                           device=device)
