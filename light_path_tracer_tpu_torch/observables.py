"""Interferometric and astrometric observables of rendered images.

The counterpart of `light_path_tracer_tpu.observables`. A radio
interferometer samples an image's 2-D Fourier transform, the complex
visibility V(u, v) = sum I(l, m) exp(-2 pi i (u l + v m)), on baselines
(u, v) in wavelengths (cycles per radian of sky angle):

* `visibilities(image, fov)`: flux-normalised V on the FFT baseline grid,
  with the camera's tangent-plane pixel scale 2 tan(fov / 2) / N;
* `radial_profile`: |V| averaged over azimuth against baseline length;
* `first_null`: the baseline of the first deep minimum (host NumPy);
* `ring_diameter_from_null` / `disk_diameter_from_null`: the null
  inverted through a thin ring (|J0|, first zero 2.404826) or a uniform
  disk (|2 J1(x) / x|, first zero 3.831706);
* `shadow_diameter`: image -> profile -> null -> angular diameter;
* `visibility_at` and `closure_phase`: the direct transform at given
  baselines and the phase of the bispectrum on a baseline triangle;
* `centroid_track`: the intensity-weighted photocentre of each frame.

Everything runs in PyTorch on the image's device (`torch.fft`); NumPy
images go to the CPU. The transforms are complex128, the baseline grids
float64, as the JAX package computes them with x64.
"""

from __future__ import annotations

import numpy as np
import torch

from light_path_tracer_tpu_torch.camera import focal_lengths

__all__ = ["intensity", "pixel_scales", "centroid_track", "visibilities",
           "radial_profile", "first_null", "ring_diameter_from_null",
           "disk_diameter_from_null", "shadow_diameter", "visibility_at",
           "closure_phase"]

# First zeros of J0 and J1: the visibility nulls of a thin ring and of a
# uniform disk of angular diameter d sit at b = j0_1 / (pi d), j1_1 / (pi d).
_J0_FIRST_ZERO = 2.404825557695773
_J1_FIRST_ZERO = 3.8317059702075125

_LUMA = (0.299, 0.587, 0.114)


def _tensor(image):
    return image if isinstance(image, torch.Tensor) else torch.as_tensor(
        np.asarray(image))


def _luma(img):
    return img @ torch.tensor(_LUMA, dtype=img.dtype, device=img.device)


def intensity(image):
    """(H, W) intensity of an (H, W[, 3]) image: RGB through the luma
    weights render.py uses for grayscale sources."""
    img = _tensor(image)
    return _luma(img) if img.dim() == 3 else img


def pixel_scales(shape, fov):
    """Tangent-plane (dm, dl) [rad/pixel] of an (H, W) image with camera
    FOV (horizontal, vertical), from the camera's own focal lengths."""
    fx, fy = focal_lengths(shape, fov)
    return 1.0 / fy, 1.0 / fx


def centroid_track(frames, fov):
    """Intensity-weighted photocentre of each frame (radians): (T, 2) for
    (T, H, W[, 3]) frames, (2,) for one image, columns (x, y) in the
    camera's tangent coordinates (x = (col - W/2) / fx, y = (row - H/2) /
    fy). Use raw emission, not tone-mapped frames."""
    img = _tensor(frames)
    if img.dim() >= 3 and img.shape[-1] == 3:
        img = _luma(img)
    single = img.dim() == 2
    if single:
        img = img[None]
    _t, height, width = img.shape
    fx, fy = focal_lengths((height, width), fov)
    t = dict(dtype=img.dtype, device=img.device)
    x = (torch.arange(width, **t) - width / 2.0) / fx
    y = (torch.arange(height, **t) - height / 2.0) / fy
    flux = torch.clamp(img.sum(dim=(1, 2)), min=1e-300)
    cx = (img * x[None, None, :]).sum(dim=(1, 2)) / flux
    cy = (img * y[None, :, None]).sum(dim=(1, 2)) / flux
    track = torch.stack([cx, cy], dim=-1)
    return track[0] if single else track


def _fftfreq(n, d, device):
    """The FFT's sample frequencies in float64, divided as jnp.fft.fftfreq
    divides them (k / (d n); torch.fft.fftfreq rounds otherwise, which
    moves grid baselines across the profile's bin edges)."""
    f64 = dict(dtype=torch.float64, device=device)
    k = torch.remainder(torch.arange(n, **f64) + n // 2, n) - n // 2
    return k / torch.tensor(d * n, **f64)


def visibilities(image, fov, pad: int = 4):
    """Complex visibility on the FFT baseline grid.

    image: (H, W) or (H, W, 3) nonnegative brightness; fov: (horizontal,
    vertical) in radians; pad: the zero-padding factor (finer sampling of
    the same visibility, to locate nulls between coarse bins). Returns
    (vis (pH, pW) complex128, flux-normalised so the centre is 1, phase
    referred to the image centre; u (pW,), v (pH,) float64 baselines in
    wavelengths, ascending).
    """
    img = intensity(image)
    height, width = img.shape
    dm, dl = pixel_scales((height, width), fov)
    ph, pw = int(height * pad), int(width * pad)
    dev = img.device

    total = img.sum()
    norm = torch.where(total > 0, total, torch.ones_like(total))
    spec = torch.fft.fftshift(torch.fft.fft2(img / norm, s=(ph, pw)))
    u = torch.fft.fftshift(_fftfreq(pw, dl, dev))
    v = torch.fft.fftshift(_fftfreq(ph, dm, dev))
    cy, cx = height / 2.0, width / 2.0
    phase = torch.exp(2j * np.pi * (u[None, :] * dl * cx
                                    + v[:, None] * dm * cy))
    return spec.to(torch.complex128) * phase, u, v


def radial_profile(vis, u, v, n_bins: int = 0):
    """|V| averaged over azimuth against baseline length: (baselines
    (n_bins,), amp (n_bins,)), amp 0 in bins with no sample (only beyond
    the grid's corner radius); n_bins 0 means half the larger side."""
    amp2d = torch.abs(vis)
    b = torch.sqrt(u[None, :] ** 2 + v[:, None] ** 2).reshape(-1)
    b_max = float(min(torch.abs(u).max(), torch.abs(v).max()))
    if n_bins <= 0:
        n_bins = max(vis.shape) // 2
    # jnp.linspace's edges, i (b_max / n) with b_max last
    edges = torch.arange(n_bins + 1, dtype=torch.float64,
                         device=vis.device) * (b_max / n_bins)
    edges[-1] = b_max
    idx = torch.clamp(torch.searchsorted(edges, b, right=True) - 1, 0,
                      n_bins - 1)
    w = (b <= b_max).to(amp2d.dtype)
    sums = torch.zeros(n_bins, dtype=amp2d.dtype, device=vis.device)
    counts = torch.zeros_like(sums)
    sums.index_add_(0, idx, amp2d.reshape(-1) * w)
    counts.index_add_(0, idx, w)
    amp = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                      torch.zeros_like(sums))
    return 0.5 * (edges[:-1] + edges[1:]), amp


def first_null(baselines, amp):
    """Baseline of the first local minimum after the central peak,
    parabola-refined; NaN if the profile never turns up again (host
    NumPy)."""
    b = np.asarray(torch.as_tensor(baselines).cpu(), dtype=np.float64)
    a = np.asarray(torch.as_tensor(amp).cpu(), dtype=np.float64)
    interior = (a[1:-1] <= a[:-2]) & (a[1:-1] < a[2:])
    idxs = np.nonzero(interior)[0] + 1
    if idxs.size == 0:
        return float("nan")
    i = int(idxs[0])
    denom = a[i - 1] - 2 * a[i] + a[i + 1]
    if denom <= 0:
        return float(b[i])
    shift = 0.5 * (a[i - 1] - a[i + 1]) / denom
    db = b[1] - b[0]
    return float(b[i] + np.clip(shift, -1, 1) * db)


def ring_diameter_from_null(b_null):
    """Angular diameter [rad] of a thin ring with its first |V| null at
    baseline b_null [wavelengths]: j0_1 / (pi b)."""
    return _J0_FIRST_ZERO / (np.pi * b_null)


def disk_diameter_from_null(b_null):
    """Angular diameter [rad] of a uniform disk with its first |V| null
    at baseline b_null [wavelengths]: j1_1 / (pi b)."""
    return _J1_FIRST_ZERO / (np.pi * b_null)


def shadow_diameter(image, fov, model: str = "disk", pad: int = 4,
                    n_bins: int = 0):
    """A source's angular diameter from its visibility null: model "disk"
    (a filled shadow) or "ring" (a photon-ring image). Returns
    (diameter_rad, b_null, (baselines, amp))."""
    invert = {"disk": disk_diameter_from_null,
              "ring": ring_diameter_from_null}
    if model not in invert:
        raise ValueError(f"model must be 'disk' or 'ring', got {model!r}")
    vis, u, v = visibilities(image, fov, pad=pad)
    baselines, amp = radial_profile(vis, u, v, n_bins=n_bins)
    b_null = first_null(baselines, amp)
    return invert[model](b_null), b_null, (baselines, amp)


def visibility_at(image, fov, uv_points):
    """Complex visibility at (K, 2) baselines (u, v) [wavelengths] by the
    direct transform, flux-normalised and phase-referred to the image
    centre like `visibilities`; returns (K,) complex128."""
    img = intensity(image)
    height, width = img.shape
    dm, dl = pixel_scales((height, width), fov)
    f64 = dict(dtype=torch.float64, device=img.device)
    l = (torch.arange(width, **f64) - width / 2.0) * dl
    m = (torch.arange(height, **f64) - height / 2.0) * dm
    uv = torch.atleast_2d(torch.as_tensor(np.asarray(uv_points), **f64))
    total = img.sum()
    norm = torch.where(total > 0, total, torch.ones_like(total))
    phase = (uv[:, 0][:, None, None] * l[None, None, :]
             + uv[:, 1][:, None, None] * m[None, :, None])
    kern = torch.exp(-2j * np.pi * phase)
    return (kern * (img / norm).to(torch.float64)[None]).sum(dim=(1, 2))


def closure_phase(image, fov, b1, b2):
    """Closure phase [rad] on the baseline triangle (b1, b2, -(b1 + b2)):
    the argument of the bispectrum V(b1) V(b2) V(b3). 0 for a point
    source, 0 or pi for a centro-symmetric one."""
    b1 = np.asarray(b1, np.float64)
    b2 = np.asarray(b2, np.float64)
    v = visibility_at(image, fov, np.stack([b1, b2, -(b1 + b2)]))
    return float(torch.angle(v[0] * v[1] * v[2]))
