"""Blackbody -> linear sRGB colour for the accretion-disk renderer.

The counterpart of `light_path_tracer_tpu.utils.color`. A Doppler- and
gravitationally shifted blackbody spectrum is exactly a blackbody at
T_obs = g T_em, so a disk element's observed chromaticity needs only the
shifted temperature: T_obs -> CIE XYZ (Planck spectrum x the CIE 1931
colour-matching functions, in the multi-lobe Gaussian fit of Wyman,
Sloan & Shirley, JCGT 2013) -> linear sRGB (IEC 61966-2-1), normalised
so the largest channel is 1.

The 256-entry log-spaced RGB(T) table is built once in float64 NumPy at
import, as the JAX package builds it; `blackbody_rgb` is then a
closed-form index, two gathers and a lerp in float32 on the tensor's
device.

`colormap` is the small colour table of the map products (the lens
maps' PNGs, written without matplotlib): RdBu_r (ColorBrewer's 11-class
RdBu, reversed), viridis and inferno, each as 9 or 11 anchors of the
published tables interpolated linearly. The maps' numbers are the
JAX package's; their colours follow these anchors, not matplotlib's
256-entry tables.
"""

from __future__ import annotations

import numpy as np
import torch

T_MIN, T_MAX, N_TABLE = 500.0, 60000.0, 256

# hc/k in nm K.
_HC_K = 1.43877688e7


def _piecewise_gauss(lam, alpha, mu, s1, s2):
    s = np.where(lam < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((lam - mu) * s) ** 2)


def _cmf(lam):
    """CIE 1931 2-degree (xbar, ybar, zbar), Wyman-Sloan-Shirley fit."""
    x = (_piecewise_gauss(lam, 1.056, 599.8, 0.0264, 0.0323)
         + _piecewise_gauss(lam, 0.362, 442.0, 0.0624, 0.0374)
         + _piecewise_gauss(lam, -0.065, 501.1, 0.0490, 0.0382))
    y = (_piecewise_gauss(lam, 0.821, 568.8, 0.0213, 0.0247)
         + _piecewise_gauss(lam, 0.286, 530.9, 0.0613, 0.0322))
    z = (_piecewise_gauss(lam, 1.217, 437.0, 0.0845, 0.0278)
         + _piecewise_gauss(lam, 0.681, 459.0, 0.0385, 0.0725))
    return x, y, z


# XYZ (D65 white) -> linear sRGB.
_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])


def _build_table():
    lam = np.linspace(380.0, 780.0, 201)            # nm
    xb, yb, zb = _cmf(lam)
    temps = np.geomspace(T_MIN, T_MAX, N_TABLE)
    # Relative spectral radiance; the scale divides out below.
    with np.errstate(over="ignore"):
        b = lam[None, :] ** -5.0 / np.expm1(
            _HC_K / (lam[None, :] * temps[:, None]))
    X = np.trapezoid(b * xb[None, :], lam, axis=1)
    Y = np.trapezoid(b * yb[None, :], lam, axis=1)
    Z = np.trapezoid(b * zb[None, :], lam, axis=1)
    rgb = (_XYZ_TO_SRGB @ np.stack([X, Y, Z])).T
    # Colour only (the physics supplies the intensity): luminance-
    # normalise, clip out-of-gamut negatives, largest channel = 1.
    rgb = np.maximum(rgb / np.maximum(Y[:, None], 1e-30), 0.0)
    rgb = rgb / np.maximum(rgb.max(axis=1, keepdims=True), 1e-30)
    return temps, rgb.astype(np.float32)


_TEMPS, _RGB_TABLE = _build_table()
_LOG_T = np.log(_TEMPS).astype(np.float32)


def blackbody_rgb(T):
    """Linear-sRGB chromaticity (largest channel 1) of a blackbody at
    temperature T [K], float32 (..., 3) on T's device; T outside
    [T_MIN, T_MAX] clamps. The table is log-spaced, so the index is
    closed-form."""
    T = torch.as_tensor(T)
    logt = torch.log(torch.clamp(T.to(torch.float32), T_MIN, T_MAX))
    log0 = torch.tensor(_LOG_T[0], device=T.device)
    step = torch.tensor((_LOG_T[-1] - _LOG_T[0]) / (N_TABLE - 1),
                        device=T.device)
    pos = torch.clamp((logt - log0) / step, 0.0, N_TABLE - 1.0)
    i0 = torch.clamp(pos.to(torch.int32), 0, N_TABLE - 2).to(torch.int64)
    frac = (pos - i0.to(pos.dtype))[..., None]
    table = torch.as_tensor(_RGB_TABLE, device=T.device)
    return table[i0] * (1.0 - frac) + table[i0 + 1] * frac


def blackbody_chromaticity(T: float):
    """CIE (x, y) chromaticity at temperature T (a test and diagnostic
    hook, host NumPy)."""
    lam = np.linspace(380.0, 780.0, 201)
    xb, yb, zb = _cmf(lam)
    with np.errstate(over="ignore"):
        b = lam ** -5.0 / np.expm1(_HC_K / (lam * T))
    X, Y, Z = (np.trapezoid(b * c, lam) for c in (xb, yb, zb))
    s = X + Y + Z
    return float(X / s), float(Y / s)


# Anchors (0-255 RGB) of the map colour tables, evenly spaced on [0, 1].
_COLOR_TABLES = {
    "RdBu_r": ((5, 48, 97), (33, 102, 172), (67, 147, 195), (146, 197, 222),
               (209, 229, 240), (247, 247, 247), (253, 219, 199),
               (244, 165, 130), (214, 96, 77), (178, 24, 43),
               (103, 0, 31)),
    "viridis": ((68, 1, 84), (71, 45, 123), (59, 82, 139), (44, 114, 142),
                (33, 145, 140), (40, 174, 128), (94, 201, 98),
                (173, 220, 48), (253, 231, 37)),
    "inferno": ((0, 0, 4), (31, 12, 72), (85, 15, 109), (136, 34, 106),
                (186, 54, 85), (227, 89, 51), (249, 142, 9), (248, 201, 50),
                (252, 255, 164)),
}


def colormap(name: str, x):
    """The colour table `name` ("RdBu_r", "viridis" or "inferno") at
    x in [0, 1] (clipped): (..., 3) float64 RGB in [0, 1] in NumPy."""
    if name not in _COLOR_TABLES:
        raise ValueError(f"no colour table {name!r}; expected one of "
                         f"{', '.join(_COLOR_TABLES)}")
    anchors = np.asarray(_COLOR_TABLES[name], np.float64) / 255.0
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    at = np.linspace(0.0, 1.0, len(anchors))
    return np.stack([np.interp(x, at, anchors[:, c]) for c in range(3)],
                    axis=-1)
