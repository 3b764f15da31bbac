"""Image saving with stdlib only: colormap-index quantization and a small
8-bit grayscale PNG writer (zlib + struct), so a render can be saved where
neither matplotlib nor Pillow is installed."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def quantize_cmap_index(img):
    """[0,1] float gray image -> uint8 colormap index on the same device,
    with matplotlib's float quantization (clip(int(x * 256), 0, 255))."""
    return torch.clamp((img * 256.0).to(torch.int32), 0, 255).to(torch.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png_gray(path, pixels):
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG."""
    px = np.ascontiguousarray(np.asarray(pixels, dtype=np.uint8))
    if px.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got shape {px.shape}")
    height, width = px.shape
    # Each scanline starts with filter type 0 (None).
    raw = np.concatenate(
        [np.zeros((height, 1), np.uint8), px], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_chunk(b"IHDR", header))
        fh.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(_chunk(b"IEND", b""))


def save_gray_png(path, img):
    """Save a [0,1] gray image tensor (any device) as a PNG; the gray
    colormap maps index i to level i."""
    write_png_gray(path, quantize_cmap_index(img).cpu().numpy())
