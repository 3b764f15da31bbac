"""Image I/O with the standard library only (zlib + struct), so renders
can be loaded and saved where neither matplotlib nor Pillow is installed.

  * `quantize_cmap_index` / `save_gray_png`: the shadow save, with
    matplotlib's colormap-index quantization;
  * `quantize_u8` / `save_png`: the lensed-render save, with matplotlib's
    float -> uint8 rule for RGB(A) input, (clip(x, 0, 1) * 255) truncated;
  * `AFMHOT` / `save_afmhot_png`: the power-law disk save, matplotlib's
    afmhot colormap applied to the colormap index, then saved as RGB;
  * `save_gamma_png`: the blackbody disk save, clip(x, 0, 1)^(1/2.2)
    in NumPy on the host, saved as RGB;
  * `write_png` / `encode_png`: 8-bit gray, gray+alpha, RGB or RGBA PNG
    (to a file, or as bytes);
  * `read_png`: 8-bit non-interlaced gray, gray+alpha, RGB or RGBA PNG
    (a path or its bytes) ->
    float32 / 255, as `matplotlib.image.imread` returns a PNG (gray as
    (H, W), gray+alpha widened to RGBA, RGB(A) as (H, W, C)).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type by channel count, and back.
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def quantize_cmap_index(img):
    """[0,1] float gray image -> uint8 colormap index on the same device,
    with matplotlib's float quantization (clip(int(x * 256), 0, 255))."""
    return torch.clamp((img * 256.0).to(torch.int32), 0, 255).to(torch.uint8)


def quantize_u8(img):
    """[0,1] float image -> uint8 on the same device: clip, then truncate
    (matplotlib's conversion of float RGB(A) input)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def _afmhot_table():
    """matplotlib's afmhot, 256 entries: r = 2x, g = 2x - 1/2, b = 2x - 1
    at x = i / 255, clipped to [0, 1] (float64, (256, 3))."""
    x = np.linspace(0.0, 1.0, 256)
    return np.clip(np.stack([2.0 * x, 2.0 * x - 0.5, 2.0 * x - 1.0],
                            axis=1), 0.0, 1.0)


AFMHOT = _afmhot_table()


def save_afmhot_png(path, img):
    """Save an (H, W) [0,1] gray image tensor as an afmhot RGB PNG:
    colormap index (quantize_cmap_index), the afmhot entry, then the
    float -> uint8 truncation of an RGB save."""
    idx = quantize_cmap_index(img).cpu().numpy()
    write_png(path, (AFMHOT[idx] * 255).astype(np.uint8))


def save_gamma_png(path, img):
    """Save an (H, W, 3) linear-sRGB image tensor as an RGB PNG encoded
    with clip(x, 0, 1)^(1/2.2), in the image's dtype in NumPy on the host
    (a device pow could differ in the last ulp and flip a truncated
    level)."""
    arr = np.clip(img.cpu().numpy(), 0.0, 1.0) ** (1.0 / 2.2)
    write_png(path, (arr * 255).astype(np.uint8))


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(pixels) -> bytes:
    """An (H, W) or (H, W, C) uint8 array, C in 1..4, as the bytes of an
    8-bit PNG (gray, gray+alpha, RGB or RGBA)."""
    px = np.ascontiguousarray(np.asarray(pixels, dtype=np.uint8))
    if px.ndim == 2:
        px = px[..., None]
    if px.ndim != 3 or px.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"expected an (H, W) or (H, W, 1..4) image, got "
                         f"shape {px.shape}")
    height, width, channels = px.shape
    # Each scanline starts with filter type 0 (None).
    raw = np.concatenate([np.zeros((height, 1), np.uint8),
                          px.reshape(height, width * channels)],
                         axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8,
                         _COLOR_TYPE[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path, pixels):
    """Write an (H, W) or (H, W, C) uint8 array, C in 1..4, as an 8-bit
    PNG (gray, gray+alpha, RGB or RGBA)."""
    blob = encode_png(pixels)
    with open(path, "wb") as fh:
        fh.write(blob)


def save_gray_png(path, img):
    """Save an (H, W) [0,1] gray image tensor (any device) as a gray PNG;
    the gray colormap maps index i to level i."""
    write_png(path, quantize_cmap_index(img).cpu().numpy())


def save_png(path, img):
    """Save a float image tensor or array in [0, 1] (uint8 as is) as an
    8-bit PNG; the uint8 conversion runs on the tensor's device."""
    if isinstance(img, np.ndarray):
        arr = img if img.dtype == np.uint8 else (
            np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    else:
        arr = quantize_u8(img).cpu().numpy()
    write_png(path, arr)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int):
    """Undo the PNG scanline filters; returns (height, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = data.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:     # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:     # Up
            cur = (line + prev) & 255
        elif kind in (3, 4):
            cur = line.copy()
            for x in range(stride):
                left = int(cur[x - bpp]) if x >= bpp else 0
                up = int(prev[x])
                if kind == 3:   # Average
                    pred = (left + up) >> 1
                else:           # Paeth
                    ul = int(prev[x - bpp]) if x >= bpp else 0
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc
                            else up if pb <= pc else ul)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(source):
    """Read an 8-bit non-interlaced gray, gray+alpha, RGB or RGBA PNG as
    float32 in [0, 1]; `source` is a path or the file's bytes."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        blob, path = bytes(source), "the PNG bytes"
    else:
        path = source
        with open(path, "rb") as fh:
            blob = fh.read()
    if not blob.startswith(_SIGNATURE):
        if blob[:3] == b"\xff\xd8\xff":
            raise ValueError(
                f"{path} is a JPEG: this package reads PNG only (it needs "
                f"neither matplotlib nor Pillow); convert the image to PNG")
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color_type, _comp, _filt, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray, gray+alpha, RGB and "
            f"RGBA PNGs are read (bit depth {depth}, colour type "
            f"{color_type}, interlace {interlace})")
    channels = _CHANNELS[color_type]
    px = _unfilter(zlib.decompress(b"".join(idat)), height,
                   width * channels, channels)
    img = px.reshape(height, width, channels).astype(np.float32) / 255.0
    if channels == 1:
        return img[..., 0]
    if channels == 2:
        return np.concatenate([np.repeat(img[..., :1], 3, axis=2),
                               img[..., 1:]], axis=2)
    return img
