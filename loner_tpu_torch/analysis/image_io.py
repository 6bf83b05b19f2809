"""PNG files and the depth / intensity images of the offline renderer, with the
standard library and numpy only (the card's machine has neither PIL nor
matplotlib).

- ``write_png`` / ``read_png``: 8-bit gray, RGB and RGBA, with ``tEXt`` chunks;
  the reader undoes all five filter types, so it reads what other writers
  produce as well as these files.
- ``save_depth_png``: the pixels of ``plt.imsave(fname, depth, cmap="turbo")``
  (min / max normalisation in the input's dtype, matplotlib's 256-entry table
  indexed as its ``Colormap`` indexes, RGBA bytes); ``save_rgb_png``: those of
  the JAX package's ``_save_rgb_png`` (``imsave`` of the clipped intensities,
  through the gray table for one channel).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from loner_tpu_torch.analysis.turbo_colormap import TURBO_DATA

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """PNG bytes of a uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) image; each
    ``text`` item becomes a ``tEXt`` chunk (Latin-1 keyword and value)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes (H, W[, 1|3|4]) pixels, not {image.shape}")
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    out = [PNG_SIGNATURE, _chunk(b"IHDR", header)]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\x00" + value.encode("latin-1")))
    out += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")]
    return b"".join(out)


def write_png(path: str, image: np.ndarray, text: Optional[Dict[str, str]] = None) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(image, text))
    return path


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of 8-bit pixels."""
    stride = w * c
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = data[y, 0], data[y, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 2:
            row = (line + prev) & 0xFF
        elif kind == 1:
            row = (np.cumsum(line.reshape(w, c), axis=0) & 0xFF).reshape(stride)
        elif kind in (3, 4):
            # Average and Paeth read the reconstructed pixel to the left: one
            # pass a pixel, all channels at once.
            row = np.zeros(stride, np.int32)
            for x in range(0, stride, c):
                left = row[x - c:x] if x else np.zeros(c, np.int32)
                up = prev[x:x + c]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    up_left = prev[x - c:x] if x else np.zeros(c, np.int32)
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
                row[x:x + c] = (line[x:x + c] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prev = row
    return out.reshape(h, w, c)


def decode_png(data: bytes) -> Tuple[np.ndarray, Dict[str, str]]:
    """(pixels (H, W, C) uint8, tEXt items) of an 8-bit, non-interlaced gray, RGB
    or RGBA PNG."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, text, header = 8, [], {}, None
    while pos < len(data):
        (size,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + size]
        pos += 12 + size
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"tEXt":
            key, _, value = payload.partition(b"\x00")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[color]), text


def read_png(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 from gray, RGB or RGBA pixels (alpha dropped, as PIL's
    ``convert("RGB")``)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def _lut_bytes(colors: np.ndarray) -> np.ndarray:
    """A colormap's RGBA table as matplotlib's ``Colormap(bytes=True)`` takes it."""
    lut = np.ones((colors.shape[0], 4))
    lut[:, :3] = colors
    return (lut * 255).astype(np.uint8)


TURBO_LUT = _lut_bytes(np.asarray(TURBO_DATA, np.float64))
GRAY_LUT = _lut_bytes(np.repeat(np.linspace(0.0, 1.0, 256)[:, None], 3, axis=1))


def colormap_rgba(values: np.ndarray, lut: np.ndarray, vmin: Optional[float] = None,
                  vmax: Optional[float] = None) -> np.ndarray:
    """RGBA bytes of a 2-D array through a 256-entry table: matplotlib's
    ``Normalize`` (limits from the data unless given; arithmetic in the input's
    float dtype) and its ``Colormap`` indexing (x 256, the top edge into the
    last entry, truncated)."""
    x = np.array(values, dtype=np.result_type(np.asarray(values).dtype, np.float32))
    lo = x.min() if vmin is None else x.dtype.type(vmin)
    hi = x.max() if vmax is None else x.dtype.type(vmax)
    if lo == hi:
        x.fill(0)
    else:
        x -= lo
        x /= hi - lo
    n = lut.shape[0]
    x *= n
    x[x == n] = n - 1
    under, over = x < 0, x >= n
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    rgba = lut[np.clip(idx, 0, n - 1)]
    rgba[np.isnan(x)] = 0  # matplotlib's "bad" colour: transparent black
    return rgba


def save_depth_png(depth: np.ndarray, fname: str) -> str:
    """A depth (or any scalar) frame as a turbo-coloured RGBA PNG."""
    return write_png(fname, colormap_rgba(depth, TURBO_LUT))


def save_rgb_png(rgb: np.ndarray, fname: str) -> str:
    """Intensities in [0, 1] (clipped) as a PNG: one channel through the gray
    table at limits 0 and 1, three channels as RGB bytes (x 255, truncated)."""
    rgb = np.clip(rgb, 0.0, 1.0)
    if rgb.shape[-1] == 1:
        return write_png(fname, colormap_rgba(rgb[..., 0], GRAY_LUT, 0.0, 1.0))
    rgba = np.full(rgb.shape[:2] + (4,), 255, np.uint8)
    rgba[..., :3] = (rgb[..., :3] * 255).astype(np.uint8)
    return write_png(fname, rgba)
