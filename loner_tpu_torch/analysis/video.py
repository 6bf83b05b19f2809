"""MJPEG-in-AVI video with the standard library and numpy: a baseline JPEG
encoder of the port's own and the RIFF/AVI container.

Counterpart of ``loner_tpu/analysis/video.py``, which encodes its frames with
PIL; the card's machine has no PIL, so ``encode_jpeg`` writes baseline JFIF
itself, as libjpeg does at its defaults:

- libjpeg's quality scaling of the Annex K quantisation tables (the DQT bytes
  of PIL's ``save(quality=q)``), written in zigzag order, one DQT a table;
- libjpeg's fixed-point RGB -> YCbCr, 4:2:0 chroma (2 x 2 means with libjpeg's
  alternating rounding bias), edges replicated to whole 16 x 16 MCUs;
- an 8 x 8 DCT-II in float64 and quantisation rounded half away from zero
  (libjpeg's integer DCT rounds inside; a decoded frame differs from PIL's own
  JPEG by well under a level on average);
- the Annex K Huffman tables, not optimised. The block stage (colour, DCT,
  quantisation, zigzag) and the entropy coder's symbols and bit packing are
  numpy array operations: no Python loop over blocks or coefficients.

The container is the JAX package's byte layout:

    RIFF('AVI ') LIST('hdrl' avih LIST('strl' strh(vids/MJPG) strf))
                 LIST('movi' '00dc' <jpeg> ...) idx1
"""
from __future__ import annotations

import struct
from typing import List, Sequence, Tuple, Union

import numpy as np

from loner_tpu_torch.analysis.image_io import read_png, to_rgb

__all__ = ["encode_jpeg", "write_mjpeg_avi", "read_avi_frame_count", "extract_first_jpeg"]

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010

# -- JPEG tables (ITU T.81 Annex K) --------------------------------------------
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QUANT = np.full(64, 99)
CHROMA_QUANT.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                                      [47, 66, 99, 99]]

DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "243362728209"
    "0a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# Zigzag: position k of the scan -> row-major index in the 8 x 8 block.
ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, (i % 8) if (i // 8 + i % 8) % 2 == 0 else (i // 8))))

_u = np.arange(8)
DCT = np.sqrt(np.where(_u == 0, 1.0, 2.0) / 8.0)[:, None] * np.cos(
    (2 * _u[None, :] + 1) * _u[:, None] * np.pi / 16)  # orthonormal DCT-II rows


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` and baseline clamp of an Annex K table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of each symbol 0-255 of a (bits, values) table, canonical."""
    bits, values = table
    codes, lengths = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            codes[values[k]], lengths[values[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths


_HUFFMAN = [(_huffman_codes(dc), _huffman_codes(ac))
            for dc, ac in ((DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA))]
_POW2 = 1 << np.arange(16)


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG's size category of each value and its extra bits."""
    size = np.searchsorted(_POW2, np.abs(v), side="right")
    return size, np.where(v >= 0, v, v + (1 << size) - 1)


def _ycbcr(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libjpeg's fixed-point colour conversion (16 fraction bits)."""
    def fix(x: float) -> int:
        return int(x * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _blocks(plane: np.ndarray, mh: int, mw: int, per_mcu: int) -> np.ndarray:
    """(MH, MW, per_mcu, 8, 8) blocks of a plane in MCU order (per_mcu 4: the
    2 x 2 luminance blocks of a 16 x 16 MCU, row by row)."""
    if per_mcu == 4:
        return plane.reshape(mh, 2, 8, mw, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(
            mh, mw, 4, 8, 8)
    return plane.reshape(mh, 8, mw, 8).transpose(0, 2, 1, 3)[:, :, None]


def _entropy_code(coefs: np.ndarray, table_of_block: np.ndarray) -> bytes:
    """Huffman-coded scan data (byte-stuffed, padded with 1 bits) of zigzag
    quantised blocks (N, 64) whose DC is already differenced."""
    n = coefs.shape[0]
    vals, lens, keys = [], [], []

    def emit(key, code_len, extra_size, extra):
        code, length = code_len
        vals.append((code << extra_size) | extra)
        lens.append(length + extra_size)
        keys.append(key)

    blk = np.arange(n)
    dc_size, dc_bits = _magnitude(coefs[:, 0])
    ac = coefs[:, 1:]
    nz_blk, nz_pos = np.nonzero(ac)
    first = np.ones(nz_blk.shape, bool)
    first[1:] = nz_blk[1:] != nz_blk[:-1]
    prev = np.where(first, -1, np.roll(nz_pos, 1))
    run = nz_pos - prev - 1
    size, bits = _magnitude(ac[nz_blk, nz_pos])
    last = np.full(n, -1)
    last[nz_blk] = nz_pos  # nonzeros come in order: the last write is the last one
    eob = blk[last < 62]
    for t in (0, 1):  # luminance, chrominance tables
        (dc_codes, dc_lens), (ac_codes, ac_lens) = _HUFFMAN[t]
        m = table_of_block == t
        emit(blk[m] * 256, (dc_codes[dc_size[m]], dc_lens[dc_size[m]]), dc_size[m], dc_bits[m])
        k = m[nz_blk]
        kb, kp, kr = nz_blk[k], nz_pos[k], run[k]
        for j in range(3):  # runs of 16 zeros before a coefficient (ZRL)
            z = kr >= 16 * (j + 1)
            emit(kb[z] * 256 + 2 + 4 * kp[z] + j,
                 (np.full(z.sum(), ac_codes[0xF0]), np.full(z.sum(), ac_lens[0xF0])), 0, 0)
        sym = ((kr % 16) << 4) | size[k]
        emit(kb * 256 + 2 + 4 * kp + 3, (ac_codes[sym], ac_lens[sym]), size[k], bits[k])
        e = eob[table_of_block[eob] == t]
        emit(e * 256 + 254, (np.full(e.size, ac_codes[0]), np.full(e.size, ac_lens[0])), 0, 0)
    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals).astype(np.int64)[order]
    length = np.concatenate(lens).astype(np.int64)[order]
    # Bit packing: each symbol's bits, most significant first.
    total = int(length.sum())
    owner = np.repeat(np.arange(val.size), length)
    k = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    stream = ((val[owner] >> (length[owner] - 1 - k)) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones((-total) % 8, np.uint8)])
    data = np.packbits(stream)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def encode_jpeg(frame: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JFIF bytes of an (H, W[, 1|3|4]) frame (uint8, or float in [0, 1]),
    as the JAX package's ``_encode_jpeg`` prepares it: gray repeated to RGB,
    alpha dropped; 4:2:0 YCbCr."""
    arr = np.asarray(frame)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    rgb = to_rgb(arr)
    h, w = rgb.shape[:2]
    mh, mw = -(-h // 16), -(-w // 16)
    rgb = np.pad(rgb, ((0, mh * 16 - h), (0, mw * 16 - w), (0, 0)), mode="edge")
    y, cb, cr = _ycbcr(rgb)
    bias = np.tile([1, 2], mw * 4)  # libjpeg's h2v2 rounding, alternating by column
    cb, cr = (((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]) + bias) >> 2
              for p in (cb, cr))
    blocks = np.concatenate([_blocks(y, mh, mw, 4), _blocks(cb, mh, mw, 1),
                             _blocks(cr, mh, mw, 1)], axis=2).reshape(-1, 8, 8)
    table_of_block = np.tile([0, 0, 0, 0, 1, 1], mh * mw)
    component = np.tile([0, 0, 0, 0, 1, 2], mh * mw)
    tables = np.stack([quant_table(LUMA_QUANT, quality), quant_table(CHROMA_QUANT, quality)])
    coef = DCT @ (blocks - 128.0) @ DCT.T
    q = tables[table_of_block].reshape(-1, 8, 8)
    quant = (np.sign(coef) * np.floor(np.abs(coef) / q + 0.5)).astype(np.int64)
    zz = quant.reshape(-1, 64)[:, ZIGZAG]
    for c in range(3):  # DC as differences within each component, in scan order
        m = component == c
        dc = zz[m, 0]
        zz[m, 0] = dc - np.concatenate([[0], dc[:-1]])
    scan = _entropy_code(zz, table_of_block)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in (0, 1):
        out.append(_segment(0xDB, bytes([t]) + tables[t][ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, t, (bits, values) in ((0, 0, DC_LUMA), (1, 0, AC_LUMA), (0, 1, DC_CHROMA),
                                   (1, 1, AC_CHROMA)):
        out.append(_segment(0xC4, bytes([cls << 4 | t]) + bytes(bits) + bytes(values)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def _load_frame(frame: Union[str, np.ndarray]) -> np.ndarray:
    if isinstance(frame, str):
        return to_rgb(read_png(frame)[0])
    return np.asarray(frame)


def write_mjpeg_avi(path: str, frames: Sequence[Union[str, np.ndarray]], fps: int = 10,
                    quality: int = 90) -> str:
    """Assemble ``frames`` (PNG paths, or (H, W[, 1|3|4]) arrays, uint8 or float in
    [0, 1]) of one resolution into an MJPEG .avi at ``path``; a frame of another
    resolution raises. Returns ``path``."""
    if not frames:
        raise ValueError("write_mjpeg_avi: no frames")
    height, width = _load_frame(frames[0]).shape[:2]
    jpegs: List[bytes] = []
    for f in frames:
        arr = _load_frame(f)
        if arr.shape[:2] != (height, width):
            raise ValueError(f"frame resolution {arr.shape[:2]} != first frame {(height, width)}")
        jpegs.append(encode_jpeg(arr, quality))
    n = len(jpegs)
    max_bytes = max(len(j) for j in jpegs)

    # movi payload and idx1 (offsets from the 'movi' fourcc).
    movi = bytearray(b"movi")
    idx = bytearray()
    for j in jpegs:
        offset = len(movi)
        movi += b"00dc" + struct.pack("<I", len(j)) + j
        if len(j) % 2:
            movi += b"\x00"
        idx += b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, offset, len(j))

    avih = struct.pack("<IIIIIIIIIIIIII", int(1_000_000 / max(fps, 1)), max_bytes * fps, 0,
                       _AVIF_HASINDEX, n, 0, 1, max_bytes, width, height, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIIi", 0, 0, 0, 0, 1, max(fps, 1), 0, n, max_bytes, 10000, 0)
            + struct.pack("<hhhh", 0, 0, width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3,
                       0, 0, 0, 0)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl)
    body = b"AVI " + hdrl + chunk(b"LIST", bytes(movi)) + chunk(b"idx1", bytes(idx))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def read_avi_frame_count(path: str) -> Tuple[int, Tuple[int, int], int]:
    """``(n_frames, (height, width), fps)`` from the headers of an AVI written by
    ``write_mjpeg_avi``; checks the RIFF sizes, that the stream is vids/MJPG and
    that idx1 has one entry a frame."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not a RIFF/AVI file")
    if struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        raise ValueError("RIFF size mismatch")
    n_frames = width = height = fps = idx_entries = None

    def walk(start: int, end: int):
        pos = start
        while pos + 8 <= end:
            fourcc = data[pos:pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
            yield fourcc, pos + 8, size
            pos += 8 + size + size % 2

    for fourcc, at, size in walk(12, len(data)):
        if fourcc == b"LIST" and data[at:at + 4] == b"hdrl":
            for sub, sat, ssize in walk(at + 4, at + size):
                if sub == b"avih":
                    vals = struct.unpack("<14I", data[sat:sat + 56])
                    n_frames, width, height = vals[4], vals[8], vals[9]
                    fps = round(1_000_000 / vals[0]) if vals[0] else 0
                elif sub == b"LIST" and data[sat:sat + 4] == b"strl":
                    for s2, s2at, _ in walk(sat + 4, sat + ssize):
                        if s2 == b"strh" and data[s2at:s2at + 8] != b"vidsMJPG":
                            raise ValueError("stream is not vids/MJPG")
        elif fourcc == b"idx1":
            idx_entries = size // 16
    if n_frames is None:
        raise ValueError("no avih header found")
    if idx_entries is not None and idx_entries != n_frames:
        raise ValueError(f"idx1 entries {idx_entries} != header frames {n_frames}")
    return n_frames, (height, width), fps


def extract_first_jpeg(path: str) -> bytes:
    """The first '00dc' chunk's JPEG bytes."""
    with open(path, "rb") as f:
        data = f.read()
    at = data.find(b"movi")
    if at < 0:
        raise ValueError("no movi list")
    if data[at + 4:at + 8] != b"00dc":
        raise ValueError("first movi chunk is not 00dc")
    (size,) = struct.unpack("<I", data[at + 8:at + 12])
    return data[at + 12:at + 12 + size]
