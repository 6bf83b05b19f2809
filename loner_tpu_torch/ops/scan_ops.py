"""Host ops of the LiDAR ingest: point-blob decode, voxel downsampling, FOV mask.

Counterparts of ``loner_tpu/ops/native/__init__.py::decode_point_blob``,
``voxel_downsample_native`` and ``fov_mask_native``. Each calls the port's copy
of the same C++ (``csrc/scan_ops.cpp``), built with the host compiler at first
use (``ops/build.py::load_host_library``) and equal to the JAX package's library
to the bit. These are host ops on numpy arrays, not device kernels. A failed
build raises: nothing falls back to numpy.

Beside each stands its plain numpy version (``*_plain``), for the tests:

- ``decode_point_blob_plain`` follows the JAX package's numpy fallback and is
  not bit-equal to the C++. It keeps a point when ``r > min_range`` with ``r``
  from ``np.linalg.norm`` of the float32 coordinates, where the C++ drops it when
  ``x*x + y*y + z*z <= min_range**2`` in float32; and it divides by ``r`` where
  the C++ multiplies by ``1 / r``. Held to the C++ (``tests/test_torch_ingest.py``)
  at ``DECODE_PLAIN_RTOL`` on directions and ranges, times equal; the kept sets
  are equal but for points whose range lies within ``DECODE_PLAIN_RTOL`` of
  ``min_range``. Non-finite rows and, with index times, the pre-filter indices
  agree exactly.
- ``voxel_downsample_plain`` computes in the C++'s order and precision (cells
  in first-seen order, sums in float64) and is held to it to the bit.
- ``fov_mask_plain`` takes the azimuth in float32 as the C++ does (``std::atan2``
  of two floats is ``atan2f``), but numpy's float32 ``arctan2`` is not libm's
  ``atan2f`` to the bit: the masks agree but for azimuths within
  ``FOV_PLAIN_DEG`` of a window's bound.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from loner_tpu_torch.ops.build import load_host_library

DECODE_PLAIN_RTOL = 2.5e-7  # two float32 ulps
FOV_PLAIN_DEG = 1e-4  # a few float32 ulps of an azimuth near 180 degrees, in degrees


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = load_host_library("scan_ops")
    lib.decode_point_blob.argtypes = [_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
                                      ctypes.c_float, _P, _P, _P]
    lib.decode_point_blob.restype = _I64
    lib.voxel_downsample.argtypes = [_P, _I64, ctypes.c_float, _P]
    lib.voxel_downsample.restype = _I64
    lib.fov_mask.argtypes = [_P, _I64, _P, _I32, _P]
    lib.fov_mask.restype = None
    return lib


def _check_layout(nbytes: int, n_points: int, point_step: int, xyz_offsets, time_offset: int,
                  time_kind: int) -> None:
    """The blob's records and fields lie inside it (the C++ reads unchecked)."""
    width = {0: 4, 1: 8, 2: 4}.get(time_kind, 0)
    fields = [(o, 4) for o in xyz_offsets] + ([(time_offset, width)] if width else [])
    if (n_points < 0 or point_step <= 0 or nbytes < n_points * point_step
            or any(o < 0 or o + w > point_step for o, w in fields)):
        raise ValueError(f"a blob of {nbytes} bytes does not hold {n_points} records of "
                         f"{point_step} bytes with fields at {fields}")


def decode_point_blob(
    blob: bytes,
    n_points: int,
    point_step: int,
    xyz_offsets: Tuple[int, int, int],
    time_offset: int = -1,
    time_kind: int = -1,
    min_range: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A PointCloud2-style blob -> (dirs (3, M) f32, ranges (M,) f32, times (M,)
    f64) of its finite points beyond ``min_range``, in blob order.

    time_kind: 0 = f32 seconds, 1 = f64 seconds, 2 = u32 nanoseconds,
    3 = the pre-filter point index (for column-derived times), -1 = no
    per-point time (zeros).
    """
    buf = np.frombuffer(blob, dtype=np.uint8)
    _check_layout(buf.size, n_points, point_step, xyz_offsets, time_offset, time_kind)
    lib = _lib()
    ox, oy, oz = xyz_offsets
    dirs = np.empty((3, n_points), np.float32)
    ranges = np.empty(n_points, np.float32)
    times = np.empty(n_points, np.float64)
    m = lib.decode_point_blob(buf.ctypes.data, n_points, point_step, ox, oy, oz, time_offset,
                              time_kind, min_range, dirs.ctypes.data, ranges.ctypes.data,
                              times.ctypes.data)
    return dirs[:, :m].copy(), ranges[:m].copy(), times[:m].copy()


def decode_point_blob_plain(
    blob: bytes,
    n_points: int,
    point_step: int,
    xyz_offsets: Tuple[int, int, int],
    time_offset: int = -1,
    time_kind: int = -1,
    min_range: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``decode_point_blob`` in numpy (see the module's docstring for how it
    differs from the C++)."""
    rec = np.frombuffer(blob, dtype=np.uint8).reshape(n_points, point_step)
    xyz = np.stack([rec[:, o : o + 4].copy().view(np.float32)[:, 0] for o in xyz_offsets], axis=0)
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.linalg.norm(xyz, axis=0)
    if time_kind == 0:
        t = rec[:, time_offset : time_offset + 4].copy().view(np.float32)[:, 0].astype(np.float64)
    elif time_kind == 1:
        t = rec[:, time_offset : time_offset + 8].copy().view(np.float64)[:, 0]
    elif time_kind == 2:
        t = rec[:, time_offset : time_offset + 4].copy().view(np.uint32)[:, 0] * 1e-9
    elif time_kind == 3:
        t = np.arange(n_points, dtype=np.float64)
    else:
        t = np.zeros(n_points)
    keep = np.isfinite(r) & (r > min_range)
    dirs = xyz[:, keep] / r[keep]
    return dirs.astype(np.float32), r[keep].astype(np.float32), t[keep]


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """(N, 3) points -> (M, 3) float32 means of the points in each voxel of
    ``voxel_size``, the voxels in the order their first point comes."""
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    if pts.shape[0] == 0:
        return pts.copy()
    out = np.empty_like(pts)
    n_out = _lib().voxel_downsample(pts.ctypes.data, pts.shape[0], voxel_size, out.ctypes.data)
    return out[:n_out].copy()


def voxel_downsample_plain(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """``voxel_downsample`` in numpy, in the C++'s order and precision."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if pts.shape[0] == 0:
        return pts.copy()
    inv = 1.0 / float(np.float32(voxel_size))
    keys = np.floor(pts.astype(np.float64) * inv).astype(np.int64)
    _, first, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    rank = np.empty(first.shape[0], np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.shape[0])
    slot = rank[inverse.reshape(-1)]
    sums = np.zeros((first.shape[0], 3), np.float64)
    np.add.at(sums, slot, pts.astype(np.float64))
    counts = np.bincount(slot, minlength=first.shape[0])
    return (sums / counts[:, None]).astype(np.float32)


def fov_mask(dirs: np.ndarray, ranges_deg) -> np.ndarray:
    """(3, N) directions and [[lo, hi], ...] azimuth windows in degrees ->
    (N,) bool: the azimuth in [0, 360) lies in some window, bounds included."""
    d = np.ascontiguousarray(dirs, dtype=np.float32).reshape(3, -1)
    windows = np.ascontiguousarray(np.asarray(ranges_deg, np.float32).reshape(-1, 2))
    keep = np.empty(d.shape[1], np.uint8)
    _lib().fov_mask(d.ctypes.data, d.shape[1], windows.ctypes.data, windows.shape[0],
                    keep.ctypes.data)
    return keep.astype(bool)


def fov_mask_plain(dirs: np.ndarray, ranges_deg) -> np.ndarray:
    """``fov_mask`` in numpy (see the module's docstring for how it differs)."""
    d = np.asarray(dirs, np.float32)
    az = np.arctan2(d[1], d[0]).astype(np.float64) * 57.29577951308232
    az = np.where(az < 0, az + 360.0, az)
    keep = np.zeros(d.shape[1], bool)
    for lo, hi in np.asarray(ranges_deg, np.float32).reshape(-1, 2).astype(np.float64):
        keep |= (az >= lo) & (az <= hi)
    return keep
