"""Voxel downsampling of point clouds, on the host (numpy).

Counterpart of ``loner_tpu/ops/voxel.py::voxel_downsample`` (Open3D's
``voxel_down_sample`` semantics).
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average all points that fall into the same voxel."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] == 0:
        return pts.astype(np.float32)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    np.add.at(sums, inverse.reshape(-1), pts)
    return (sums / counts[:, None]).astype(np.float32)
