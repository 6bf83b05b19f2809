"""Camera ray geometry: pinhole rays, undistortion, LONER-format rays.

Counterpart of ``loner_tpu/common/camera.py`` (numpy, plus torch for the ray
packing): precomputed undistorted pixel rays, chunked fetch, and LONER-format
ray building. Undistortion is the fixed-point iteration of the Brown-Conrady
model (OpenCV's algorithm), in float64 as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.world_cube import WorldCube


def undistort_points(pts: np.ndarray, k: np.ndarray, dist: np.ndarray,
                     new_k: Optional[np.ndarray] = None, iterations: int = 8) -> np.ndarray:
    """Brown-Conrady undistortion by fixed-point iteration.

    pts: (N, 2) pixel coordinates in the distorted image; k: (3, 3); dist:
    (k1, k2, p1, p2[, k3]). Returns (N, 2) pixel coordinates under ``new_k``
    (default: k)."""
    dist = np.asarray(dist, np.float64).reshape(-1)
    k1, k2 = dist[0], dist[1] if len(dist) > 1 else 0.0
    p1 = dist[2] if len(dist) > 2 else 0.0
    p2 = dist[3] if len(dist) > 3 else 0.0
    k3 = dist[4] if len(dist) > 4 else 0.0

    x = (pts[:, 0] - k[0, 2]) / k[0, 0]
    y = (pts[:, 1] - k[1, 2]) / k[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    nk = k if new_k is None else new_k
    return np.stack([x * nk[0, 0] + nk[0, 2], y * nk[1, 1] + nk[1, 2]], axis=-1)


def get_ray_directions(h: int, w: int, new_k: np.ndarray, dist: Optional[np.ndarray] = None,
                       k: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pixel camera-frame ray directions (z = 1), row-major. Returns
    (directions (H W, 3) f32, i (H W,), j (H W,)): (i, j) the original pixel
    coordinates."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    grid = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
    if dist is not None and np.any(np.asarray(dist) != 0):
        if k is None:
            raise ValueError("distortion requires the original K")
        und = undistort_points(grid, np.asarray(k, np.float64), dist, new_k)
    else:
        und = grid
    dirs = np.stack([(und[:, 0] - new_k[0, 2]) / new_k[0, 0],
                     (und[:, 1] - new_k[1, 2]) / new_k[1, 1],
                     np.ones(grid.shape[0])], axis=-1)
    return dirs.astype(np.float32), grid[:, 0].astype(np.float32), grid[:, 1].astype(np.float32)


class CameraRayDirections:
    """Precomputed per-pixel rays of a calibrated camera and LONER-format ray
    building."""

    def __init__(self, calibration, chunk_size: int = 512) -> None:
        intr = calibration.camera_intrinsic
        k = np.asarray(intr.k, np.float64)
        new_k = np.asarray(intr.new_k, np.float64) if intr.get("new_k") is not None else k
        dist = intr.get("distortion")
        self.im_width = int(intr.width)
        self.im_height = int(intr.height)
        self.directions, self.i_grid, self.j_grid = get_ray_directions(
            self.im_height, self.im_width, new_k, dist, k)
        self._chunk_size = chunk_size
        self.num_chunks = int(np.ceil(self.directions.shape[0] / chunk_size))

    def __len__(self) -> int:
        return self.directions.shape[0]

    def build_rays(self, pixel_indices: np.ndarray, pose: Pose, image: Optional[np.ndarray],
                   world_cube: WorldCube, ray_range) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(rays (N, 11) f32 in cube coordinates, the pixels' intensities or None)
        for ``pixel_indices`` from the camera at ``pose``."""
        from loner_tpu_torch.mapping.rays import get_far_val
        from loner_tpu_torch.models.rendering import pack_rays

        dirs = self.directions[pixel_indices]
        mat = pose.matrix.copy()
        mat[:3, 3] = (mat[:3, 3] + world_cube.shift) / world_cube.scale_factor
        ray_dirs = dirs @ mat[:3, :3].T
        ray_dirs = ray_dirs / np.linalg.norm(ray_dirs, axis=-1, keepdims=True)
        origins = torch.from_numpy(np.broadcast_to(mat[:3, 3], ray_dirs.shape).astype(np.float32))
        d = torch.from_numpy(ray_dirs.astype(np.float32))
        near = torch.full((len(pixel_indices),), ray_range[0] / world_cube.scale_factor,
                          dtype=torch.float32)
        rays = pack_rays(origins, d, near, get_far_val(origins, d), viewdirs=-d).numpy()
        intensities = None
        if image is not None:
            intensities = image.reshape(-1, image.shape[-1])[pixel_indices]
        return rays, intensities

    def fetch_chunk_rays(self, chunk_idx: int, pose: Pose, world_cube: WorldCube, ray_range):
        start = chunk_idx * self._chunk_size
        end = min(len(self), (chunk_idx + 1) * self._chunk_size)
        return self.build_rays(np.arange(start, end), pose, None, world_cube, ray_range)[0]
