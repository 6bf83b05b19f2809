"""World cube: normalize the scene into the unit cube.

Counterpart of ``loner_tpu/common/world_cube.py`` (numpy only): poses (and
camera frustum / lidar range corners) are gathered, an axis-aligned bounding
cube is computed, and the resulting ``scale_factor`` and ``shift`` place every
ray inside ``[-1, 1]^3``.

Transformation convention: ``p_cube = (p_world + shift) / scale_factor``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class WorldCube:
    scale_factor: float
    shift: np.ndarray  # (3,)

    def as_dict(self) -> dict:
        return {
            "scale_factor": float(self.scale_factor),
            "shift": [float(s) for s in np.asarray(self.shift).reshape(-1)],
        }

    @staticmethod
    def from_dict(d: dict) -> "WorldCube":
        return WorldCube(float(d["scale_factor"]), np.asarray(d["shift"], dtype=np.float64))

    def to_cube(self, points: np.ndarray) -> np.ndarray:
        return (points + self.shift) / self.scale_factor

    def from_cube(self, points: np.ndarray) -> np.ndarray:
        return points * self.scale_factor - self.shift


def _frustum_corners(k: np.ndarray, h: float, w: float, min_depth: float, max_depth: float) -> np.ndarray:
    """Camera view-frustum corners in camera frame, homogeneous (8, 4).

    Mirrors reference pose_utils.py:131-149 (note its -z forward convention).
    """
    assert 0 < min_depth < max_depth
    corners = []
    for depth in (min_depth, max_depth):
        left = -k[0, 2] / k[0, 0] * depth
        right = (w - k[0, 2]) / k[0, 0] * depth
        up = k[1, 2] / k[1, 1] * depth
        down = -(h - k[1, 2]) / k[1, 1] * depth
        for x in (left, right):
            for y in (up, down):
                corners.append([x, y, -depth, 1.0])
    return np.asarray(corners, dtype=np.float64)


def compute_world_cube(
    camera_to_lidar: Optional[np.ndarray],
    intrinsic_mats: Optional[np.ndarray],
    image_sizes,
    lidar_poses: Optional[np.ndarray],
    ray_range: Sequence[float],
    padding: float = 0.1,
    traj_bounding_box: Optional[dict] = None,
) -> WorldCube:
    """Compute the world cube from GT poses (or a trajectory bounding box).

    Semantics match reference pose_utils.py:159-248, including the
    right-inverse zeroing ``T_i @ T_0^{-1}`` of the pose set.
    """
    assert 0 <= padding < 1
    assert lidar_poses is not None or traj_bounding_box is not None

    if lidar_poses is None:
        x0, x1 = traj_bounding_box["x"]
        y0, y1 = traj_bounding_box["y"]
        z0, z1 = traj_bounding_box["z"]
        corners = np.array(
            [[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)],
            dtype=np.float64,
        )
        lidar_poses = np.tile(np.eye(4), (8, 1, 1))
        lidar_poses[:, :3, 3] = corners
    else:
        lidar_poses = np.asarray(lidar_poses, dtype=np.float64)
        lidar_poses = lidar_poses @ np.linalg.inv(lidar_poses[0])

    all_corners = []
    if camera_to_lidar is not None:
        camera_to_lidar = np.asarray(camera_to_lidar, dtype=np.float64)
        camera_poses = lidar_poses @ np.linalg.inv(camera_to_lidar)
        intrinsic_mats = np.asarray(intrinsic_mats, dtype=np.float64)
        if intrinsic_mats.ndim == 2:
            intrinsic_mats = np.broadcast_to(
                intrinsic_mats, (camera_poses.shape[0], 3, 3)
            )
        image_sizes = np.asarray(image_sizes, dtype=np.float64)
        if image_sizes.shape == (2,):
            image_sizes = np.broadcast_to(image_sizes, (camera_poses.shape[0], 2))
        for k, hw, c2w in zip(intrinsic_mats, image_sizes, camera_poses):
            pts = _frustum_corners(k, hw[0], hw[1], ray_range[0], ray_range[1])
            all_corners.append((c2w[:3, :] @ pts.T).T)
        all_poses = np.concatenate(
            [camera_poses[:, :3, 3], lidar_poses[:, :3, 3]], axis=0
        )
    else:
        max_depth = float(ray_range[1])
        cube = np.array(
            [[x, y, z, 1.0] for z in (-max_depth, max_depth)
             for y in (-max_depth, max_depth) for x in (-max_depth, max_depth)],
            dtype=np.float64,
        )
        for pose in lidar_poses:
            all_corners.append((pose[:3, :] @ cube.T).T)
        all_poses = lidar_poses[:, :3, 3]

    all_points = np.concatenate(all_corners + [all_poses], axis=0)
    min_coord = all_points.min(axis=0)
    max_coord = all_points.max(axis=0)
    origin = min_coord + (max_coord - min_coord) / 2
    scale_factor = float(
        np.linalg.norm(max_coord - min_coord) / (2 * np.sqrt(3.0)) * (1 + padding)
    )
    return WorldCube(scale_factor, -origin)
