"""Sensor data types: LidarScan and Image.

Counterpart of ``loner_tpu/common/sensors.py`` (numpy and scipy only). Scans
stay on the host as contiguous numpy arrays; the mapper uploads each
keyframe's scan to the device once (``mapping/rays.py::DeviceScanPool``).
Motion compensation, per-point SE(3) interpolation between two poses, is
vectorised numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as _R

from loner_tpu_torch.common.pose import Pose

NUMERIC_TOLERANCE = 1e-9


@dataclass
class Image:
    """An RGB (or mono) image and its capture time."""

    image: np.ndarray
    timestamp: float

    def clone(self) -> "Image":
        return Image(self.image.copy(), self.timestamp)

    @property
    def shape(self):
        return self.image.shape


class LidarScan:
    """A sweep of lidar returns.

    ray_directions: (3, N) unit directions in the sensor frame
    distances:      (N,) ranges in meters
    timestamps:     (N,) per-point fire times, MUST be sorted ascending
    sky_rays:       optional (3, M) world-frame directions known to hit sky
    mask:           optional (N,) bool ray-selection mask (MASK strategy)
    """

    def __init__(
        self,
        ray_directions: Optional[np.ndarray] = None,
        distances: Optional[np.ndarray] = None,
        timestamps: Optional[np.ndarray] = None,
        sky_rays: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
    ) -> None:
        self.ray_directions = (
            np.zeros((3, 0), dtype=np.float32)
            if ray_directions is None
            else np.asarray(ray_directions, dtype=np.float32)
        )
        self.distances = (
            np.zeros((0,), dtype=np.float32)
            if distances is None
            else np.asarray(distances, dtype=np.float32)
        )
        self.timestamps = (
            np.zeros((0,), dtype=np.float64)
            if timestamps is None
            else np.asarray(timestamps, dtype=np.float64)
        )
        self.sky_rays = None if sky_rays is None else np.asarray(sky_rays, dtype=np.float32)
        self.mask = mask

    def __len__(self) -> int:
        return self.timestamps.shape[0]

    def get_start_time(self) -> float:
        return float(self.timestamps[0])

    def get_end_time(self) -> float:
        return float(self.timestamps[-1])

    def clone(self) -> "LidarScan":
        return LidarScan(
            self.ray_directions.copy(),
            self.distances.copy(),
            self.timestamps.copy(),
            None if self.sky_rays is None else self.sky_rays.copy(),
            None if self.mask is None else self.mask.copy(),
        )

    def end_points(self) -> np.ndarray:
        """(N, 3) cartesian points in the sensor frame."""
        return (self.ray_directions * self.distances).T

    def motion_compensate(
        self,
        poses: Tuple[Pose, Pose],
        timestamps: Tuple[float, float],
        target_frame: Pose,
    ) -> "LidarScan":
        """Undistort the sweep by per-point pose interpolation, in place.

        Points are lifted to the world frame using the pose interpolated at
        each point's fire time, then re-expressed in ``target_frame``
        (reference sensors.py:176-232). Returns self.
        """
        start_pose, end_pose = poses
        start_ts, end_ts = timestamps
        alphas = (self.timestamps - start_ts) / max(end_ts - start_ts, NUMERIC_TOLERANCE)

        t0, t1 = start_pose.get_translation(), end_pose.get_translation()
        translations = t0 + (t1 - t0) * alphas[:, None]  # (N, 3)

        r0 = start_pose.get_rotation()
        rel = r0.T @ end_pose.get_rotation()
        rel_rotvec = _R.from_matrix(rel).as_rotvec()
        angle = np.linalg.norm(rel_rotvec)
        pts = self.end_points()  # sensor frame (N, 3)
        if angle < NUMERIC_TOLERANCE:
            world_pts = pts @ r0.T + translations
        else:
            rots = _R.from_rotvec(rel_rotvec[None, :] * alphas[:, None]).as_matrix()
            # world = r0 @ rots_i @ p_i + trans_i
            world_pts = np.einsum("ij,njk,nk->ni", r0, rots, pts) + translations

        t_inv = target_frame.inv().matrix
        target_pts = world_pts @ t_inv[:3, :3].T + t_inv[:3, 3]

        dists = np.linalg.norm(target_pts, axis=-1)
        self.distances = dists.astype(np.float32)
        self.ray_directions = (target_pts / np.maximum(dists[:, None], NUMERIC_TOLERANCE)).T.astype(
            np.float32
        )
        return self

