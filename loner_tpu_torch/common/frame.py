"""Frame: the unit of tracking.

Counterpart of ``loner_tpu/common/frame.py``: a LidarScan (and, in camera mode,
the Image matched to it) with its tracked pose, ground-truth pose and the
LiDAR-to-camera extrinsic. ``build_point_cloud`` returns the (N, 3) numpy
cloud the ICP takes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import Image, LidarScan


class Frame:
    def __init__(
        self,
        lidar_points: Optional[LidarScan] = None,
        T_lidar_to_camera: Optional[Pose] = None,
        image: Optional[Image] = None,
    ) -> None:
        self.image = image
        self.lidar_points = lidar_points if lidar_points is not None else LidarScan()
        self._lidar_to_camera = T_lidar_to_camera
        self._lidar_pose: Optional[Pose] = None
        self._gt_lidar_pose: Optional[Pose] = None
        self._id = -1

    def clone(self) -> "Frame":
        new = Frame()
        for attr in ("image", "lidar_points", "_lidar_to_camera", "_lidar_pose", "_gt_lidar_pose"):
            old = getattr(self, attr)
            setattr(new, attr, None if old is None else old.clone())
        new._id = self._id
        return new

    def __repr__(self) -> str:
        return (
            f"<Frame; time range ({self.lidar_points.get_start_time()},"
            f" {self.lidar_points.get_end_time()})>"
        )

    def get_time(self) -> float:
        return self.lidar_points.get_start_time()

    def get_middle_time(self) -> float:
        return 0.5 * (self.lidar_points.get_start_time() + self.lidar_points.get_end_time())

    def get_scan_duration(self) -> float:
        return self.lidar_points.get_end_time() - self.lidar_points.get_start_time()

    def get_lidar_pose(self) -> Optional[Pose]:
        return self._lidar_pose

    def get_camera_pose(self) -> Optional[Pose]:
        if self._lidar_pose is None or self._lidar_to_camera is None:
            return None
        return self._lidar_pose * self._lidar_to_camera

    def build_point_cloud(
        self, scan_duration: Optional[float] = None, target_points: Optional[int] = None
    ) -> np.ndarray:
        """(N, 3) sensor-frame points from the middle ``scan_duration``
        fraction of the sweep, uniformly strided to about ``target_points``.
        The ICP's input."""
        ts = self.lidar_points.timestamps
        n = len(ts)
        if scan_duration is not None and n > 0 and (ts[-1] - ts[0]) > 1e-3:
            time_per_scan = scan_duration * self.get_scan_duration()
            middle = 0.5 * (ts[0] + ts[-1])
            start_index = int(np.argmax(ts - middle >= -time_per_scan / 2))
            if ts[-1] < middle + time_per_scan / 2:
                final_index = n
            else:
                final_index = int(np.argmax(ts - middle >= time_per_scan / 2))
        else:
            start_index, final_index = 0, n

        step = 1 if target_points is None else max((final_index - start_index) // target_points, 1)
        dirs = self.lidar_points.ray_directions[:, start_index:final_index:step]
        dists = self.lidar_points.distances[start_index:final_index:step]
        return (dirs * dists).T.astype(np.float32)
