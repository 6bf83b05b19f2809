"""FrameSynthesis: turn the LiDAR scan stream into Frames.

Counterpart of ``loner_tpu/tracking/frame_synthesis.py``, LiDAR only: the scan
stream is decimated to the configured frame rate (or passed through with
``decimate_on_load``). Matching camera images to scans is not ported.
"""
from __future__ import annotations

from typing import List, Optional

from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import LidarScan


class FrameSynthesis:
    def __init__(self, settings, t_lidar_to_camera: Optional[Pose], lidar_only: bool = True) -> None:
        if not lidar_only:
            raise NotImplementedError("the camera branch (images matched to scans) is not ported")
        self._settings = settings
        self._t_lidar_to_camera = t_lidar_to_camera
        self._completed_frames: List[Frame] = []
        self._prev_accepted_timestamp = float("-inf")
        self._frame_delta_t_sec = 1.0 / settings.frame_decimation_rate_hz
        self._decimate_on_load = bool(settings.get("decimate_on_load", True))

    def process_lidar(self, lidar_scan: LidarScan, gt_pose: Optional[Pose]) -> None:
        scan_time = lidar_scan.get_start_time()
        dt = self._frame_delta_t_sec - self._settings.frame_delta_t_sec_tolerance
        if self._decimate_on_load or scan_time - self._prev_accepted_timestamp >= dt:
            frame = Frame(lidar_scan, self._t_lidar_to_camera)
            frame._gt_lidar_pose = gt_pose
            self._completed_frames.append(frame.clone())
            self._prev_accepted_timestamp = scan_time

    def has_frame(self) -> bool:
        return len(self._completed_frames) != 0

    def pop_frame(self) -> Optional[Frame]:
        if not self._completed_frames:
            return None
        return self._completed_frames.pop(0)
