"""FrameSynthesis: turn the sensor streams into Frames.

Counterpart of ``loner_tpu/tracking/frame_synthesis.py``. LiDAR only, the scan
stream is decimated to the configured frame rate (or passed through with
``decimate_on_load``); in camera mode each decimated image is matched to the
scan whose time span covers its timestamp, within ``frame_match_tolerance``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import Image, LidarScan


class FrameSynthesis:
    def __init__(self, settings, t_lidar_to_camera: Optional[Pose], lidar_only: bool = True) -> None:
        self._settings = settings
        self._t_lidar_to_camera = t_lidar_to_camera
        self._lidar_only = lidar_only
        self._completed_frames: List[Frame] = []
        self._in_progress_frames: List[Frame] = []
        self._lidar_scans: List[Tuple[LidarScan, Optional[Pose]]] = []
        self._prev_accepted_timestamp = float("-inf")
        self._frame_delta_t_sec = 1.0 / settings.frame_decimation_rate_hz
        self._decimate_on_load = bool(settings.get("decimate_on_load", True))

    def process_lidar(self, lidar_scan: LidarScan, gt_pose: Optional[Pose]) -> None:
        if not self._lidar_only:
            self._lidar_scans.append((lidar_scan, gt_pose))
            self._match_images_to_scans()
            return
        scan_time = lidar_scan.get_start_time()
        dt = self._frame_delta_t_sec - self._settings.frame_delta_t_sec_tolerance
        if self._decimate_on_load or scan_time - self._prev_accepted_timestamp >= dt:
            frame = Frame(lidar_scan, self._t_lidar_to_camera)
            frame._gt_lidar_pose = gt_pose
            self._completed_frames.append(frame.clone())
            self._prev_accepted_timestamp = scan_time

    def process_image(self, image: Image) -> None:
        if (image.timestamp - self._prev_accepted_timestamp
                >= self._frame_delta_t_sec - self._settings.frame_delta_t_sec_tolerance):
            self._prev_accepted_timestamp = image.timestamp
            frame = Frame(None, self._t_lidar_to_camera, image=image)
            self._in_progress_frames.append(frame.clone())
            self._match_images_to_scans()

    def _match_images_to_scans(self) -> None:
        """Pair each queued image with the first queued scan whose span (within
        the tolerance) holds its timestamp; the scans before it are dropped. An
        image older than every queued scan is dropped; one newer waits."""
        remaining: List[Frame] = []
        tol = self._settings.frame_match_tolerance
        for frame in self._in_progress_frames:
            if not self._lidar_scans:
                remaining.append(frame)
                continue
            ts = frame.image.timestamp
            match_idx = next((i for i, (scan, _) in enumerate(self._lidar_scans)
                              if scan.get_start_time() - tol <= ts <= scan.get_end_time() + tol),
                             None)
            if match_idx is None:
                if self._lidar_scans[0][0].get_start_time() - tol > ts:
                    print(f"Skipped frame with image TS {ts}")
                    continue
                remaining.append(frame)
                continue
            scan, gt = self._lidar_scans[match_idx]
            frame.lidar_points = scan
            frame._gt_lidar_pose = gt
            self._lidar_scans = self._lidar_scans[match_idx + 1:]
            if len(frame.lidar_points) > 0:
                self._completed_frames.append(frame)
        self._in_progress_frames = remaining

    def has_frame(self) -> bool:
        return len(self._completed_frames) != 0

    def pop_frame(self) -> Optional[Frame]:
        if not self._completed_frames:
            return None
        return self._completed_frames.pop(0)
