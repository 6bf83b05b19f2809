"""KeyFrame: a Frame elected for map optimisation, plus pose bookkeeping.

Counterpart of ``loner_tpu/mapping/keyframe.py``. The optimisable pose is a
6-twist numpy vector, a row of the window's twist tensor in the phase runner;
the tracked-pose snapshot re-bases new keyframes onto optimised references and
splices the trajectory at shutdown.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.pose import Pose

# Process-wide monotonic keyframe ids: DeviceScanPool keys its
# HBM-resident entries by this (an id() key could be reused by CPython
# after GC and silently serve another keyframe's scan).
_uid_counter = itertools.count()


class KeyFrame:
    def __init__(self, frame: Frame) -> None:
        self.uid = next(_uid_counter)
        self._frame = frame
        self._tracked_lidar_pose: Pose = frame.get_lidar_pose().clone()
        # The OPTIMIZED pose is keyframe-owned state. The tracker, logger
        # and mapper share the same Frame object across threads (the
        # reference's mp queues pickle-copy instead, src/loner.py:96-117),
        # so writing optimized poses back into the Frame would race the
        # logger's tracked-trajectory recording — observed as one-frame
        # ~0.1-0.3 m pose spikes at exactly the keyframe timestamps.
        self._lidar_pose: Pose = self._tracked_lidar_pose.clone()
        self.is_anchored = False

    def __repr__(self) -> str:
        return f"KeyFrame({self._frame})"

    # -- accessors -------------------------------------------------------------
    def get_lidar_pose(self) -> Pose:
        return self._lidar_pose

    def set_lidar_pose(self, pose: Pose) -> None:
        self._lidar_pose = pose

    def get_camera_pose(self) -> Optional[Pose]:
        return self._frame.get_camera_pose()

    def get_image(self):
        """The Image matched to this keyframe's scan, or None."""
        return self._frame.image

    def get_lidar_scan(self):
        return self._frame.lidar_points

    def get_time(self) -> float:
        return self._frame.get_time()

    # -- optimizer interface ------------------------------------------------
    def scan_dirs(self, use_mask: bool = False) -> np.ndarray:
        """(3, N) sensor-frame ray directions.

        ``use_mask`` (rays_selection.strategy == MASK) pre-filters the
        buffer to mask-true points; uniform index sampling over the packed
        buffer is then exactly the reference's sample-from-mask-indices
        (src/mapping/optimizer.py:289-292). RANDOM/FIXED ignore the mask,
        like the reference.
        """
        scan = self._frame.lidar_points
        if use_mask and scan.mask is not None:
            return scan.ray_directions[:, scan.mask]
        return scan.ray_directions

    def scan_depths(self, use_mask: bool = False) -> np.ndarray:
        scan = self._frame.lidar_points
        if use_mask and scan.mask is not None:
            return scan.distances[scan.mask]
        return scan.distances

    def sky_dirs(self) -> Optional[np.ndarray]:
        """(3, M) SENSOR-frame sky directions or None.

        Note: the reference stores sky rays world-frame and then rotates
        them by the (detached) keyframe pose again when building rays
        (tracker.py:292-296 + ray_utils.py:293) — a double rotation. We
        store sensor-frame so the single rotation in ray building is correct.
        """
        return self._frame.lidar_points.sky_rays

    def pose_twist(self, use_gt: bool = False) -> np.ndarray:
        pose = self._frame._gt_lidar_pose if use_gt else self._lidar_pose
        return pose.to_twist().astype(np.float32)

    def set_pose_twist(self, twist: np.ndarray) -> None:
        self._lidar_pose = Pose.from_twist(np.asarray(twist, np.float64))

    @classmethod
    def from_pose_state(
        cls, frame: Frame, state: dict, anchored: bool = False
    ) -> "KeyFrame":
        """Rebuild a keyframe from a checkpointed pose state (the
        get_pose_state schema) + a re-read Frame — the mid-run resume
        path (no reference analog: it has no resume, SURVEY §5.4). The
        frame's pose is set to the TRACKED pose so the constructor
        snapshot reproduces the original re-basing chain; the optimized
        pose then overwrites the keyframe-owned slot."""
        frame._lidar_pose = Pose.from_twist(
            np.asarray(state["tracked_pose"], np.float64)
        )
        kf = cls(frame)
        kf._lidar_pose = Pose.from_twist(
            np.asarray(state["lidar_pose"], np.float64)
        )
        kf.is_anchored = anchored
        return kf

    # -- checkpoint schema (reference keyframe.py:126-135) --------------------
    def get_pose_state(self) -> dict:
        lidar_to_camera = self._frame._lidar_to_camera
        gt = self._frame._gt_lidar_pose
        return {
            "timestamp": float(self.get_time()),
            "lidar_to_camera": None
            if lidar_to_camera is None
            else lidar_to_camera.to_twist(),
            "lidar_pose": self.get_lidar_pose().to_twist(),
            "gt_lidar_pose": None if gt is None else gt.to_twist(),
            "tracked_pose": self._tracked_lidar_pose.to_twist(),
        }
