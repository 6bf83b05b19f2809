"""DefaultLogger: accumulates trajectories and splices the final estimate.

Counterpart of ``loner_tpu/runtime/logger.py``. Subscribes to the frame and
keyframe-update signals; keeps the ICP-only trajectory and the online
(keyframe-corrected) one, and at shutdown splices the optimised keyframe poses
with the tracked segments between them into
``trajectory/estimated_trajectory.txt`` (TUM), beside ``tracking_only.txt``,
``online_estimates.txt``, ``keyframe_trajectory.txt`` and ``groundtruth.txt``.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.signals import Signal, StopSignal
from loner_tpu_torch.common.trajectory import dump_trajectory_to_tum


class DefaultLogger:
    def __init__(
        self,
        frame_signal: Signal,
        keyframe_update_signal: Signal,
        log_directory: str,
    ) -> None:
        self._frame_slot = frame_signal.register()
        self._keyframe_update_slot = keyframe_update_signal.register()
        self._log_directory = log_directory

        self._timestamps: List[float] = []
        self._icp_only: List[np.ndarray] = []
        self._gt_path: List[np.ndarray] = []
        self._frame_log: List[np.ndarray] = []

        self._gt_pose_offset: Optional[Pose] = None
        self._t_world_to_kf = np.eye(4)
        self._t_kf_to_frame = np.eye(4)
        self._last_keyframe_state = None
        self._frame_done = False

    def update(self) -> None:
        while self._frame_slot.has_value():
            frame = self._frame_slot.get_value()
            if isinstance(frame, StopSignal):
                self._frame_done = True
                break
            if self._frame_done:
                continue

            if self._gt_pose_offset is None and frame._gt_lidar_pose is not None:
                self._gt_pose_offset = frame._gt_lidar_pose.inv()

            tracked = frame.get_lidar_pose().matrix.copy()
            self._icp_only.append(tracked)
            self._timestamps.append(frame.get_time())
            if frame._gt_lidar_pose is not None and self._gt_pose_offset is not None:
                self._gt_path.append(
                    (self._gt_pose_offset * frame._gt_lidar_pose).matrix
                )

            if len(self._icp_only) > 1:
                relative = np.linalg.inv(self._icp_only[-2]) @ self._icp_only[-1]
            else:
                relative = tracked
            self._t_kf_to_frame = self._t_kf_to_frame @ relative
            self._frame_log.append(self._t_world_to_kf @ self._t_kf_to_frame)

        while self._keyframe_update_slot.has_value():
            state = self._keyframe_update_slot.get_value()
            if isinstance(state, StopSignal):
                self._frame_done = True
                break
            self._last_keyframe_state = state

            most_recent = state[-1]
            kf_time = most_recent["timestamp"]
            kf_pose = Pose.from_twist(most_recent["lidar_pose"])

            ts = np.asarray(self._timestamps)
            if len(ts) == 0:
                continue
            kf_idx = int(np.argmin(np.abs(ts - kf_time)))
            self._t_world_to_kf = kf_pose.matrix
            self._t_kf_to_frame = (
                np.linalg.inv(self._icp_only[kf_idx]) @ self._icp_only[-1]
            )

    def finish(self) -> None:
        self.update()
        os.makedirs(f"{self._log_directory}/trajectory", exist_ok=True)
        ts = np.asarray(self._timestamps)
        if len(ts) == 0:
            return
        icp = np.stack(self._icp_only)
        dump_trajectory_to_tum(
            icp, ts, f"{self._log_directory}/trajectory/tracking_only.txt"
        )
        dump_trajectory_to_tum(
            np.stack(self._frame_log),
            ts,
            f"{self._log_directory}/trajectory/online_estimates.txt",
        )
        if self._gt_path:
            dump_trajectory_to_tum(
                np.stack(self._gt_path),
                ts[: len(self._gt_path)],
                f"{self._log_directory}/trajectory/groundtruth.txt",
            )

        if self._last_keyframe_state is None:
            return

        kf_times = np.asarray(
            [kf["timestamp"] for kf in self._last_keyframe_state]
        )
        kf_traj = np.stack(
            [Pose.from_twist(kf["lidar_pose"]).matrix for kf in self._last_keyframe_state]
        )
        dump_trajectory_to_tum(
            kf_traj, kf_times, f"{self._log_directory}/trajectory/keyframe_trajectory.txt"
        )

        # Splice: each tracked pose re-expressed relative to the latest
        # optimized keyframe at or before it (reference
        # default_logger.py:117-149).
        kf_frame_indices = np.asarray(
            [int(np.argmin(np.abs(ts - t))) for t in kf_times]
        )
        reconstructed = []
        for pose_idx, pose in enumerate(icp):
            before = np.nonzero(kf_frame_indices <= pose_idx)[0]
            ref_kf = int(before[-1]) if len(before) else 0
            ref_frame_idx = kf_frame_indices[ref_kf]
            t_ref_p = np.linalg.inv(icp[ref_frame_idx]) @ pose
            reconstructed.append(kf_traj[ref_kf] @ t_ref_p)
        dump_trajectory_to_tum(
            np.stack(reconstructed),
            ts,
            f"{self._log_directory}/trajectory/estimated_trajectory.txt",
        )
