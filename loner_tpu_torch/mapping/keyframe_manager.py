"""Keyframe selection and active-window management.

Counterpart of ``loner_tpu/mapping/keyframe_manager.py``: TEMPORAL / MOTION /
HYBRID / HYBRID_LAZY keyframe gating, pose re-basing of new keyframes onto the
optimised reference, and MOST_RECENT / RANDOM / HYBRID window selection
(random keyframes plus the N most recent, recents last: the optimiser's
``latest_kf_only`` mask relies on that order). The window RNG is
``np.random.default_rng(seed)``, as in the JAX package, so both pick the same
windows for the same seed.
"""
from __future__ import annotations

from enum import Enum
from typing import List, Optional

import numpy as np

from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.mapping.keyframe import KeyFrame


class KeyFrameSelectionStrategy(Enum):
    TEMPORAL = 0
    MOTION = 1
    HYBRID = 2
    HYBRID_LAZY = 3


class WindowSelectionStrategy(Enum):
    MOST_RECENT = 0
    RANDOM = 1
    HYBRID = 2


class KeyFrameManager:
    def __init__(self, settings, seed: int = 0) -> None:
        self._settings = settings
        self._kf_strategy = KeyFrameSelectionStrategy[
            settings.keyframe_selection.strategy
        ]
        self._window_strategy = WindowSelectionStrategy[
            settings.window_selection.strategy
        ]
        self._last_accepted_frame_ts: Optional[float] = None
        self._last_motion_rejected_frame_ts: Optional[float] = None
        self._keyframes: List[KeyFrame] = []
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._keyframes)

    def process_frame(self, frame: Frame) -> Optional[KeyFrame]:
        """Gate the frame; on accept, re-base its pose onto the optimized
        reference keyframe and store it (reference keyframe_manager.py:67-120)."""
        if self._kf_strategy == KeyFrameSelectionStrategy.TEMPORAL:
            should_use = self._select_temporal(frame)
            temporal_met = should_use
        else:
            motion_met = self._select_motion(frame)
            temporal_met = self._select_temporal(frame)
            if temporal_met and not motion_met:
                self._last_motion_rejected_frame_ts = frame.get_time()
            if self._kf_strategy == KeyFrameSelectionStrategy.MOTION:
                should_use = motion_met
            else:
                should_use = motion_met and temporal_met

        new_keyframe = None
        if should_use:
            self._last_accepted_frame_ts = frame.get_time()
            new_keyframe = KeyFrame(frame)

            if self._keyframes:
                # T_new = T_ref_optimized @ (T_ref_tracked^-1 @ T_new_tracked)
                # (reference keyframe_manager.py:92-101)
                ref = self._keyframes[-1]
                t_track = ref._tracked_lidar_pose.inv() * new_keyframe._tracked_lidar_pose
                # Keyframe-owned pose: never write into the shared Frame
                # (the logger still reads its tracked pose).
                new_keyframe.set_lidar_pose(ref.get_lidar_pose() * t_track)
            self._keyframes.append(new_keyframe)

        if self._kf_strategy == KeyFrameSelectionStrategy.HYBRID:
            if temporal_met:
                self._last_accepted_frame_ts = frame.get_time()
            # HYBRID re-processes the previous keyframe when the temporal
            # criterion fires but motion doesn't (keyframe_manager.py:105-117).
            return self._keyframes[-1] if temporal_met and self._keyframes else None

        return new_keyframe

    def get_last_mapped_time(self) -> Optional[float]:
        if (
            self._kf_strategy
            in (KeyFrameSelectionStrategy.HYBRID_LAZY, KeyFrameSelectionStrategy.MOTION)
            and self._last_motion_rejected_frame_ts is not None
        ):
            return max(self._last_motion_rejected_frame_ts, self._last_accepted_frame_ts)
        return self._last_accepted_frame_ts

    def _select_temporal(self, frame: Frame) -> bool:
        if not self._keyframes:
            return True
        dt = frame.get_time() - self._last_accepted_frame_ts
        return dt >= self._settings.keyframe_selection.temporal.time_diff_seconds

    def _select_motion(self, frame: Frame) -> bool:
        if not self._keyframes:
            return True
        ref_pose = self._keyframes[-1].get_lidar_pose()
        d_t, d_r = ref_pose.distance_to(frame.get_lidar_pose())
        m = self._settings.keyframe_selection.motion
        return d_t >= m.translation_threshold_m or d_r >= m.rotation_threshold_deg

    def get_keyframes(self, idxs: Optional[List[int]] = None) -> List[KeyFrame]:
        if idxs is None:
            return self._keyframes
        return [self._keyframes[i] for i in idxs]

    def get_active_window(self) -> List[KeyFrame]:
        """Window selection (reference keyframe_manager.py:164-187); recents
        are always LAST so slot W-1 is the newest keyframe."""
        window_size = self._settings.window_selection.window_size
        n = len(self._keyframes)

        if self._window_strategy == WindowSelectionStrategy.MOST_RECENT:
            return self._keyframes[-window_size:]

        if self._window_strategy == WindowSelectionStrategy.RANDOM:
            num_recent = 1
        else:  # HYBRID
            num_recent = self._settings.window_selection.hybrid_settings.num_recent_frames
        num_recent = min(num_recent, n, window_size)

        pool = n - num_recent
        take = min(window_size - num_recent, pool)
        indices = list(self._rng.permutation(pool)[:take])
        indices += list(range(n - num_recent, n))
        return [self._keyframes[int(i)] for i in indices]

    def get_poses_state(self) -> List[dict]:
        return [kf.get_pose_state() for kf in self._keyframes]

    def restore(self, keyframes: List[KeyFrame]) -> None:
        """Mid-run resume: adopt checkpoint-rebuilt keyframes. Gating
        state (temporal/motion anchors) resumes from the newest one."""
        self._keyframes = list(keyframes)
        if self._keyframes:
            self._last_accepted_frame_ts = self._keyframes[-1].get_time()
