"""Trajectory utilities: TUM-format IO and timestamped pose interpolation.

Counterpart of ``loner_tpu/common/trajectory.py``. TUM rows are
``ts x y z qx qy qz qw``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation as _R
from scipy.spatial.transform import Slerp

from loner_tpu_torch.common.pose import Pose


def dump_trajectory_to_tum(
    transformation_matrices: np.ndarray, timestamps: np.ndarray, output_file: str
) -> None:
    """(N, 4, 4) poses + (N,) timestamps -> TUM text file."""
    mats = np.asarray(transformation_matrices, dtype=np.float64)
    ts = np.asarray(timestamps, dtype=np.float64).reshape(-1, 1)
    translations = mats[:, :3, 3]
    quats_xyzw = _R.from_matrix(mats[:, :3, :3]).as_quat()
    data = np.hstack([ts, translations, quats_xyzw])
    np.savetxt(output_file, data, delimiter=" ", fmt="%.10f")


def load_tum_trajectory(filename: str, zero_origin: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """TUM file -> ((N, 4, 4) poses, (N,) timestamps)."""
    data = np.loadtxt(filename, dtype=np.float64)
    if data.ndim == 1:
        data = data[None, :]
    ts = data[:, 0]
    mats = np.tile(np.eye(4), (data.shape[0], 1, 1))
    mats[:, :3, 3] = data[:, 1:4]
    mats[:, :3, :3] = _R.from_quat(data[:, 4:8]).as_matrix()
    if zero_origin:
        mats = np.linalg.inv(mats[0])[None] @ mats
    return mats, ts


class TrajectoryInterpolator:
    """Slerp/lerp pose lookup at arbitrary timestamps (GT pose provider)."""

    def __init__(self, poses: np.ndarray, timestamps: np.ndarray) -> None:
        order = np.argsort(timestamps)
        self._ts = np.asarray(timestamps, dtype=np.float64)[order]
        self._poses = np.asarray(poses, dtype=np.float64)[order]
        self._slerp = Slerp(self._ts, _R.from_matrix(self._poses[:, :3, :3]))

    def contains(self, t: float) -> bool:
        return self._ts[0] <= t <= self._ts[-1]

    def at(self, t: float) -> Pose:
        t = float(np.clip(t, self._ts[0], self._ts[-1]))
        rot = self._slerp([t]).as_matrix()[0]
        idx = np.searchsorted(self._ts, t)
        idx = np.clip(idx, 1, len(self._ts) - 1)
        t0, t1 = self._ts[idx - 1], self._ts[idx]
        alpha = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        trans = (1 - alpha) * self._poses[idx - 1, :3, 3] + alpha * self._poses[idx, :3, 3]
        mat = np.eye(4)
        mat[:3, :3] = rot
        mat[:3, 3] = trans
        return Pose(mat)
