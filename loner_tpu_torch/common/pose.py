"""Host-side rigid transform, as far as checkpoint pose states need it.

Counterpart of ``loner_tpu/common/pose.py``: a checkpoint stores each keyframe
pose as a twist ``[t (3), axis-angle (3)]``; ``Pose`` turns it into a 4x4
float64 matrix and back (numpy and scipy only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation as _R


class Pose:
    """Immutable rigid transform, stored as a 4x4 float64 numpy matrix."""

    __slots__ = ("_matrix",)

    def __init__(self, matrix: Optional[np.ndarray] = None):
        matrix = np.eye(4) if matrix is None else np.asarray(matrix, dtype=np.float64)
        if matrix.shape != (4, 4):
            raise ValueError(f"a pose is a 4x4 matrix, got shape {matrix.shape}")
        self._matrix = matrix

    @staticmethod
    def from_twist(twist: np.ndarray) -> "Pose":
        twist = np.asarray(twist, dtype=np.float64)
        mat = np.eye(4)
        mat[:3, :3] = _R.from_rotvec(twist[3:]).as_matrix()
        mat[:3, 3] = twist[:3]
        return Pose(mat)

    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    def to_twist(self) -> np.ndarray:
        axis_angle = _R.from_matrix(self._matrix[:3, :3]).as_rotvec()
        return np.concatenate([self._matrix[:3, 3], axis_angle])
