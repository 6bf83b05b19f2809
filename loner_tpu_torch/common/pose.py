"""Host-side rigid transform.

Counterpart of ``loner_tpu/common/pose.py``: a plain immutable value type, a
4x4 float64 numpy matrix (numpy and scipy only). Poses that take part in the
optimisation live as rows of a ``(W, 6)`` twist tensor on the device instead;
a twist is ``[t (3), axis-angle (3)]``.
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

    # -- constructors -------------------------------------------------------
    @staticmethod
    def identity() -> "Pose":
        return Pose(np.eye(4))

    @staticmethod
    def from_twist(twist: np.ndarray) -> "Pose":
        twist = np.asarray(twist, dtype=np.float64)
        mat = np.eye(4)
        mat[:3, :3] = _R.from_rotvec(twist[3:]).as_matrix()
        mat[:3, 3] = twist[:3]
        return Pose(mat)

    @staticmethod
    def from_settings(pose_dict: dict) -> "Pose":
        """From ``{xyz: [...], orientation: [x, y, z, w]}``; the quaternion is
        read as xyzw, as the JAX package reads it."""
        mat = np.eye(4)
        mat[:3, :3] = _R.from_quat(np.asarray(pose_dict["orientation"], np.float64)).as_matrix()
        mat[:3, 3] = np.asarray(pose_dict["xyz"], np.float64)
        return Pose(mat)

    # -- accessors -----------------------------------------------------------
    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    def get_translation(self) -> np.ndarray:
        return self._matrix[:3, 3]

    def get_rotation(self) -> np.ndarray:
        return self._matrix[:3, :3]

    def get_axis_angle(self) -> np.ndarray:
        return _R.from_matrix(self._matrix[:3, :3]).as_rotvec()

    def to_twist(self) -> np.ndarray:
        return np.concatenate([self._matrix[:3, 3], self.get_axis_angle()])

    # -- algebra -------------------------------------------------------------
    def __mul__(self, other: "Pose") -> "Pose":
        return Pose(self._matrix @ other._matrix)

    def inv(self) -> "Pose":
        r, t = self._matrix[:3, :3], self._matrix[:3, 3]
        out = np.eye(4)
        out[:3, :3] = r.T
        out[:3, 3] = -r.T @ t
        return Pose(out)

    def clone(self) -> "Pose":
        return Pose(self._matrix.copy())

    def orthonormalized(self) -> "Pose":
        """Nearest SE(3) element: SVD-project the rotation block. A chain that
        composes device-computed registrations must re-project after each
        product, or its rotation block walks off the manifold."""
        u, _, vt = np.linalg.svd(self._matrix[:3, :3])
        rot = u @ vt
        if np.linalg.det(rot) < 0:
            rot = (u * np.array([1.0, 1.0, -1.0])) @ vt
        out = np.eye(4)
        out[:3, :3] = rot
        out[:3, 3] = self._matrix[:3, 3]
        return Pose(out)

    def transform_points(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self._matrix[:3, :3].T + self._matrix[:3, 3]

    def distance_to(self, other: "Pose") -> tuple:
        """(translation_m, rotation_deg) between two poses."""
        rel = self.inv() * other
        d_t = float(np.linalg.norm(rel.get_translation()))
        d_r = float(np.rad2deg(np.linalg.norm(rel.get_axis_angle())))
        return d_t, d_r

    def __repr__(self) -> str:
        return f"Pose({self._matrix})"
