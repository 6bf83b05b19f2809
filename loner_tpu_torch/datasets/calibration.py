"""Calibration files in OpenCV's YAML form, read without cv2 or PyYAML.

Counterpart of ``loner_tpu/datasets/calibration.py``: the LiDAR-to-camera
extrinsic and the stereo intrinsics (K, distortion, rectified projection) of a
Fusion Portable calibration directory, K scaled by an image scale factor, in
the dict shape the settings tree takes (``calibration.lidar_to_camera`` /
``calibration.camera_intrinsic``). Host numpy only; the YAML is read by the
port's own reader (``common/yaml_lite.py``).
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from loner_tpu_torch.common import yaml_lite


def load_opencv_yaml(path: str) -> dict:
    """An OpenCV YAML file as a dict, each ``rows``/``cols``/``data`` matrix an
    (rows, cols) float64 array. The ``%YAML`` directive, the ``---`` after it and
    the ``!!opencv-matrix`` tags are stripped first, as the JAX package strips
    them; the YAML reader takes the rest."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML.*\n(---)?\n?", "", text)
    text = text.replace("!!opencv-matrix", "")
    data = yaml_lite.loads(text, path)

    def conv(v):
        if isinstance(v, dict) and {"rows", "cols", "data"} <= set(v.keys()):
            return np.asarray(v["data"], np.float64).reshape(v["rows"], v["cols"])
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return conv(data)


class FusionPortableCalibration:
    """The Fusion Portable calibration layout: ``<calib>/calib/ouster00.yaml``
    (extrinsics), ``frame_left.yaml`` / ``frame_right.yaml`` (intrinsics,
    distortion, rectified P); ``<calib>`` itself when it has no ``calib/``."""

    def __init__(self, calib_path: str, image_scale_factor: float = 1.0) -> None:
        calib_dir = os.path.join(calib_path, "calib")
        if not os.path.isdir(calib_dir):
            calib_dir = calib_path

        self.t_lidar_to_left_cam = {"xyz": [0, 0, 0], "orientation": [0, 0, 0, 1]}
        ouster = os.path.join(calib_dir, "ouster00.yaml")
        if os.path.exists(ouster):
            data = load_opencv_yaml(ouster)
            q = data.get("quaternion_sensor_frame_cam00", None)
            t = data.get("translation_sensor_frame_cam00", None)
            if q is not None and t is not None:
                q = np.asarray(q).reshape(-1)  # qw qx qy qz (OpenCV's order)
                self.t_lidar_to_left_cam = {
                    "xyz": np.asarray(t).reshape(-1).tolist(),
                    "orientation": [float(q[1]), float(q[2]), float(q[3]), float(q[0])],
                }

        self.left_cam_intrinsic = self._load_cam(
            os.path.join(calib_dir, "frame_left.yaml"), image_scale_factor)
        self.right_cam_intrinsic = self._load_cam(
            os.path.join(calib_dir, "frame_right.yaml"), image_scale_factor)

    @staticmethod
    def _load_cam(path: str, scale: float) -> Optional[dict]:
        if not os.path.exists(path):
            return None
        data = load_opencv_yaml(path)
        k = np.asarray(data["camera_matrix"], np.float64)
        dist = np.asarray(data["distortion_coefficients"], np.float64).reshape(-1)
        width = int(data.get("image_width", 0) * scale)
        height = int(data.get("image_height", 0) * scale)
        k_scaled = k.copy()
        k_scaled[:2] *= scale
        new_k = None
        if "projection_matrix" in data:
            p = np.asarray(data["projection_matrix"], np.float64)
            new_k = p[:3, :3].copy()
            new_k[:2] *= scale
        return {"k": k_scaled, "distortion": dist, "new_k": new_k, "width": width,
                "height": height}

    def apply_to_settings(self, settings) -> None:
        """Put the extrinsic, and the left camera's intrinsics when there are
        any, into the settings tree's ``calibration``."""
        settings["calibration"]["lidar_to_camera"] = self.t_lidar_to_left_cam
        if self.left_cam_intrinsic is not None:
            settings["calibration"]["camera_intrinsic"] = self.left_cam_intrinsic
