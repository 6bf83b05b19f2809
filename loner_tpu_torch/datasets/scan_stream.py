"""On-disk scan-stream dataset.

Counterpart of ``loner_tpu/datasets/scan_stream.py``: a directory of npz scans
and a TUM ground-truth trajectory,

    <dataset>/
      meta.yaml                # sensor metadata (optional)
      scans/scan_000000.npz    # directions (3,N) f32, distances (N,) f32,
      ...                      #   timestamps (N,) f64 (sorted)
      poses_gt.tum             # optional GT trajectory (TUM format)
      images/image_000000.npz  # optional camera frames: image (H,W,C) f32 in
      ...                      #   [0, 1], timestamp f64

``meta.yaml`` is written as JSON text that YAML loaders read to the same values
(``common/json_yaml.py``) and read by the port's own YAML reader, so either
package reads the other's datasets, images included.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from loner_tpu_torch.common.json_yaml import read_json_yaml, write_json_yaml
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import LidarScan
from loner_tpu_torch.common.trajectory import (
    TrajectoryInterpolator,
    dump_trajectory_to_tum,
    load_tum_trajectory,
)


class ScanStreamWriter:
    def __init__(self, root: str, meta: Optional[dict] = None) -> None:
        self._root = root
        os.makedirs(os.path.join(root, "scans"), exist_ok=True)
        self._count = 0
        if meta:
            write_json_yaml(os.path.join(root, "meta.yaml"), meta)

    def add_scan(self, scan: LidarScan) -> None:
        path = os.path.join(self._root, "scans", f"scan_{self._count:06d}.npz")
        np.savez_compressed(
            path,
            directions=scan.ray_directions,
            distances=scan.distances,
            timestamps=scan.timestamps,
        )
        self._count += 1

    def add_image(self, image: np.ndarray, timestamp: float) -> None:
        """A camera frame for the intensity supervision: (H, W, C) float in
        [0, 1] at ``timestamp``. A LiDAR-only stream never calls this."""
        img_dir = os.path.join(self._root, "images")
        os.makedirs(img_dir, exist_ok=True)
        n = len([f for f in os.listdir(img_dir) if f.endswith(".npz")])
        np.savez_compressed(os.path.join(img_dir, f"image_{n:06d}.npz"),
                            image=np.asarray(image, np.float32), timestamp=np.float64(timestamp))

    def write_gt(self, poses: np.ndarray, timestamps: np.ndarray) -> None:
        dump_trajectory_to_tum(poses, timestamps, os.path.join(self._root, "poses_gt.tum"))


class ScanStreamReader:
    """Iterates (LidarScan, Optional[Pose gt]) in time order."""

    def __init__(self, root: str) -> None:
        self._root = root
        scan_dir = os.path.join(root, "scans")
        self._scan_files = sorted(
            os.path.join(scan_dir, f) for f in os.listdir(scan_dir) if f.endswith(".npz")
        )
        gt_path = os.path.join(root, "poses_gt.tum")
        self._gt: Optional[TrajectoryInterpolator] = None
        if os.path.exists(gt_path):
            poses, ts = load_tum_trajectory(gt_path)
            self._gt = TrajectoryInterpolator(poses, ts)
        self.meta = {}
        meta_path = os.path.join(root, "meta.yaml")
        if os.path.exists(meta_path):
            self.meta = read_json_yaml(meta_path) or {}
        self._time_spans: Optional[np.ndarray] = None
        self._image_files: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self._scan_files)

    @property
    def gt_interpolator(self) -> Optional[TrajectoryInterpolator]:
        return self._gt

    def gt_poses(self) -> Optional[np.ndarray]:
        if self._gt is None:
            return None
        return self._gt._poses

    def read_scan(self, idx: int) -> LidarScan:
        data = np.load(self._scan_files[idx])
        return LidarScan(data["directions"], data["distances"], data["timestamps"])

    def time_spans(self) -> np.ndarray:
        """(len(self), 2) raw [start, end] time per scan, reading only each
        npz's timestamps member, cached after the first call."""
        if self._time_spans is None:
            spans = []
            for f in self._scan_files:
                ts = np.load(f)["timestamps"]
                spans.append((float(ts[0]), float(ts[-1])))
            self._time_spans = np.asarray(spans)
        return self._time_spans

    def start_times(self) -> np.ndarray:
        """(len(self),) scan start times (cached; see time_spans)."""
        return self.time_spans()[:, 0]

    def has_images(self) -> bool:
        return bool(self.image_files())

    def image_files(self) -> List[str]:
        """The image files, in name (time) order; [] without an images directory."""
        if self._image_files is None:
            img_dir = os.path.join(self._root, "images")
            self._image_files = sorted(
                os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith(".npz")
            ) if os.path.isdir(img_dir) else []
        return self._image_files

    def read_image(self, idx: int) -> Tuple[np.ndarray, float]:
        """(image (H, W, C) float32, timestamp)."""
        data = np.load(self.image_files()[idx])
        return data["image"], float(data["timestamp"])

    def read_image_timestamp(self, idx: int) -> float:
        """The image's timestamp, without decoding its pixels."""
        return float(np.load(self.image_files()[idx])["timestamp"])

    def __iter__(self) -> Iterator[Tuple[LidarScan, Optional[Pose]]]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Tuple[LidarScan, Optional[Pose]]]:
        """(scan, GT pose or None) from scan ``start`` on."""
        for i in range(start, len(self)):
            scan = self.read_scan(i)
            gt = None
            if self._gt is not None and self._gt.contains(scan.get_start_time()):
                gt = self._gt.at(scan.get_start_time())
            yield scan, gt


def apply_fov_mask(scan: LidarScan, fov_ranges_deg: List[List[float]]) -> LidarScan:
    """Keep only rays whose azimuth falls in the given degree ranges."""
    azim = np.rad2deg(np.arctan2(scan.ray_directions[1], scan.ray_directions[0])) % 360.0
    keep = np.zeros(len(scan), dtype=bool)
    for lo, hi in fov_ranges_deg:
        keep |= (azim >= lo) & (azim <= hi)
    return LidarScan(scan.ray_directions[:, keep], scan.distances[keep], scan.timestamps[keep])
