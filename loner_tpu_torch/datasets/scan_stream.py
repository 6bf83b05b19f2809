"""On-disk scan-stream dataset.

Counterpart of ``loner_tpu/datasets/scan_stream.py``: a directory of npz scans
and a TUM ground-truth trajectory,

    <dataset>/
      meta.yaml                # sensor metadata (optional)
      scans/scan_000000.npz    # directions (3,N) f32, distances (N,) f32,
      ...                      #   timestamps (N,) f64 (sorted)
      poses_gt.tum             # optional GT trajectory (TUM format)

``yaml`` is imported only to write ``meta.yaml`` when asked, or to read it
when it is there. Camera images are not read: the camera branch is not ported.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

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
            import yaml

            with open(os.path.join(root, "meta.yaml"), "w") as f:
                yaml.safe_dump(meta, f)

    def add_scan(self, scan: LidarScan) -> None:
        path = os.path.join(self._root, "scans", f"scan_{self._count:06d}.npz")
        np.savez_compressed(
            path,
            directions=scan.ray_directions,
            distances=scan.distances,
            timestamps=scan.timestamps,
        )
        self._count += 1

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
            import yaml

            with open(meta_path) as f:
                self.meta = yaml.safe_load(f) or {}
        self._time_spans: Optional[np.ndarray] = None

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
        img_dir = os.path.join(self._root, "images")
        return os.path.isdir(img_dir) and any(f.endswith(".npz") for f in os.listdir(img_dir))

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
