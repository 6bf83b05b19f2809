"""Build a ground-truth reference map cloud from a dataset.

Counterpart of ``examples/create_lidar_map.py``, on the host (numpy):
accumulates scans posed at slerp-interpolated ground-truth poses (zeroed at the
first scan, the SLAM frame) into a voxel-downsampled reference point cloud, the
target of the map-quality evaluation (``analysis/evaluate_lidar_map.py``).

    python -m loner_tpu_torch.analysis.create_lidar_map <dataset_dir> out_map.pcd \
        [--voxel_size 0.05] [--skip 1] [--max_range 60]
"""
from __future__ import annotations

import argparse

import numpy as np

from loner_tpu_torch.analysis.renderer_lidar import write_pcd
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
from loner_tpu_torch.ops.voxel import voxel_downsample


def build_gt_map(
    dataset_dir: str,
    voxel_size: float = 0.05,
    skip: int = 1,
    max_range: float = 60.0,
    zero_origin: bool = True,
) -> np.ndarray:
    reader = ScanStreamReader(dataset_dir)
    interp = reader.gt_interpolator
    if interp is None:
        raise SystemExit(f"{dataset_dir} has no poses_gt.tum ground truth")

    offset = None
    clouds = []
    for i in range(0, len(reader), skip):
        scan = reader.read_scan(i)
        t = scan.get_start_time()
        if not interp.contains(t):
            continue
        pose = interp.at(t)
        if offset is None and zero_origin:
            offset = pose.inv()
        if offset is not None:
            pose = offset * pose
        keep = scan.distances < max_range
        pts = (scan.ray_directions[:, keep] * scan.distances[keep]).T
        clouds.append(voxel_downsample(pose.transform_points(pts), voxel_size))
    return voxel_downsample(np.concatenate(clouds, axis=0), voxel_size)


def main() -> None:
    p = argparse.ArgumentParser(description="Build a ground-truth map cloud from a dataset")
    p.add_argument("dataset_dir")
    p.add_argument("out_file", help=".pcd or .npy")
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--skip", type=int, default=1)
    p.add_argument("--max_range", type=float, default=60.0)
    args = p.parse_args()

    pts = build_gt_map(args.dataset_dir, args.voxel_size, args.skip, args.max_range)
    if args.out_file.endswith(".npy"):
        np.save(args.out_file, pts)
    else:
        write_pcd(pts, args.out_file)
    print(f"GT map: {pts.shape[0]} points -> {args.out_file}")


if __name__ == "__main__":
    main()
