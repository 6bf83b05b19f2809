"""Mask a ground-truth map to the region a run actually observed.

Counterpart of ``examples/mask_gt_with_trajectory.py``, on the host (scipy's
``cKDTree``): keeps only the GT-map points within ``DIST_THRESHOLD`` (0.1 m) of
the reconstructed map, so completion and F-score are computed over the
LiDAR-visible region instead of penalizing geometry the sensor never saw.

    python -m loner_tpu_torch.analysis.mask_gt_with_trajectory gt_map.pcd \
        reconstructed_map.pcd out_masked.pcd [--dist_threshold 0.1] \
        [--merged_transform t00 t01 ... t33]
"""
from __future__ import annotations

import argparse

import numpy as np
from scipy.spatial import cKDTree

from loner_tpu_torch.analysis.renderer_lidar import read_pcd, write_pcd

DIST_THRESHOLD = 0.1  # meters


def mask_gt_map(
    gt_points: np.ndarray,
    reconstructed_points: np.ndarray,
    dist_threshold: float = DIST_THRESHOLD,
    transform: np.ndarray = None,
) -> np.ndarray:
    """GT points within ``dist_threshold`` of the reconstructed cloud.
    ``transform`` optionally re-poses the reconstruction first."""
    rec = np.asarray(reconstructed_points, np.float64)
    if transform is not None:
        rec = rec @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]
    dists, _ = cKDTree(rec).query(np.asarray(gt_points, np.float64))
    return np.asarray(gt_points)[dists < dist_threshold]


def main() -> None:
    p = argparse.ArgumentParser(description="Mask GT map by reconstruction")
    p.add_argument("groundtruth_map", help="GT map .pcd (create_lidar_map)")
    p.add_argument("reconstructed_map", help=".pcd from renderer_lidar / mesh_to_pcd")
    p.add_argument("output", help="output masked .pcd path")
    p.add_argument("--dist_threshold", type=float, default=DIST_THRESHOLD)
    p.add_argument(
        "--merged_transform", type=float, nargs=16, default=None,
        help="row-major 4x4 applied to the reconstruction before masking",
    )
    args = p.parse_args()

    gt = read_pcd(args.groundtruth_map)
    rec = read_pcd(args.reconstructed_map)
    tf = None if args.merged_transform is None else np.array(args.merged_transform).reshape(4, 4)
    masked = mask_gt_map(gt, rec, args.dist_threshold, tf)
    write_pcd(masked.astype(np.float32), args.output)
    print(f"Masked GT map: kept {masked.shape[0]}/{gt.shape[0]} points -> {args.output}")


if __name__ == "__main__":
    main()
