"""Map-quality metrics: estimated against ground-truth point cloud.

Counterpart of ``loner_tpu/analysis/evaluate_lidar_map.py``: voxel-downsample
both clouds, refine the alignment with the port's point-to-plane ICP
(``tracking/icp.py::run_icp_schedule``, two stages at 0.5 m and 0.1 m, 8192
points a cloud) on the tool's device, then compute accuracy / completion /
chamfer and precision / recall / F-score at a threshold (0.1 m by default) from
nearest-neighbour distances (scipy's ``cKDTree`` on the host, as the JAX
package does), writing ``metrics/statistics.yaml`` as JSON text.

    python -m loner_tpu_torch.analysis.evaluate_lidar_map <est.pcd|.npy> <gt.pcd|.npy> \
        [--log_dir <logdir>] [--device cpu]
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.common.device import resolve_device
from loner_tpu_torch.common.json_yaml import write_json_yaml
from loner_tpu_torch.ops.voxel import voxel_downsample
from loner_tpu_torch.tracking.icp import run_icp_schedule

ICP_SCHEDULE = [{"threshold": 0.5, "max_iterations": 20}, {"threshold": 0.1, "max_iterations": 20}]


def _nn_dists(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """For each query point, distance to the nearest ref point (meters)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(ref, np.float64))
    d, _ = tree.query(np.asarray(query, np.float64), k=1)
    return d.astype(np.float64)


def evaluate_lidar_map(
    est_points: np.ndarray,
    gt_points: np.ndarray,
    voxel_size: float = 0.05,
    f_score_threshold: float = 0.1,
    refine_alignment: bool = True,
    log_dir: Optional[str] = None,
    device: Union[torch.device, str, None] = None,
) -> dict:
    """``device`` runs the alignment ICP: ``cuda`` by default, raising without a
    card (pass ``device="cpu"``)."""
    est = voxel_downsample(est_points, voxel_size)
    gt = voxel_downsample(gt_points, voxel_size)

    if refine_alignment:
        result = run_icp_schedule(est, gt, ICP_SCHEDULE, pad_size=8192,
                                  device=resolve_device(device))
        t = result.transformation.cpu().numpy().astype(np.float64)
        est = est @ t[:3, :3].T + t[:3, 3]

    d_est_to_gt = _nn_dists(est, gt)  # accuracy
    d_gt_to_est = _nn_dists(gt, est)  # completion

    accuracy = float(d_est_to_gt.mean())
    completion = float(d_gt_to_est.mean())
    chamfer = accuracy + completion
    precision = float((d_est_to_gt < f_score_threshold).mean())
    recall = float((d_gt_to_est < f_score_threshold).mean())
    f_score = (
        2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    )

    stats = {
        "accuracy": accuracy,
        "completion": completion,
        "chamfer": chamfer,
        "precision": precision,
        "recall": recall,
        "f_score": f_score,
        "threshold": f_score_threshold,
        "num_est_points": int(est.shape[0]),
        "num_gt_points": int(gt.shape[0]),
    }
    if log_dir is not None:
        os.makedirs(os.path.join(log_dir, "metrics"), exist_ok=True)
        write_json_yaml(os.path.join(log_dir, "metrics", "statistics.yaml"), stats)
    return stats


def load_cloud(path: str) -> np.ndarray:
    """A .npy or ASCII .pcd point cloud."""
    from loner_tpu_torch.analysis.renderer_lidar import read_pcd

    return np.load(path) if path.endswith(".npy") else read_pcd(path)


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description="Map accuracy/completion metrics")
    p.add_argument("estimated_map", help=".pcd or .npy point cloud")
    p.add_argument("groundtruth_map", help=".pcd or .npy point cloud")
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--threshold", type=float, default=0.1)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the ICP (default: cuda; raises without a card)")
    args = p.parse_args()
    stats = evaluate_lidar_map(
        load_cloud(args.estimated_map),
        load_cloud(args.groundtruth_map),
        voxel_size=args.voxel_size,
        f_score_threshold=args.threshold,
        log_dir=args.log_dir,
        device=args.device,
    )
    print(json.dumps(stats, indent=1))
