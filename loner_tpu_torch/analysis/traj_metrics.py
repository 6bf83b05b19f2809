"""Trajectory metrics: ATE and RPE with evo's semantics.

Counterpart of the numpy part of ``loner_tpu/analysis/traj_metrics.py``:
timestamp association, SE(3) Umeyama alignment, ATE RMSE and RPE at a
distance delta, from TUM files.

    python -m loner_tpu_torch.analysis.traj_metrics <estimated.txt> <groundtruth.txt>
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation as _R


def associate(
    ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Match trajectory timestamps (evo's association semantics)."""
    idx_b = np.searchsorted(ts_b, ts_a)
    idx_b = np.clip(idx_b, 1, len(ts_b) - 1)
    left, right = ts_b[idx_b - 1], ts_b[idx_b]
    nearest = np.where(np.abs(ts_a - left) < np.abs(ts_a - right), idx_b - 1, idx_b)
    keep = np.abs(ts_b[nearest] - ts_a) <= max_diff
    return np.nonzero(keep)[0], nearest[keep]


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> np.ndarray:
    """Least-squares SE(3) (or Sim(3)) alignment src -> dst; (4, 4)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    s_c, d_c = src - mu_s, dst - mu_d
    cov = d_c.T @ s_c / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    if with_scale:
        var = (s_c ** 2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s) / var
    else:
        scale = 1.0
    t = mu_d - scale * rot @ mu_s
    out = np.eye(4)
    out[:3, :3] = scale * rot
    out[:3, 3] = t
    return out


@dataclass
class APEResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float

    def as_dict(self) -> dict:
        return {k: float(getattr(self, k)) for k in ("rmse", "mean", "median", "std", "min", "max")}


def _stats(err: np.ndarray) -> APEResult:
    return APEResult(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        min=float(err.min()),
        max=float(err.max()),
    )


def ate(
    est_poses: np.ndarray,
    est_ts: np.ndarray,
    gt_poses: np.ndarray,
    gt_ts: np.ndarray,
    align: bool = True,
    max_diff: float = 0.02,
) -> APEResult:
    """Absolute trajectory error (translation), evo_ape semantics."""
    ia, ib = associate(est_ts, gt_ts, max_diff)
    p_est = est_poses[ia, :3, 3]
    p_gt = gt_poses[ib, :3, 3]
    if align:
        t = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ t[:3, :3].T + t[:3, 3]
    return _stats(np.linalg.norm(p_est - p_gt, axis=-1))


def rpe(
    est_poses: np.ndarray,
    est_ts: np.ndarray,
    gt_poses: np.ndarray,
    gt_ts: np.ndarray,
    delta_m: float = 3.0,
    rotation: bool = False,
    max_diff: float = 0.02,
) -> APEResult:
    """Relative pose error over segments of path length delta_m
    (evo_rpe --delta 3 --delta_unit m semantics; rotation in degrees)."""
    ia, ib = associate(est_ts, gt_ts, max_diff)
    est, gt = est_poses[ia], gt_poses[ib]

    # Pair indices separated by ~delta_m of GT path length.
    dists = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1))]
    )
    pairs = []
    start = 0
    for i in range(1, len(dists)):
        if dists[i] - dists[start] >= delta_m:
            pairs.append((start, i))
            start = i
    if not pairs:
        pairs = [(0, len(gt) - 1)]

    errors = []
    for i, j in pairs:
        d_est = np.linalg.inv(est[i]) @ est[j]
        d_gt = np.linalg.inv(gt[i]) @ gt[j]
        e = np.linalg.inv(d_gt) @ d_est
        if rotation:
            errors.append(np.rad2deg(np.linalg.norm(_R.from_matrix(e[:3, :3]).as_rotvec())))
        else:
            errors.append(np.linalg.norm(e[:3, 3]))
    return _stats(np.asarray(errors))


def evaluate_trajectory_files(
    est_file: str,
    gt_file: str,
    delta_m: float = 3.0,
) -> dict:
    """ATE + RPE(trans) + RPE(rot) from two TUM files (the analyze.sh
    equivalent, reference compute_metrics/traj/analyze.sh:8-24)."""
    from loner_tpu_torch.common.trajectory import load_tum_trajectory

    est_poses, est_ts = load_tum_trajectory(est_file)
    gt_poses, gt_ts = load_tum_trajectory(gt_file)
    return {
        "ate": ate(est_poses, est_ts, gt_poses, gt_ts).as_dict(),
        "rpe_trans": rpe(est_poses, est_ts, gt_poses, gt_ts, delta_m).as_dict(),
        "rpe_rot": rpe(est_poses, est_ts, gt_poses, gt_ts, delta_m, rotation=True).as_dict(),
    }


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description="ATE/RPE from TUM trajectory files")
    p.add_argument("estimated")
    p.add_argument("groundtruth")
    p.add_argument("--delta_m", type=float, default=3.0)
    args = p.parse_args()
    print(json.dumps(evaluate_trajectory_files(args.estimated, args.groundtruth, args.delta_m),
                     indent=2))
