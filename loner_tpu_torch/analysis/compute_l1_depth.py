"""L1 depth metric: render the model's depth along real scan rays, compare.

Counterpart of ``loner_tpu/analysis/compute_l1_depth.py``: picks N random scans
of the dataset, renders the model's expected depth along each scan's own ray
directions at the estimated (or ground-truth) keyframe trajectory interpolated
at the scan's time, and writes ``metrics/l1.yaml`` (JSON text) with {min, max,
mean, rmse, num_rays} of |rendered - measured|. The frames and rays are the
same numpy draws from the same seeds as the JAX package's; the frames render
one after another on one device.

    python -m loner_tpu_torch.analysis.compute_l1_depth <experiment_directory> \
        [--dataset_path <dir>] [--device cpu]
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from loner_tpu_torch.analysis.render_utils import (
    kf_pose_matrices,
    load_experiment,
    render_depth_chunked,
)
from loner_tpu_torch.common.json_yaml import write_json_yaml
from loner_tpu_torch.common.trajectory import TrajectoryInterpolator
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader


def l1_rays(reader: ScanStreamReader, interp: TrajectoryInterpolator,
            ray_range: Tuple[float, float], num_frames: int = 25,
            rays_per_frame: int = 2048, seed: int = 0) -> Iterator[tuple]:
    """The metric's draws: ``num_frames`` random scans, ``rays_per_frame`` random
    rays of each with a measured depth inside ``ray_range``, for the scans whose
    start time ``interp`` covers. Yields (frame id, start time, the
    interpolated 4x4 pose, (n, 3) sensor-frame directions, (n,) depths)."""
    rng = np.random.default_rng(seed)
    frame_ids = rng.choice(len(reader), min(num_frames, len(reader)), replace=False)
    for fid in frame_ids:
        frng = np.random.default_rng(seed + 1000 + int(fid))
        scan = reader.read_scan(int(fid))
        t = scan.get_start_time()
        if not interp.contains(t):
            continue
        idx = frng.choice(len(scan), min(rays_per_frame, len(scan)), replace=False)
        dirs_s = scan.ray_directions[:, idx].T
        gt = scan.distances[idx]
        keep = (gt > ray_range[0]) & (gt < ray_range[1])
        if keep.sum() == 0:
            continue
        yield int(fid), t, interp.at(t).matrix, dirs_s[keep], gt[keep]


def compute_l1_depth(
    log_dir: str,
    dataset_path: Optional[str] = None,
    ckpt_name: str = "final.tar",
    num_frames: int = 25,
    rays_per_frame: int = 2048,
    use_gt_poses: bool = False,
    n_samples: int = 1024,
    seed: int = 0,
    write: bool = True,
    device: Union[torch.device, str, None] = None,
) -> dict:
    """``device`` defaults to ``cuda`` and raises without a card (pass
    ``device="cpu"``)."""
    model = load_experiment(log_dir, ckpt_name, device=device)
    dataset_path = dataset_path or model.settings["dataset_path"]
    reader = ScanStreamReader(dataset_path)
    ray_range = tuple(
        float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"])

    # Pose provider: the estimated keyframe trajectory (or the GT one)
    # interpolated at scan timestamps.
    mats, ts = kf_pose_matrices(model, use_gt=use_gt_poses)
    interp = TrajectoryInterpolator(mats, ts)

    errors = []
    for _, _, pose, dirs_s, gt in l1_rays(reader, interp, ray_range, num_frames,
                                          rays_per_frame, seed):
        dirs_w = dirs_s @ pose[:3, :3].T
        origins = np.broadcast_to(pose[:3, 3], dirs_w.shape)
        out = render_depth_chunked(
            model, origins, dirs_w, ray_range, n_samples=n_samples, ret_var=False
        )
        errors.append(np.abs(out["depth"] - gt))

    all_err = np.concatenate(errors)
    result = {
        "min": float(all_err.min()),
        "max": float(all_err.max()),
        "mean": float(all_err.mean()),
        "rmse": float(np.sqrt((all_err ** 2).mean())),
        "num_rays": int(all_err.shape[0]),
    }
    if write:
        os.makedirs(os.path.join(log_dir, "metrics"), exist_ok=True)
        write_json_yaml(os.path.join(log_dir, "metrics", "l1.yaml"), result)
    return result


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description="L1 depth metric")
    p.add_argument("experiment_directory")
    p.add_argument("--dataset_path", default=None)
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--num_frames", type=int, default=25)
    p.add_argument("--use_gt_poses", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without a card, ask for cpu)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    res = compute_l1_depth(
        args.experiment_directory,
        args.dataset_path,
        ckpt,
        num_frames=args.num_frames,
        use_gt_poses=args.use_gt_poses,
        device=args.device,
    )
    print(json.dumps(res, indent=1))
