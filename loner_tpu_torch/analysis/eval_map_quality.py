"""Full map-quality evaluation of a finished SLAM run, in one command.

Counterpart of ``examples/scripts/eval_map_quality.py``; chains the offline
tools on one device:

1. render the trained field into a virtual-scan map cloud
   (``render_full_map``: voxel 0.05 m, variance <= 0.25 m^2, every 3rd keyframe);
2. mask the ground-truth map to the LiDAR-visible region (within 0.1 m of the
   reconstruction);
3. accuracy / completion / chamfer / precision / recall / F@0.1 m
   -> ``<logdir>/metrics/statistics.yaml``;
4. L1 depth over 25 random scans -> ``<logdir>/metrics/l1.yaml``.

    python -m loner_tpu_torch.analysis.eval_map_quality <logdir> --gt_map <gt.pcd> \
        [--dataset <dataset_dir>] [--device cpu]

The GT map comes from ``analysis/create_lidar_map.py``. ``--device`` defaults to
``cuda`` and raises without a card; it never falls back to the CPU.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.analysis.compute_l1_depth import compute_l1_depth
from loner_tpu_torch.analysis.evaluate_lidar_map import evaluate_lidar_map, load_cloud
from loner_tpu_torch.analysis.mask_gt_with_trajectory import mask_gt_map
from loner_tpu_torch.analysis.renderer_lidar import render_full_map, write_pcd
from loner_tpu_torch.common.device import resolve_device


def eval_map_quality(
    log_dir: str,
    gt_map: np.ndarray,
    dataset: Optional[str] = None,
    ckpt_name: str = "final.tar",
    voxel_size: float = 0.05,
    var_threshold: float = 0.25,
    skip_step: int = 3,
    threshold: float = 0.1,
    skip_l1: bool = False,
    device: Union[torch.device, str, None] = None,
) -> dict:
    """The chain on one device; returns {"rendered_points", "masked_gt_points",
    "gt_points", "statistics", "l1" (None with ``skip_l1``), "seconds": {render,
    mask, evaluate, l1}}."""
    device = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    rendered = render_full_map(log_dir, ckpt_name, voxel_size=voxel_size, skip_step=skip_step,
                               var_threshold=var_threshold, device=device)
    seconds["render"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gt_masked = mask_gt_map(gt_map, rendered, dist_threshold=threshold)
    write_pcd(np.asarray(gt_masked, np.float32),
              os.path.join(log_dir, "lidar_renders", "gt_map_masked.pcd"))
    seconds["mask"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats = evaluate_lidar_map(rendered, gt_masked, voxel_size=voxel_size,
                               f_score_threshold=threshold, log_dir=log_dir, device=device)
    seconds["evaluate"] = time.perf_counter() - t0

    l1 = None
    if not skip_l1:
        t0 = time.perf_counter()
        l1 = compute_l1_depth(log_dir, dataset, ckpt_name, device=device)
        seconds["l1"] = time.perf_counter() - t0
    return {"rendered_points": int(rendered.shape[0]),
            "masked_gt_points": int(gt_masked.shape[0]), "gt_points": int(len(gt_map)),
            "statistics": stats, "l1": l1, "seconds": seconds}


def main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Map-quality evaluation of a SLAM run")
    p.add_argument("log_dir")
    p.add_argument("--gt_map", required=True, help=".pcd or .npy from create_lidar_map")
    p.add_argument("--dataset", default=None, help="dataset dir for the L1 metric")
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--var_threshold", type=float, default=0.25)
    p.add_argument("--skip_step", type=int, default=3)
    p.add_argument("--threshold", type=float, default=0.1)
    p.add_argument("--skip_l1", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without a card, ask for cpu)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    out = eval_map_quality(args.log_dir, load_cloud(args.gt_map), args.dataset, ckpt,
                           voxel_size=args.voxel_size, var_threshold=args.var_threshold,
                           skip_step=args.skip_step, threshold=args.threshold,
                           skip_l1=args.skip_l1, device=args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
