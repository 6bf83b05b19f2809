"""Where the L1 depth metric's error comes from, ray by ray.

Takes ``compute_l1_depth``'s own frames and rays (the same seeds) and renders
each ray three ways: at the metric's pose (the estimated keyframe trajectory
interpolated at the scan's time), at the scan's ground-truth pose in the SLAM
frame, and at that pose with uniform samples instead of the trained sampler.
The first gives the metric, the second takes the pose provider's error out,
the third the sampler's. The rays whose error passes ``TAIL_M`` are then split
by measured range, elevation, frame, opacity, the sign of the error, and the
distance from their true surface point to the nearest return of a keyframe
scan (a surface no keyframe saw is one the map was never fitted to).

    python -m loner_tpu_torch.analysis.l1_breakdown <experiment_directory> \
        [--dataset_path <dir>] [--worst out.npz] [--device cpu]

Prints one JSON object; ``--worst`` keeps the worst rays with their renders.
"""
from __future__ import annotations

import json
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.analysis.compute_l1_depth import l1_rays
from loner_tpu_torch.analysis.render_utils import (
    kf_pose_matrices,
    load_experiment,
    render_depth_chunked,
)
from loner_tpu_torch.common.trajectory import TrajectoryInterpolator
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader

TAIL_M = 1.0  # m, an error past this is the tail
UNSEEN_M = 0.1  # m, a true surface point this far from every keyframe return
RANGE_BINS = [0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 14.0]
ELEVATION_BINS_DEG = [-90.0, -15.0, -5.0, 5.0, 15.0, 90.0]


def _stats(err: np.ndarray) -> dict:
    tail = err > TAIL_M
    return {
        "mean": float(err.mean()), "rmse": float(np.sqrt((err ** 2).mean())),
        "q50": float(np.quantile(err, 0.5)), "q90": float(np.quantile(err, 0.9)),
        "q99": float(np.quantile(err, 0.99)), "max": float(err.max()),
        "tail_share": float(tail.mean()),
        "tail_part_of_mean": float(err[tail].sum() / err.size),
        "mean_without_tail": float(err[~tail].mean()),
    }


def _hist(values: np.ndarray, bins, mask: np.ndarray) -> dict:
    """Rays per bin, all of them and the tail's."""
    return {"bins": list(bins), "all": np.histogram(values, bins)[0].tolist(),
            "tail": np.histogram(values[mask], bins)[0].tolist()}


def _keyframe_cloud(reader: ScanStreamReader, kf_times: np.ndarray, origin) -> np.ndarray:
    """The keyframe scans' returns at their ground-truth poses (SLAM frame)."""
    starts = reader.start_times()
    clouds = []
    for t in kf_times:
        scan = reader.read_scan(int(np.argmin(np.abs(starts - t))))
        pose = origin * reader.gt_interpolator.at(scan.get_start_time())
        clouds.append(pose.transform_points((scan.ray_directions * scan.distances).T))
    return np.concatenate(clouds, axis=0)


def l1_breakdown(
    log_dir: str,
    dataset_path: Optional[str] = None,
    ckpt_name: str = "final.tar",
    num_frames: int = 25,
    rays_per_frame: int = 2048,
    n_samples: int = 1024,
    seed: int = 0,
    worst: int = 0,
    device: Union[torch.device, str, None] = None,
) -> dict:
    """The breakdown as a dict; with ``worst`` > 0 it also holds, under
    ``"worst_rays"``, arrays of the ``worst`` rays of largest metric error."""
    from scipy.spatial import cKDTree

    model = load_experiment(log_dir, ckpt_name, device=device)
    reader = ScanStreamReader(dataset_path or model.settings["dataset_path"])
    if reader.gt_interpolator is None:
        raise SystemExit("the dataset has no ground truth: nothing to break the error down by")
    ray_range = tuple(
        float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"])
    mats, kf_times = kf_pose_matrices(model)
    interp = TrajectoryInterpolator(mats, kf_times)
    origin = reader.gt_interpolator.at(reader.start_times()[0]).inv()
    kf_tree = cKDTree(_keyframe_cloud(reader, kf_times, origin))

    rows = {k: [] for k in ("fid", "t", "range", "elev", "seen_dist", "metric", "gt_pose",
                            "uniform", "depth", "opacity", "variance", "origin", "dir")}
    frames = []
    for fid, t, pose, dirs_s, gt in l1_rays(reader, interp, ray_range, num_frames,
                                            rays_per_frame, seed):
        gt_pose = (origin * reader.gt_interpolator.at(t)).matrix
        renders = {}
        for name, p, use_occ in (("metric", pose, True), ("gt_pose", gt_pose, True),
                                 ("uniform", gt_pose, False)):
            dirs_w = dirs_s @ p[:3, :3].T
            origins = np.broadcast_to(p[:3, 3], dirs_w.shape)
            renders[name] = render_depth_chunked(model, origins, dirs_w, ray_range,
                                                 n_samples=n_samples, ret_var=True,
                                                 use_occ=use_occ)
            rows[name].append(np.abs(renders[name]["depth"] - gt))
        surface = gt_pose[:3, 3] + (dirs_s @ gt_pose[:3, :3].T) * gt[:, None]
        rows["fid"].append(np.full(gt.shape, fid))
        rows["t"].append(np.full(gt.shape, t - reader.start_times()[0]))
        rows["range"].append(gt)
        rows["elev"].append(np.degrees(np.arcsin(np.clip(dirs_s[:, 2], -1.0, 1.0))))
        rows["seen_dist"].append(kf_tree.query(surface)[0])
        rows["depth"].append(renders["metric"]["depth"] - gt)
        rows["opacity"].append(renders["metric"]["opacity"])
        rows["variance"].append(renders["metric"]["variance"])
        rows["origin"].append(np.broadcast_to(pose[:3, 3], dirs_s.shape))
        rows["dir"].append(dirs_s @ pose[:3, :3].T)
        err = rows["metric"][-1]
        frames.append({
            "frame": fid, "t": round(float(t - reader.start_times()[0]), 3),
            "mean": float(err.mean()), "tail_share": float((err > TAIL_M).mean()),
            "gt_pose_mean": float(rows["gt_pose"][-1].mean()),
            "pose_error_m": float(np.linalg.norm(pose[:3, 3] - gt_pose[:3, 3])),
            "pose_error_deg": float(np.degrees(np.arccos(np.clip(
                (np.trace(pose[:3, :3].T @ gt_pose[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))),
        })
    r = {k: np.concatenate(v) for k, v in rows.items()}
    tail = r["metric"] > TAIL_M
    unseen = r["seen_dist"] > UNSEEN_M
    result = {
        "num_rays": int(tail.size), "keyframes": int(kf_times.size),
        "tail_m": TAIL_M, "unseen_m": UNSEEN_M,
        "metric": _stats(r["metric"]), "gt_pose": _stats(r["gt_pose"]),
        "gt_pose_uniform_samples": _stats(r["uniform"]),
        "tail": {
            "rays": int(tail.sum()),
            "rendered_short_share": float((r["depth"][tail] < 0).mean()) if tail.any() else None,
            "opacity_q10_q50": ([float(q) for q in np.quantile(r["opacity"][tail], [0.1, 0.5])]
                                if tail.any() else None),
            "variance_q50": float(np.median(r["variance"][tail])) if tail.any() else None,
            "also_tail_at_gt_pose": (float((r["gt_pose"][tail] > TAIL_M).mean())
                                     if tail.any() else None),
            "unseen_share": float(unseen[tail].mean()) if tail.any() else None,
            "range_m": _hist(r["range"], RANGE_BINS, tail),
            "elevation_deg": _hist(r["elev"], ELEVATION_BINS_DEG, tail),
        },
        "unseen": {"share": float(unseen.mean()),
                   "mean_error": float(r["metric"][unseen].mean()) if unseen.any() else None,
                   "mean_error_seen": float(r["metric"][~unseen].mean())},
        "frames": sorted(frames, key=lambda f: f["t"]),
    }
    if worst > 0:
        order = np.argsort(-r["metric"])[:worst]
        result["worst_rays"] = {k: r[k][order] for k in r}
    return result


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description="Break the L1 depth metric's error down by ray")
    p.add_argument("experiment_directory")
    p.add_argument("--dataset_path", default=None)
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--worst", default=None, help=".npz for the 256 rays of largest error")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without a card, ask for cpu)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    res = l1_breakdown(args.experiment_directory, args.dataset_path, ckpt,
                       worst=256 if args.worst else 0, device=args.device)
    if args.worst:
        np.savez(args.worst, **res.pop("worst_rays"))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
