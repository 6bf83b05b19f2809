"""Intensity-render PSNR: render the trained intensity head at camera poses and
compare with the dataset's camera images.

Counterpart of ``loner_tpu/analysis/compute_psnr.py``: N images drawn from the
dataset (the same numpy draws from the same seed as the JAX package's), the
camera pose = the keyframe trajectory interpolated at the image's time times
the LiDAR-to-camera extrinsic, a full-frame intensity render, and
``metrics/psnr.yaml`` (JSON text, ``common/json_yaml.py``) with {num_images,
min, max, mean} dB and per-image rows.

    python -m loner_tpu_torch.analysis.compute_psnr <experiment_directory> \
        [--dataset <dir>] [--num_images 25] [--n_samples 1024] [--device cpu]
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.analysis.render_utils import kf_pose_matrices, load_experiment
from loner_tpu_torch.analysis.renderer import camera_ray_directions, render_dataset_frame
from loner_tpu_torch.common.json_yaml import write_json_yaml
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.trajectory import TrajectoryInterpolator
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
from loner_tpu_torch.models.losses import img_to_mse, mse_to_psnr


def compute_psnr(
    log_dir: str,
    dataset_path: Optional[str] = None,
    ckpt_name: str = "final.tar",
    num_images: int = 25,
    n_samples: int = 1024,
    use_gt_poses: bool = False,
    seed: int = 0,
    write: bool = True,
    save_renders: bool = False,
    device: Union[torch.device, str, None] = None,
    model=None,
) -> dict:
    """The PSNR record of an experiment directory (either package's);
    ``model``: an already loaded ``LoadedModel`` of it."""
    model = model or load_experiment(log_dir, ckpt_name, device=device)
    dataset_path = dataset_path or model.settings["dataset_path"]
    reader = ScanStreamReader(dataset_path)
    if not reader.image_files():
        raise SystemExit(f"{dataset_path} has no camera images")

    calib = model.settings["calibration"]
    intr = calib["camera_intrinsic"]
    k = np.asarray(intr["k"], np.float64)
    width, height = int(intr["width"]), int(intr["height"])
    dirs_cam = camera_ray_directions(k, width, height)
    t_lidar_to_camera = Pose.from_settings(calib["lidar_to_camera"]).matrix

    mats, ts = kf_pose_matrices(model, use_gt=use_gt_poses)
    interp = TrajectoryInterpolator(mats, ts)

    rng = np.random.default_rng(seed)
    n_total = len(reader.image_files())
    ids = np.sort(rng.choice(n_total, min(num_images, n_total), replace=False))

    render_dir = os.path.join(log_dir, "intensity_renders")
    if save_renders:
        os.makedirs(render_dir, exist_ok=True)

    rows = []
    for img_idx in ids:
        gt_img, t = reader.read_image(int(img_idx))
        if not interp.contains(t):
            continue
        cam_pose = interp.at(t).matrix @ t_lidar_to_camera
        frame = render_dataset_frame(model, cam_pose, dirs_cam, (height, width),
                                     n_samples=n_samples, with_intensity=True)
        pred = np.asarray(frame["intensity"], np.float32)
        gt = np.asarray(gt_img, np.float32)
        if gt.ndim == 2:
            gt = gt[..., None]
        if pred.shape[-1] != gt.shape[-1]:
            # Grey against colour: compare luminance.
            pred, gt = pred.mean(-1, keepdims=True), gt.mean(-1, keepdims=True)
        mse = img_to_mse(torch.from_numpy(pred), torch.from_numpy(gt))
        rows.append({"image": int(img_idx), "timestamp": float(t), "mse": float(mse),
                     "psnr": float(mse_to_psnr(mse))})
        if save_renders:
            np.save(os.path.join(render_dir, f"pred_{img_idx:04d}.npy"), pred)
            np.save(os.path.join(render_dir, f"gt_{img_idx:04d}.npy"), gt)

    if not rows:
        raise SystemExit("no images fell inside the trajectory's time span")
    psnrs = np.array([r["psnr"] for r in rows])
    result = {"num_images": len(rows), "mean": float(psnrs.mean()), "min": float(psnrs.min()),
              "max": float(psnrs.max()), "images": rows}
    if write:
        metrics_dir = os.path.join(log_dir, "metrics")
        os.makedirs(metrics_dir, exist_ok=True)
        write_json_yaml(os.path.join(metrics_dir, "psnr.yaml"), result)
    return result


def main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("log_dir")
    p.add_argument("--dataset", default=None)
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--num_images", type=int, default=25)
    p.add_argument("--n_samples", type=int, default=1024)
    p.add_argument("--use_gt_poses", action="store_true")
    p.add_argument("--save_renders", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    result = compute_psnr(args.log_dir, args.dataset, ckpt, num_images=args.num_images,
                          n_samples=args.n_samples, use_gt_poses=args.use_gt_poses,
                          save_renders=args.save_renders, device=args.device)
    print(json.dumps({k: v for k, v in result.items() if k != "images"}))


if __name__ == "__main__":
    main()
