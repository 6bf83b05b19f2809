"""Depth and intensity images from a trained checkpoint.

Counterpart of ``loner_tpu/analysis/renderer.py``: ray directions for a pinhole
camera or a panorama; ``render_dataset_frame``, one depth / variance / opacity
(and intensity, peak-depth) frame at a pose in ray chunks, through the
compositor and the configuration's sigma forward (Fourier or hash kernels on
the card); ``render_sequence``, panoramas at the keyframe poses (or a TUM
trajectory, or one explicit pose) as ``renders/*.npy`` and turbo PNGs;
``flythrough_poses`` and ``render_flythrough``, an interpolated trajectory with
360-degree spins rendered frame by frame over the device pool, with
``frames.txt``, an ffmpeg ``make_video.sh`` and an MJPEG ``flythrough.avi``.
PNGs and the video are written by ``image_io.py`` and ``video.py`` (standard
library and numpy).

    python -m loner_tpu_torch.analysis.renderer <experiment_dir> [--ckpt_id final]
        [--width 512] [--height 256] [--skip_step 1] [--use_gt_poses]
        [--render_intensity] [--render_peak] [--flythrough] [--start_frame N]
        [--only_last_frame] [--traj tum.txt] [--render_pose X Y Z YAW PITCH ROLL]
        [--device cuda|cpu]
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch
from scipy.spatial.transform import Rotation as _R

from loner_tpu_torch.analysis.image_io import save_depth_png, save_rgb_png
from loner_tpu_torch.analysis.render_utils import (
    LoadedModel, kf_pose_matrices, load_experiment, render_depth_chunked,
)


def camera_ray_directions(k: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H*W, 3) pinhole ray directions in camera frame (z forward)."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    dirs = np.stack(
        [(xs - k[0, 2]) / k[0, 0], (ys - k[1, 2]) / k[1, 1], np.ones_like(xs, dtype=np.float64)],
        axis=-1,
    ).reshape(-1, 3)
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def spherical_ray_directions(
    width: int = 512, height: int = 256, v_fov_deg: Tuple[float, float] = (-45, 45)
) -> np.ndarray:
    """Panoramic (equirectangular) directions: the natural 'image' for a
    lidar-only map."""
    azim = np.linspace(0, 2 * np.pi, width, endpoint=False)
    elev = np.deg2rad(np.linspace(v_fov_deg[1], v_fov_deg[0], height))
    az, el = np.meshgrid(azim, elev)
    return np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    ).reshape(-1, 3).astype(np.float32)


def render_dataset_frame(
    model: LoadedModel,
    pose_mat: np.ndarray,
    dirs_sensor: np.ndarray,
    image_shape: Tuple[int, int],
    ray_range: Optional[Tuple[float, float]] = None,
    n_samples: int = 2048,
    chunk: int = 2048,
    with_intensity: bool = False,
    with_peak: bool = False,
) -> dict:
    """Render one frame; returns {'depth', 'variance', 'opacity'} as (H, W),
    plus 'intensity' (H, W, C) when ``with_intensity`` (a head trained with
    ``freeze_rgb_mlp: False``) and 'peak_depth_consistency' (H, W) meters when
    ``with_peak``."""
    if ray_range is None:
        ray_range = tuple(
            float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"]
        )
    dirs_world = dirs_sensor @ pose_mat[:3, :3].T
    origins = np.broadcast_to(pose_mat[:3, 3], dirs_world.shape)
    out = render_depth_chunked(
        model, origins, dirs_world, ray_range, n_samples=n_samples, chunk=chunk,
        with_intensity=with_intensity, with_peak=with_peak,
    )
    h, w = image_shape
    result = {
        "depth": out["depth"].reshape(h, w),
        "variance": out["variance"].reshape(h, w),
        "opacity": out["opacity"].reshape(h, w),
    }
    if with_intensity:
        result["intensity"] = out["rgb"].reshape(h, w, -1)
    if with_peak:
        result["peak_depth_consistency"] = out["peak_depth_consistency"].reshape(h, w)
    return result


def flythrough_poses(kf_mats: np.ndarray, steps_between: int = 10, spin_every: int = 0,
                     spin_steps: int = 36) -> np.ndarray:
    """An interpolated trajectory through the keyframe poses (``steps_between``
    poses a gap, translation lerped and rotation slerped in f32), with a
    360-degree spin about z at every ``spin_every``-th keyframe."""
    from loner_tpu_torch.common.se3 import interpolate_transforms

    out = []
    for i in range(len(kf_mats) - 1):
        alphas = torch.from_numpy(np.linspace(0, 1, steps_between, endpoint=False)).float()
        out.extend(interpolate_transforms(torch.as_tensor(kf_mats[i], dtype=torch.float32),
                                          torch.as_tensor(kf_mats[i + 1], dtype=torch.float32),
                                          alphas).numpy())
        if spin_every and (i + 1) % spin_every == 0:
            base = kf_mats[i + 1].copy()
            for ang in np.linspace(0, 2 * np.pi, spin_steps, endpoint=False):
                spin = base.copy()
                spin[:3, :3] = base[:3, :3] @ _R.from_euler("z", [ang]).as_matrix()[0]
                out.append(spin)
    out.append(kf_mats[-1])
    return np.stack(out)


def render_sequence(log_dir: str, ckpt_name: str = "final.tar", width: int = 512,
                    height: int = 256, skip_step: int = 1, use_gt_poses: bool = False,
                    n_samples: int = 1024, out_dir: Optional[str] = None,
                    with_intensity: bool = False, with_peak: bool = False, start_frame: int = 0,
                    only_last_frame: bool = False, explicit_pose: Optional[np.ndarray] = None,
                    traj_file: Optional[str] = None,
                    device: Union[torch.device, str, None] = None) -> str:
    """Panoramic frames at the keyframe poses -> ``renders/depth_<i>.{npy,png}``;
    ``with_intensity`` adds ``intensity_<i>.{npy,png}``, ``with_peak``
    ``peak_<i>.{npy,png}``. ``start_frame`` / ``only_last_frame`` cut the poses;
    ``traj_file`` (TUM) replaces them, ``explicit_pose`` (4 x 4, world meters)
    renders that one pose. ``device`` defaults to ``cuda``. Returns the output
    directory."""
    model = load_experiment(log_dir, ckpt_name, device=device)
    if explicit_pose is not None:
        mats = np.asarray(explicit_pose, np.float64)[None]
    elif traj_file is not None:
        from loner_tpu_torch.common.trajectory import load_tum_trajectory

        mats, _ = load_tum_trajectory(traj_file)
        mats = mats[-1:] if only_last_frame else mats[start_frame:]
    else:
        mats, _ = kf_pose_matrices(model, use_gt=use_gt_poses)
        mats = mats[-1:] if only_last_frame else mats[start_frame:]
    dirs = spherical_ray_directions(width, height)
    out_dir = out_dir or os.path.join(log_dir, "renders")
    os.makedirs(out_dir, exist_ok=True)
    for i, pose in enumerate(mats[::skip_step]):
        frame = render_dataset_frame(model, pose, dirs, (height, width), n_samples=n_samples,
                                     with_intensity=with_intensity, with_peak=with_peak)
        np.save(os.path.join(out_dir, f"depth_{i:04d}.npy"), frame["depth"])
        save_depth_png(frame["depth"], os.path.join(out_dir, f"depth_{i:04d}.png"))
        if with_intensity:
            np.save(os.path.join(out_dir, f"intensity_{i:04d}.npy"), frame["intensity"])
            save_rgb_png(frame["intensity"], os.path.join(out_dir, f"intensity_{i:04d}.png"))
        if with_peak:
            peak = frame["peak_depth_consistency"]
            np.save(os.path.join(out_dir, f"peak_{i:04d}.npy"), peak)
            save_depth_png(peak, os.path.join(out_dir, f"peak_{i:04d}.png"))
    return out_dir


def render_flythrough(log_dir: str, ckpt_name: str = "final.tar", width: int = 512,
                      height: int = 256, steps_between: int = 4, spin_every: int = 10,
                      spin_steps: int = 36, fps: int = 10, n_samples: int = 512,
                      use_gt_poses: bool = False, out_dir: Optional[str] = None,
                      device: Union[torch.device, str, None] = None) -> str:
    """A video flythrough: ``flythrough_poses`` of the keyframe poses, each rendered to ``flythrough/frame_<i>.png`` over the device
    pool (all cards of this process when ``device`` is ``cuda``, the default;
    one model copy a card), then ``frames.txt``, ``make_video.sh`` (ffmpeg, for
    an H.264 .mp4 where ffmpeg exists) and ``flythrough.avi`` (MJPEG, written
    here). Returns the output directory."""
    from loner_tpu_torch.analysis.video import write_mjpeg_avi
    from loner_tpu_torch.parallel.device_pool import cuda_devices, map_jobs

    model = load_experiment(log_dir, ckpt_name, device=device)
    mats, _ = kf_pose_matrices(model, use_gt=use_gt_poses)
    poses = flythrough_poses(mats, steps_between=steps_between, spin_every=spin_every,
                             spin_steps=spin_steps)
    dirs = spherical_ray_directions(width, height)
    out_dir = out_dir or os.path.join(log_dir, "flythrough")
    os.makedirs(out_dir, exist_ok=True)
    home = model.device
    if home.type == "cuda" and home.index is None:
        home = torch.device("cuda", torch.cuda.current_device())
    devices = cuda_devices() if home.type == "cuda" else [home]
    models = {home: model}
    lock = threading.Lock()

    def render_one(job, dev):
        with lock:
            if dev not in models:
                models[dev] = load_experiment(log_dir, ckpt_name, device=dev)
        i, pose = job
        frame = render_dataset_frame(models[dev], pose, dirs, (height, width),
                                     n_samples=n_samples)
        fname = f"frame_{i:05d}.png"
        save_depth_png(frame["depth"], os.path.join(out_dir, fname))
        return fname

    frames = map_jobs(render_one, list(enumerate(poses)), devices=devices)
    with open(os.path.join(out_dir, "frames.txt"), "w") as f:
        f.write("\n".join(frames) + "\n")
    cmd = f"ffmpeg -framerate {fps} -i frame_%05d.png -c:v libx264 -pix_fmt yuv420p flythrough.mp4"
    with open(os.path.join(out_dir, "make_video.sh"), "w") as f:
        f.write("#!/bin/sh\n# Assemble the flythrough (run where ffmpeg exists)\n")
        f.write(cmd + "\n")
    write_mjpeg_avi(os.path.join(out_dir, "flythrough.avi"),
                    [os.path.join(out_dir, f) for f in frames], fps=fps)
    return out_dir


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Render depth images from checkpoint")
    p.add_argument("experiment_directory")
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--skip_step", type=int, default=1)
    p.add_argument("--use_gt_poses", action="store_true")
    p.add_argument("--render_intensity", action="store_true",
                   help="also render intensity images from the trained head")
    p.add_argument("--render_peak", action="store_true",
                   help="also render peak-depth-consistency maps")
    p.add_argument("--flythrough", action="store_true",
                   help="render the spin-flythrough frame sequence instead")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--only_last_frame", action="store_true")
    p.add_argument("--traj", default=None,
                   help="render along this TUM trajectory file instead of the keyframe poses")
    p.add_argument("--render_pose", type=float, nargs=6, default=None,
                   metavar=("X", "Y", "Z", "YAW", "PITCH", "ROLL"),
                   help="render one explicit pose (meters; ZYX Euler, degrees)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    if args.flythrough:
        print(render_flythrough(args.experiment_directory, ckpt, width=args.width,
                                height=args.height, use_gt_poses=args.use_gt_poses,
                                device=args.device))
        return
    explicit = None
    if args.render_pose is not None:
        x, y, z, yaw, pitch, roll = args.render_pose
        explicit = np.eye(4)
        explicit[:3, :3] = _R.from_euler("ZYX", [yaw, pitch, roll], degrees=True).as_matrix()
        explicit[:3, 3] = [x, y, z]
    print(render_sequence(args.experiment_directory, ckpt, width=args.width, height=args.height,
                          skip_step=args.skip_step, use_gt_poses=args.use_gt_poses,
                          with_intensity=args.render_intensity, with_peak=args.render_peak,
                          start_frame=args.start_frame, only_last_frame=args.only_last_frame,
                          explicit_pose=explicit, traj_file=args.traj, device=args.device))


if __name__ == "__main__":
    main()
