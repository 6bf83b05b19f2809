"""Virtual-LiDAR renderer: synthesize point clouds from a trained map.

Counterpart of ``loner_tpu/analysis/renderer_lidar.py``: builds a spherical
grid of rays at each requested pose, renders expected depth + variance from the
field, filters by variance threshold and max range, and accumulates a
voxel-downsampled cloud written to ``lidar_renders/render_full_<voxel>.npy``
and ``.pcd`` (ASCII). The poses render one after another on one device.

    python -m loner_tpu_torch.analysis.renderer_lidar <experiment_directory>
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from loner_tpu_torch.analysis.render_utils import (
    LoadedModel,
    kf_pose_matrices,
    load_experiment,
    render_depth_chunked,
)
from loner_tpu_torch.ops.voxel import voxel_downsample


def build_lidar_ray_directions(
    num_channels: int = 64,
    num_columns: int = 1024,
    vertical_fov_deg: Tuple[float, float] = (-22.5, 22.5),
) -> np.ndarray:
    """(N, 3) spherical grid of sensor-frame directions."""
    elev = np.deg2rad(np.linspace(vertical_fov_deg[0], vertical_fov_deg[1], num_channels))
    azim = np.linspace(0, 2 * np.pi, num_columns, endpoint=False)
    az, el = np.meshgrid(azim, elev, indexing="ij")
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1)
    return dirs.reshape(-1, 3).astype(np.float32)


def render_scan(
    model: LoadedModel,
    pose_mat: np.ndarray,
    dirs_sensor: np.ndarray,
    ray_range: Tuple[float, float],
    n_samples: int = 1024,
    var_threshold: Optional[float] = 1.0,
    max_range_frac: float = 0.95,
    chunk: int = 2048,
) -> np.ndarray:
    """Render one virtual scan; returns (M, 3) world-frame points after
    variance/range filtering."""
    rot, trans = pose_mat[:3, :3], pose_mat[:3, 3]
    dirs_world = dirs_sensor @ rot.T
    origins = np.broadcast_to(trans, dirs_world.shape)
    out = render_depth_chunked(
        model, origins, dirs_world, ray_range, n_samples=n_samples, chunk=chunk
    )
    depth, var = out["depth"], out["variance"]
    keep = depth < ray_range[1] * max_range_frac
    if var_threshold is not None:
        keep &= var < var_threshold
    return (origins + dirs_world * depth[:, None])[keep].astype(np.float32)


def write_pcd(points: np.ndarray, fname: str) -> None:
    """Minimal ASCII PCD writer."""
    with open(fname, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {points.shape[0]}\nHEIGHT 1\n")
        f.write("VIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {points.shape[0]}\nDATA ascii\n")
        np.savetxt(f, points, fmt="%.6f")


def read_pcd(fname: str) -> np.ndarray:
    """Read an ASCII PCD written by write_pcd (xyz only)."""
    with open(fname) as f:
        lines = f.readlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("DATA")) + 1
    if start == len(lines):
        return np.zeros((0, 3), np.float32)
    return np.loadtxt(lines[start:], dtype=np.float32, ndmin=2)[:, :3]


def render_full_map(
    log_dir: str,
    ckpt_name: str = "final.tar",
    voxel_size: float = 0.1,
    skip_step: int = 1,
    use_gt_poses: bool = False,
    num_channels: int = 64,
    num_columns: int = 1024,
    var_threshold: float = 1.0,
    n_samples: int = 1024,
    out_dir: Optional[str] = None,
    translation_noise: float = 0.0,
    noise_seed: int = 0,
    vertical_fov: Optional[Tuple[float, float]] = None,
    device: Union[torch.device, str, None] = None,
) -> np.ndarray:
    """Render virtual scans at every skip_step-th keyframe pose and merge
    into a voxel-downsampled map cloud.

    ``translation_noise`` perturbs render poses (map-quality robustness
    probing). The virtual-scan vertical FOV defaults to the experiment
    config's ``lidar_vertical_fov``. ``device`` defaults to ``cuda`` and raises
    without a card: pass ``device="cpu"`` for the plain versions."""
    model = load_experiment(log_dir, ckpt_name, device=device)
    mats, _ = kf_pose_matrices(model, use_gt=use_gt_poses)
    if translation_noise > 0:
        rng = np.random.default_rng(noise_seed)
        mats = mats.copy()
        mats[:, :3, 3] += rng.normal(0, translation_noise, (mats.shape[0], 3))
    ray_range = tuple(
        float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"]
    )
    if vertical_fov is None:
        vertical_fov = tuple(
            float(x) for x in model.settings.get("lidar_vertical_fov", (-22.5, 22.5))
        )
    dirs = build_lidar_ray_directions(num_channels, num_columns, vertical_fov)

    clouds = []
    for pose in mats[::skip_step]:
        pts = render_scan(model, pose, dirs, ray_range, n_samples=n_samples,
                          var_threshold=var_threshold)
        if pts.shape[0]:
            clouds.append(voxel_downsample(pts, voxel_size))
    merged = (voxel_downsample(np.concatenate(clouds, axis=0), voxel_size) if clouds
              else np.zeros((0, 3), np.float32))

    out_dir = out_dir or os.path.join(log_dir, "lidar_renders")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"render_full_{voxel_size}.npy"), merged)
    write_pcd(merged, os.path.join(out_dir, f"render_full_{voxel_size}.pcd"))
    return merged


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Render a virtual-lidar map cloud")
    p.add_argument("experiment_directory")
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--voxel_size", type=float, default=0.1)
    p.add_argument("--skip_step", type=int, default=1)
    p.add_argument("--use_gt_poses", action="store_true")
    p.add_argument("--var_threshold", type=float, default=1.0)
    p.add_argument("--translation_noise", type=float, default=0.0)
    p.add_argument(
        "--vertical_fov", type=float, nargs=2, default=None,
        help="virtual-scan vertical FOV in degrees "
        "(default: the experiment config's lidar_vertical_fov)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without a card, ask for cpu)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    if not ckpt.startswith("ckpt_") and not ckpt.startswith("final"):
        ckpt = f"ckpt_{ckpt}"
    pts = render_full_map(
        args.experiment_directory,
        ckpt,
        voxel_size=args.voxel_size,
        skip_step=args.skip_step,
        use_gt_poses=args.use_gt_poses,
        var_threshold=args.var_threshold,
        translation_noise=args.translation_noise,
        vertical_fov=args.vertical_fov,
        device=args.device,
    )
    print(f"rendered map cloud: {pts.shape[0]} points")
