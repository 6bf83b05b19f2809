"""Above-horizon floaters of an open-sky run's trained field.

Counterpart of ``examples/scripts/sky_floater_metric.py``, the A/B measure of
sky-ray supervision: on a scene without a ceiling nothing above the walls ever
returns a LiDAR hit, so without sky supervision the field may grow density
there ("floaters"); with it, the losses carve that air. Two measurements:

1. floater points: points of the rendered map cloud
   (``lidar_renders/render_full_<voxel>.npy``, from ``eval_map_quality`` or
   ``renderer_lidar``) above the GT map's highest point plus ``margin``;
2. mean sky opacity: rendered opacity along upward rays (elevation 45-85
   degrees, azimuth at random from a fixed seed) from every 3rd keyframe pose,
   through the checkpointed field with uniform samples and the configuration's
   compositor (on the card: the fused Fourier forward and composite kernels).

Writes ``<logdir>/metrics/sky_floaters.yaml`` and prints it:

    python -m loner_tpu_torch.analysis.sky_floaters <logdir> --gt_map <gt.pcd> \\
        [--voxel_size 0.05] [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card; it never falls
back to the CPU.
"""
from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from loner_tpu_torch.analysis.evaluate_lidar_map import load_cloud
from loner_tpu_torch.analysis.render_utils import kf_pose_matrices, load_experiment
from loner_tpu_torch.common.json_yaml import write_json_yaml
from loner_tpu_torch.models.rendering import UniformRaySampler, pack_rays, render_rays

PROBE_SAMPLES = 256  # uniform samples along each probe ray


def probe_rays(mats: np.ndarray, n_probe_rays: int):
    """(origins, dirs) in metres of the upward probe rays from every 3rd pose of
    ``mats`` ((K, 4, 4)): ``n_probe_rays // len(mats[::3])`` a pose (at least 1)."""
    rng = np.random.default_rng(0)
    per_pose = max(1, n_probe_rays // max(1, len(mats[::3])))
    origins, dirs = [], []
    for m in mats[::3]:
        azim = rng.uniform(0, 2 * np.pi, per_pose)
        elev = rng.uniform(np.deg2rad(45), np.deg2rad(85), per_pose)
        d = np.stack([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)],
                     axis=-1)
        dirs.append(d)
        origins.append(np.broadcast_to(m[:3, 3], d.shape))
    return np.concatenate(origins).astype(np.float32), np.concatenate(dirs).astype(np.float32)


def sky_opacity(model, n_probe_rays: int = 1024) -> np.ndarray:
    """Rendered opacity of the probe rays (``probe_rays``) of a loaded model."""
    o, d = probe_rays(kf_pose_matrices(model)[0], n_probe_rays)
    cube = model.world_cube
    scale = float(cube.scale_factor)
    ray_range = tuple(
        float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"])
    n = len(o)
    dev = model.device
    with torch.inference_mode():
        rays = pack_rays(
            torch.from_numpy(np.asarray(cube.to_cube(o), np.float32)).to(dev),
            torch.from_numpy(d).to(dev),
            torch.full((n,), ray_range[0] / scale, device=dev),
            torch.full((n,), ray_range[1] / scale, device=dev))
        out = render_rays(rays, model.field_params, model.field_cfg, UniformRaySampler(),
                          n_samples=PROBE_SAMPLES, ret_var=True, compositor=model.compositor)
        return out["opacity"].cpu().numpy()


def sky_floaters(log_dir: str, gt_map: np.ndarray, voxel_size: float = 0.05,
                 margin: float = 0.2, ckpt_name: str = "final.tar", n_probe_rays: int = 1024,
                 device: Union[torch.device, str, None] = None) -> dict:
    """The two measurements against ``gt_map`` ((N, 3) metres); writes and
    returns the metrics record."""
    z_top = float(np.max(gt_map[:, 2])) + margin
    rendered = np.load(os.path.join(log_dir, "lidar_renders", f"render_full_{voxel_size}.npy"))
    n_floaters = int((rendered[:, 2] > z_top).sum())

    opacity = sky_opacity(load_experiment(log_dir, ckpt_name, device=device), n_probe_rays)
    n = len(opacity)

    result = {
        "z_top": z_top,
        "num_map_points": int(rendered.shape[0]),
        "num_floater_points": n_floaters,
        "floater_fraction": float(n_floaters / max(1, rendered.shape[0])),
        "mean_sky_opacity": float(opacity.mean()),
        "p90_sky_opacity": float(np.percentile(opacity, 90)),
        "num_probe_rays": int(n),
    }
    os.makedirs(os.path.join(log_dir, "metrics"), exist_ok=True)
    write_json_yaml(os.path.join(log_dir, "metrics", "sky_floaters.yaml"), result)
    return result


def main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Above-horizon floaters of an open-sky run")
    p.add_argument("log_dir")
    p.add_argument("--gt_map", required=True, help=".pcd or .npy from create_lidar_map")
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--ckpt_id", default="final")
    p.add_argument("--n_probe_rays", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without a card, ask for cpu)")
    args = p.parse_args()
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    result = sky_floaters(args.log_dir, load_cloud(args.gt_map), args.voxel_size, args.margin,
                          ckpt, args.n_probe_rays, device=args.device)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
