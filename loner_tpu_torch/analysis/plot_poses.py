"""XY plot of the ground-truth, optimised and tracked keyframe translations.

Counterpart of ``loner_tpu/analysis/plot_poses.py``: reads the keyframe pose
states of a checkpoint and writes ``poses.png`` (equal axes) with
``analysis/raster_plot.py``; the series' labels and data are in the PNG's text
chunks. Reads the checkpoint only: no device work.

    python -m loner_tpu_torch.analysis.plot_poses <experiment_dir> [--ckpt_id final]
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from loner_tpu_torch.analysis.raster_plot import Series, render_plot
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.mapping.mapper import load_checkpoint

# (pose key, label, matplotlib format of the JAX package's plot as a colour
# and style, alpha), in its drawing order.
POSE_SERIES = (("gt_lidar_pose", "ground truth", "#008000", ".-", 1.0),
               ("tracked_pose", "tracked", "#0000ff", ".--", 0.6),
               ("lidar_pose", "optimized", "#ff0000", ".-", 1.0))


def plot_poses(log_dir: str, ckpt_name: str = "final.tar", out_file: Optional[str] = None) -> str:
    poses = load_checkpoint(os.path.join(log_dir, "checkpoints", ckpt_name)).get("poses", [])

    def translations(key):
        if not poses or any(state.get(key) is None for state in poses):
            return None
        return np.stack([Pose.from_twist(state[key]).get_translation() for state in poses])

    series = []
    for key, label, color, style, alpha in POSE_SERIES:
        t = translations(key)
        if t is not None:
            series.append(Series(label, color, t[:, 0], t[:, 1], style, alpha=alpha))
    out_file = out_file or os.path.join(log_dir, "poses.png")
    return render_plot(series, out_file, size=(960, 960), equal=True, title="Keyframe poses",
                       xlabel="x (m)", ylabel="y (m)")


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Plot keyframe poses of an experiment")
    p.add_argument("experiment_directory")
    p.add_argument("--ckpt_id", default="final")
    args = p.parse_args(argv)
    ckpt = args.ckpt_id if args.ckpt_id.endswith(".tar") else f"{args.ckpt_id}.tar"
    print(plot_poses(args.experiment_directory, ckpt))


if __name__ == "__main__":
    main()
