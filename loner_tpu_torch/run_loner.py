"""Run the PyTorch port's SLAM on a scan-stream dataset.

Counterpart of ``examples/run_loner.py::run_trial``, on one explicit torch
device:

    python -m loner_tpu_torch.run_loner <dataset_dir> <config.yaml> \\
        [--experiment_name NAME] [--duration SECONDS] [--precompile] [--device cuda|cpu|cuda:N]

The world cube comes from the ground-truth poses when the dataset has them;
``runtime.txt`` records the wall time of the run; the return value (and the
last line printed) is the log directory. ``--device`` defaults to ``cuda``
and never falls back to the CPU: without a CUDA card, ask for ``cpu``.
``<dataset_dir>`` may be ``auto`` for a sequence config that names its
dataset. Sweeps, ``--resume``, trial pools and camera images are not ported.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.common.settings import Settings, load_config
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, apply_fov_mask
from loner_tpu_torch.runtime.loner import Loner


def resolve_device(device: Union[torch.device, str]) -> torch.device:
    """The torch device asked for; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def run_trial(
    settings: Union[Settings, dict],
    dataset_path: str,
    experiment_name: Optional[str] = None,
    config_idx: Optional[int] = None,
    trial_idx: Optional[int] = None,
    duration: Optional[float] = None,
    resume_from: Optional[str] = None,
    device: Union[torch.device, str] = "cuda",
) -> str:
    """One SLAM run over the dataset; returns the log directory."""
    if resume_from is not None:
        raise NotImplementedError("resuming a run is not ported")
    device = resolve_device(device)
    settings = settings if isinstance(settings, Settings) else Settings(settings)
    if settings.system.get("seed_cache_only", False):
        raise NotImplementedError("system.seed_cache_only: the port has no compilation cache")
    reader = ScanStreamReader(dataset_path)
    if not settings.system.lidar_only and reader.has_images():
        raise NotImplementedError("camera images are not ported")

    gt_poses = reader.gt_poses()
    if gt_poses is not None and settings.system.world_cube.compute_from_groundtruth:
        # Zero-origin with the left inverse: a global change of world frame.
        lidar_poses, bbox = np.linalg.inv(gt_poses[0])[None] @ gt_poses, None
    else:
        lidar_poses, bbox = None, settings.system.world_cube.trajectory_bounding_box
    ray_range = settings.mapper.optimizer.model_config.data.ray_range

    loner = Loner(settings, device)
    loner.initialize(lidar_poses, ray_range, dataset_path=dataset_path,
                     experiment_name=experiment_name, config_idx=config_idx,
                     trial_idx=trial_idx, traj_bounding_box=bbox)
    loner.start()

    fov = settings.system.lidar_fov
    if settings.system.get("precompile", False) and len(reader) > 0:
        # Build the kernels and run every program once before the clock
        # starts, at the point count the streamed scans will have.
        scan0 = reader.read_scan(0)
        if fov.enabled:
            scan0 = apply_fov_mask(scan0, fov.range)
        loner.warm_up(len(scan0))

    gt_offset = None
    start = time.time()
    init_time = None
    for scan, gt in reader:
        if init_time is None:
            init_time = scan.get_start_time()
        if duration is not None and scan.get_start_time() - init_time > duration:
            break
        if fov.enabled:
            scan = apply_fov_mask(scan, fov.range)
        if len(scan) == 0:
            continue
        gt_pose = None
        if gt is not None:
            if gt_offset is None:
                gt_offset = gt.inv()
            gt_pose = gt_offset * gt
        loner.process_lidar(scan, gt_pose)
    ingest_done = time.time()
    loner.stop()
    end = time.time()

    with open(os.path.join(loner.log_directory, "runtime.txt"), "w") as f:
        f.write(f"Runtime: {ingest_done - start}\n")
        f.write(f"Runtime With Overhead: {end - start}\n")
    print(f"Finished. Logs in {loner.log_directory}")
    return loner.log_directory


def main() -> None:
    parser = argparse.ArgumentParser(description="Run LONER SLAM with the PyTorch port")
    parser.add_argument("dataset_path", help="scan-stream directory, or 'auto' for the "
                        "dataset a sequence config names")
    parser.add_argument("config", help="path to the config yaml")
    parser.add_argument("--experiment_name", default=None)
    parser.add_argument("--duration", type=float, default=None, help="seconds of data")
    parser.add_argument("--precompile", action="store_true",
                        help="build the kernels and run every program once before streaming")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args()

    settings, seq_dataset = load_config(args.config)
    dataset_path = args.dataset_path
    if dataset_path in ("auto", "-"):
        if seq_dataset is None:
            parser.error(f"{args.config} names no dataset: give the dataset directory")
        dataset_path = os.path.expanduser(seq_dataset)
    if args.precompile:
        settings.augment({"system": {"precompile": True}})
    run_trial(settings, dataset_path, experiment_name=args.experiment_name,
              duration=args.duration, device=args.device)


if __name__ == "__main__":
    main()
