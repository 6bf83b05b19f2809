"""Run the PyTorch port's SLAM on a scan-stream dataset.

Counterpart of ``examples/run_loner.py::run_trial``, on one explicit torch
device:

    python -m loner_tpu_torch.run_loner <dataset_dir> <config.yaml> \\
        [--experiment_name NAME] [--duration SECONDS] [--precompile] [--device cuda|cpu|cuda:N]
    python -m loner_tpu_torch.run_loner --resume <log_dir> [--duration SECONDS] [--device ...]

The world cube comes from the ground-truth poses when the dataset has them;
``runtime.txt`` records the wall time of the run; the return value (and the
last line printed) is the log directory. ``--device`` defaults to ``cuda``
and never falls back to the CPU: without a CUDA card, ask for ``cpu``.
``<dataset_dir>`` may be ``auto`` for a sequence config that names its
dataset. ``--resume`` continues a run (written by either package) in its own
directory from its newest full checkpoint, with the configuration and dataset
of its ``full_config.pkl`` (``runtime/resume.py``). In camera mode
(``system.lidar_only: False``) the dataset's images are fed in time order with
the scans. Sweeps and trial pools are not ported.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.common.device import resolve_device
from loner_tpu_torch.common.sensors import Image
from loner_tpu_torch.common.settings import Settings, load_config
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, apply_fov_mask
from loner_tpu_torch.runtime.loner import Loner


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
    """One SLAM run over the dataset; returns the log directory. With
    ``resume_from`` (a log directory) the run continues there from its newest
    full checkpoint, streaming the scans after its last keyframe."""
    device = resolve_device(device)
    settings = settings if isinstance(settings, Settings) else Settings(settings)
    if settings.system.get("seed_cache_only", False):
        raise NotImplementedError("system.seed_cache_only: the port has no compilation cache")
    reader = ScanStreamReader(dataset_path)

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
                     trial_idx=trial_idx, traj_bounding_box=bbox, log_directory=resume_from)
    loner.start()

    resume_idx = 0
    if resume_from is not None:
        from loner_tpu_torch.runtime.resume import resume_run

        resume_idx = resume_run(loner, reader, resume_from)
        print(f"Resuming {resume_from} at scan {resume_idx}/{len(reader)}")

    fov = settings.system.lidar_fov
    if settings.system.get("precompile", False) and len(reader) > 0:
        # Build the kernels and run every program once before the clock
        # starts, at the point count the streamed scans will have.
        scan0 = reader.read_scan(0)
        if fov.enabled:
            scan0 = apply_fov_mask(scan0, fov.range)
        loner.warm_up(len(scan0))

    # The camera stream, replayed in time order with the scans.
    image_files = [] if settings.system.lidar_only else reader.image_files()
    next_img = 0
    if resume_idx > 0 and image_files:
        # Skip the images before the resume by their timestamps, keeping those
        # within the match tolerance of the first resumed scan's start.
        resume_start = reader.read_scan(resume_idx).get_start_time()
        tol = float(settings.tracker.frame_synthesis.get("frame_match_tolerance", 0.01))
        while (next_img < len(image_files)
               and reader.read_image_timestamp(next_img) < resume_start - tol):
            next_img += 1

    gt_offset = None
    if resume_idx > 0 and reader.gt_interpolator is not None:
        # The original run's zero-origin offset, its first scan's GT: the first
        # scan after the resume would re-zero the trajectory mid-sequence.
        first = reader.read_scan(0).get_start_time()
        if reader.gt_interpolator.contains(first):
            gt_offset = reader.gt_interpolator.at(first).inv()
    start = time.time()
    init_time = None
    for scan, gt in reader.iter_from(resume_idx):
        if init_time is None:
            init_time = scan.get_start_time()
        if duration is not None and scan.get_start_time() - init_time > duration:
            break
        while next_img < len(image_files):
            img, img_ts = reader.read_image(next_img)
            if img_ts > scan.get_start_time():
                break
            loner.process_rgb(Image(img, img_ts))
            next_img += 1
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
    parser.add_argument("dataset_path", nargs="?", default=None,
                        help="scan-stream directory, or 'auto' for the dataset a sequence "
                        "config names")
    parser.add_argument("config", nargs="?", default=None, help="path to the config yaml")
    parser.add_argument("--resume", default=None, metavar="LOGDIR",
                        help="continue a run from its newest full checkpoint (configuration "
                        "and dataset from the run's full_config.pkl)")
    parser.add_argument("--experiment_name", default=None)
    parser.add_argument("--duration", type=float, default=None, help="seconds of data")
    parser.add_argument("--precompile", action="store_true",
                        help="build the kernels and run every program once before streaming")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args()

    if args.resume is not None:
        with open(os.path.join(args.resume, "full_config.pkl"), "rb") as f:
            settings = Settings(pickle.load(f))
        if args.precompile:
            settings.augment({"system": {"precompile": True}})
        run_trial(settings, settings["dataset_path"], duration=args.duration,
                  resume_from=args.resume, device=args.device)
        return
    if args.dataset_path is None or args.config is None:
        parser.error("dataset_path and config are required unless --resume is given")
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
