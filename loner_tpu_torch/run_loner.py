"""Run the PyTorch port's SLAM on a scan-stream dataset (or a synthetic scene).

Counterpart of ``examples/run_loner.py``, on one explicit torch device:

    python -m loner_tpu_torch.run_loner <dataset_dir> <config.yaml> \\
        [--experiment_name NAME] [--duration SECONDS] [--precompile] [--device cuda|cpu|cuda:N] \\
        [--overrides overrides.yaml [--run_all_combos]] [--num_repeats N] [--lite]
    python -m loner_tpu_torch.run_loner synthetic <config.yaml> [--synthetic_scans N] \\
        [--synthetic_scene box_room|open_sky|courtyard|courtyard_actors] \\
        [--synthetic_noise_std S] [--synthetic_dropout P] [--synthetic_camera]
    python -m loner_tpu_torch.run_loner --resume <log_dir> [--duration SECONDS] [--device ...]

The world cube comes from the ground-truth poses when the dataset has them;
``runtime.txt`` records the wall time of the run; the return value (and the
last line printed) is the log directory. ``--device`` defaults to ``cuda``
and never falls back to the CPU: without a CUDA card, ask for ``cpu``.
``<dataset_dir>`` may be ``auto`` for a sequence config that names its
dataset, or ``synthetic``: the dataset ``build_synthetic_dataset`` writes to
``./outputs/synthetic_dataset<suffix>`` (written once, then reused), the same
directory and scans as the JAX package's runner. ``--overrides`` sweeps the
settings (``common/settings.py::generate_options``), each variant under
``config_<i>/``; ``--num_repeats`` runs each variant that many times under
``trial_<j>/``, trial j with ``mapper.optimizer.seed`` offset by j; every trial
runs on its own copy of the settings, one after another. ``--lite`` cuts the
sample counts for quick runs. ``--resume`` continues a run (written by either
package) in its own directory from its newest full checkpoint, with the
configuration and dataset of its ``full_config.pkl`` (``runtime/resume.py``). In
camera mode (``system.lidar_only: False``) the dataset's images are fed in time
order with the scans. ``--trial_workers N`` (N > 1) runs the trials as child
processes, at most N at a time (``parallel/trial_pool.py``), each from a
pickled spec (``--_trial_spec``) and pinned by ``CUDA_VISIBLE_DEVICES`` to one of
``--gpu_ids`` in turn; children take the parent's ``--device``.
"""
from __future__ import annotations

import argparse
import copy
import os
import pickle
import shutil
import time
from typing import Optional, Union

import numpy as np
import torch

from loner_tpu_torch.common.device import resolve_device
from loner_tpu_torch.common.sensors import Image
from loner_tpu_torch.common.settings import Settings, generate_options, load_sequence_config
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, apply_fov_mask
from loner_tpu_torch.runtime.loner import Loner


SYNTHETIC_SCENES = ("box_room", "open_sky", "courtyard", "courtyard_actors")

# --lite: fewer samples a ray, for quick runs and the CPU.
LITE_CHANGES = {"mapper": {"optimizer": {
    "num_samples": {"lidar": 256, "sky": 32},
    "model_config": {"model": {"render": {"N_samples_train": 128, "N_samples_test": 256}}},
}}}


def _check_scene(scene_name: str, dropout: float) -> None:
    """Per-return dropout exists only in the courtyard's generator: asked for on a
    box-room scene it raises (the JAX package ignores it there, and still names
    the dataset as degraded)."""
    if scene_name not in SYNTHETIC_SCENES:
        raise ValueError(f"unknown synthetic scene {scene_name!r}: one of {SYNTHETIC_SCENES}")
    if dropout > 0 and not scene_name.startswith("courtyard"):
        raise ValueError(f"--synthetic_dropout is not read on {scene_name}: only the "
                         "courtyard scenes drop returns")


def synthetic_dataset_path(num_scans: int = 100, scene_name: str = "box_room",
                           noise_std: float = 0.0, dropout: float = 0.0,
                           with_camera: bool = False,
                           courtyard_scans: Optional[int] = None) -> str:
    """``./outputs/synthetic_dataset<suffix>``, the directory the JAX package's
    runner names for the same flags. ``courtyard_scans`` (the first scans of a
    courtyard drive; the JAX runner has no such cut) puts the count in the name,
    as the box room's does, so a cut drive is never taken for the whole one."""
    _check_scene(scene_name, dropout)
    if scene_name.startswith("courtyard"):
        # The length comes from the waypoint loop, unless the drive is cut.
        suffix = "" if courtyard_scans is None else f"_{courtyard_scans}"
    else:
        suffix = "" if num_scans == 100 else f"_{num_scans}"
    if with_camera:
        suffix += "_cam"
    if scene_name != "box_room":
        suffix += f"_{scene_name}"
    if noise_std > 0:
        suffix += f"_n{noise_std:g}"
    if dropout > 0:
        suffix += f"_d{dropout:g}"
    return os.path.join("./outputs", f"synthetic_dataset{suffix}")


def build_synthetic_dataset(
    out_dir: str, num_scans: int = 100, with_camera: bool = False,
    scene_name: str = "box_room", noise_std: float = 0.0, dropout: float = 0.0,
    courtyard_scans: Optional[int] = None,
) -> str:
    """Write a synthetic dataset to ``out_dir``: ``num_scans`` scans of a 32 x 512
    LiDAR in the box room (``open_sky``: without its ceiling), or the courtyard
    drive (``courtyard``, ``courtyard_actors`` with moving pedestrians; its
    length is the waypoint loop's, ``num_scans`` is not read, or its first
    ``courtyard_scans`` scans with the whole drive's GT poses, so that the world
    cube is the drive's); with the GT poses and, with ``with_camera``, one
    virtual-camera image a scan at its start time.
    The same scans as ``examples/run_loner.py::build_synthetic_dataset``; ``dropout``
    on a box-room scene raises. Written to ``<out_dir>.partial`` and renamed, so
    an interrupted build leaves no dataset that looks complete."""
    from loner_tpu_torch.datasets.synthetic import (
        BoxRoomScene, VirtualCamera, VirtualLidar, generate_courtyard_sequence,
        generate_sequence, make_courtyard, make_waypoint_trajectory, write_sequence,
    )

    _check_scene(scene_name, dropout)
    if scene_name.startswith("courtyard"):
        scans, poses, ts, scene, _ = generate_courtyard_sequence(
            with_actors=scene_name.endswith("_actors"), noise_std=noise_std, dropout=dropout,
            num_scans=courtyard_scans)
        if courtyard_scans is not None:
            poses, ts = make_waypoint_trajectory(*make_courtyard()[1:])
    else:
        scans, poses, ts, scene, _ = generate_sequence(
            num_scans=num_scans, scene=BoxRoomScene(open_top=(scene_name == "open_sky")),
            lidar=VirtualLidar(num_channels=32, num_columns=512), noise_std=noise_std)
    staging = out_dir.rstrip("/") + ".partial"
    if os.path.exists(staging):
        shutil.rmtree(staging)
    write_sequence(staging, scans, poses, ts, scene=scene,
                   camera=VirtualCamera() if with_camera else None,
                   meta={"sensor": "synthetic-box-room"})
    os.rename(staging, out_dir)
    return out_dir


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
    try:
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
    finally:
        loner.close()

    with open(os.path.join(loner.log_directory, "runtime.txt"), "w") as f:
        f.write(f"Runtime: {ingest_done - start}\n")
        f.write(f"Runtime With Overhead: {end - start}\n")
    print(f"Finished. Logs in {loner.log_directory}")
    return loner.log_directory


def trial_settings_list(settings: Settings, num_repeats: int) -> list:
    """One deep copy of ``settings`` a trial (a run changes its settings: the
    experiment name, log paths); with several trials, trial j's
    ``mapper.optimizer.seed`` is offset by j, since the same seed gives the same
    run."""
    out = []
    for trial_idx in range(num_repeats):
        trial = copy.deepcopy(settings)
        if num_repeats > 1:
            base = int(trial.mapper.optimizer.get("seed", 0))
            trial.augment({"mapper": {"optimizer": {"seed": base + trial_idx}}})
        out.append(trial)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run LONER SLAM with the PyTorch port")
    parser.add_argument("dataset_path", nargs="?", default=None,
                        help="scan-stream directory, 'auto' for the dataset a sequence config "
                        "names, or 'synthetic'")
    parser.add_argument("config", nargs="?", default=None, help="path to the config yaml")
    parser.add_argument("--resume", default=None, metavar="LOGDIR",
                        help="continue a run from its newest full checkpoint (configuration "
                        "and dataset from the run's full_config.pkl)")
    parser.add_argument("--experiment_name", default=None)
    parser.add_argument("--overrides", default=None, help="ablation overrides yaml")
    parser.add_argument("--run_all_combos", action="store_true",
                        help="the cross-product of each overrides document's values")
    parser.add_argument("--num_repeats", type=int, default=1,
                        help="trials of each variant, trial j at mapper.optimizer.seed + j")
    parser.add_argument("--duration", type=float, default=None, help="seconds of data")
    parser.add_argument("--synthetic_scans", type=int, default=100,
                        help="scan count when dataset_path is 'synthetic'")
    parser.add_argument("--synthetic_scene", choices=SYNTHETIC_SCENES, default="box_room",
                        help="scene when dataset_path is 'synthetic' (open_sky: no ceiling; "
                        "courtyard: the 64 x 48 m outdoor drive; courtyard_actors: with "
                        "moving pedestrians)")
    parser.add_argument("--synthetic_noise_std", type=float, default=0.0,
                        help="Gaussian range noise (m) of the synthetic dataset")
    parser.add_argument("--synthetic_dropout", type=float, default=0.0,
                        help="per-return dropout probability (courtyard scenes only)")
    parser.add_argument("--synthetic_camera", action="store_true",
                        help="also write virtual-camera images into the synthetic dataset")
    parser.add_argument("--gpu_ids", nargs="*", default=None,
                        help="CUDA device ordinals the trial pool's children are pinned to, "
                        "in turn (read only with --trial_workers > 1)")
    parser.add_argument("--trial_workers", type=int, default=0,
                        help="run the trials as up to this many child processes at a time; "
                        "0 or 1: one after another in this process")
    parser.add_argument("--_trial_spec", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--lite", action="store_true", help="fewer samples, for quick runs")
    parser.add_argument("--precompile", action="store_true",
                        help="build the kernels and run every program once before streaming")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    if args._trial_spec is not None:
        # A child of the trial pool: one trial from the parent's pickled spec.
        with open(args._trial_spec, "rb") as f:
            spec = pickle.load(f)
        run_trial(Settings(spec["settings"]), spec["dataset_path"],
                  experiment_name=spec["experiment_name"], config_idx=spec["config_idx"],
                  trial_idx=spec["trial_idx"], duration=spec["duration"], device=args.device)
        return
    precompile_changes = {"system": {"precompile": True}} if args.precompile else None

    if args.resume is not None:
        with open(os.path.join(args.resume, "full_config.pkl"), "rb") as f:
            settings = Settings(pickle.load(f))
        settings.augment(precompile_changes)
        run_trial(settings, settings["dataset_path"], duration=args.duration,
                  resume_from=args.resume, device=args.device)
        return
    if args.dataset_path is None or args.config is None:
        parser.error("dataset_path and config are required unless --resume is given")

    # A sequence config: its baseline, with its pass-through keys and changes
    # applied first, and the dataset it names for 'auto'.
    config, seq_changes, seq_passthrough = args.config, None, None
    seq = load_sequence_config(args.config)
    if seq is not None:
        config, seq_changes, seq_passthrough = seq["baseline"], seq["changes"], seq["passthrough"]
    dataset_path = args.dataset_path
    if dataset_path in ("auto", "-"):
        if seq is None or seq["raw"].get("dataset") is None:
            parser.error(f"{args.config} names no dataset: give the dataset directory")
        dataset_path = os.path.expanduser(seq["raw"]["dataset"])
    elif dataset_path == "synthetic":
        synth = dict(num_scans=args.synthetic_scans, scene_name=args.synthetic_scene,
                     noise_std=args.synthetic_noise_std, dropout=args.synthetic_dropout,
                     with_camera=args.synthetic_camera)
        dataset_path = synthetic_dataset_path(**synth)
        if not os.path.exists(os.path.join(dataset_path, "scans")):
            print(f"Generating synthetic dataset {dataset_path}...")
            build_synthetic_dataset(dataset_path, **synth)

    options, descriptions = generate_options(
        config, args.overrides, args.run_all_combos,
        augmentations=[seq_passthrough, seq_changes, LITE_CHANGES if args.lite else None,
                       precompile_changes])
    multi = len(options) > 1 or args.num_repeats > 1
    jobs = []
    for config_idx, (settings, desc) in enumerate(zip(options, descriptions)):
        if desc:
            print(f"config_{config_idx}: {desc}")
        for trial_idx, trial_settings in enumerate(trial_settings_list(settings,
                                                                       args.num_repeats)):
            jobs.append(dict(settings=trial_settings, dataset_path=dataset_path,
                             experiment_name=args.experiment_name,
                             config_idx=config_idx if multi else None,
                             trial_idx=trial_idx if args.num_repeats > 1 else None,
                             duration=args.duration))
    if args.trial_workers > 1 and len(jobs) > 1:
        run_trial_pool(jobs, args.trial_workers, args.gpu_ids, args.device)
        return
    for job in jobs:
        run_trial(job.pop("settings"), job.pop("dataset_path"), device=args.device, **job)


# A trial pool's child: this module's main, importable from any working directory.
CHILD = (f"import sys; sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r}); "
         "from loner_tpu_torch.run_loner import main; main()")


def run_trial_pool(jobs: list, workers: int, gpu_ids, device: str) -> None:
    """Each trial as a child process (``--_trial_spec``), at most ``workers`` at a
    time, pinned to ``gpu_ids`` in turn; exits 1 if a child failed."""
    import sys
    import tempfile

    from loner_tpu_torch.parallel.trial_pool import run_pool

    spec_dir = tempfile.mkdtemp(prefix="loner_trials_")
    commands = []
    for j, job in enumerate(jobs):
        spec_path = os.path.join(spec_dir, f"trial_{j}.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump({**job, "settings": job["settings"].as_plain_dict()}, f)
        commands.append([sys.executable, "-c", CHILD, "--_trial_spec", spec_path,
                         "--device", device])
    results = run_pool(commands, workers, devices=gpu_ids, on_start=lambda idx, dev: print(
        f"trial {idx}: started" + (f" on device {dev}" if dev is not None else ""), flush=True))
    shutil.rmtree(spec_dir, ignore_errors=True)
    for r in results:
        print(f"trial {r.index}: rc={r.returncode} wall={r.wall_s:.1f}s"
              + (f" device={r.device}" if r.device is not None else ""), flush=True)
    if any(r.returncode != 0 for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
