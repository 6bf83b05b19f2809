"""The real-data drill with the port: bag -> converter -> SLAM -> metrics.

Counterpart of ``examples/scripts/real_data_drill.sh`` (``docs/REAL_DATA.md``):
it writes an Ouster-style bag of the box room (``datasets/synthetic_bag.py``:
128 x 1024 organized clouds, bz2 chunks, u32 ns per-point times, /tf ground
truth, epoch-second header stamps), converts it (``convert_rosbag.py``), runs
threaded SLAM on it at ``cfg/synthetic/box_room_drill.yaml`` through
``run_loner.run_trial`` on ``--device`` (``cuda`` by default; never a fallback),
copies the dataset's ``poses_gt.tum`` to the run's
``trajectory/groundtruth.txt`` and runs ``analysis/metrics_pipeline.py`` on the
run. Each stage prints its seconds, and the bag stages their MB/s.

    python -m loner_tpu_torch.real_data_drill [out_dir] [--duration 60] [--device cuda]

``out_dir`` (default ``outputs/drill``) receives ``drill.bag``, its
``drill_gt.tum`` and ``dataset/``; the run logs under ``outputs/``, as the
configuration's ``system.log_dir_prefix`` says.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import List, Optional

from loner_tpu_torch import convert_rosbag
from loner_tpu_torch.analysis.metrics_pipeline import run_pipeline
from loner_tpu_torch.common.settings import Settings, load_config
from loner_tpu_torch.datasets import synthetic_bag
from loner_tpu_torch.run_loner import run_trial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL_CONFIG = os.path.join(REPO, "cfg", "synthetic", "box_room_drill.yaml")


def generate(bag: str, duration: float, channels: int = 128, columns: int = 1024,
             timestamp_mode: str = "ouster_ns", extra: Optional[List[str]] = None) -> dict:
    """Stage 1: the bag (``synthetic_bag``'s defaults, bz2 among them, but for the
    arguments). Returns its record with "mb_per_s"."""
    args = synthetic_bag.parse_args(
        [bag, "--duration", str(duration), "--channels", str(channels), "--columns",
         str(columns), "--timestamp_mode", timestamp_mode] + list(extra or []))
    out = synthetic_bag.write_bag(args)
    out["mb_per_s"] = out["bytes"] / 1e6 / out["seconds"]
    return out


def convert(bag: str, dataset: str, extra: Optional[List[str]] = None) -> dict:
    """Stage 2: the scan-stream dataset, ground truth from the bag's /tf (frame
    ``body``). Returns {"scans", "seconds", "mb_per_s"} (MB of bag a second)."""
    args = convert_rosbag.parse_args([bag, dataset, "--gt_topic", "/tf", "--gt_frame", "body"]
                                     + list(extra or []))
    t0 = time.perf_counter()
    scans = convert_rosbag.convert(args)
    seconds = time.perf_counter() - t0
    return {"scans": scans, "seconds": seconds,
            "mb_per_s": os.path.getsize(bag) / 1e6 / seconds}


def drill_settings(config: str = DRILL_CONFIG, changes: Optional[dict] = None) -> Settings:
    """The drill's settings: ``config`` through ``load_config``, with kernels
    built and every program run before the clock starts (``--precompile``),
    then ``changes``."""
    settings, _ = load_config(config)
    settings.augment({"system": {"precompile": True}})
    settings.augment(changes)
    return settings


def score(log_dir: str, dataset: str) -> dict:
    """Stage 4: the dataset's ground truth as the run's, then the metrics
    pipeline on the run. Returns the run's trajectory metrics."""
    shutil.copy(os.path.join(dataset, "poses_gt.tum"),
                os.path.join(log_dir, "trajectory", "groundtruth.txt"))
    out = run_pipeline(log_dir)
    print(out["summary"], flush=True)
    (res,) = out["trajectories"].values()
    if "error" in res:
        raise RuntimeError(f"metrics of {log_dir}: {res['error']}")
    return res


def run_drill(out_dir: str, duration: float = 60.0, device: str = "cuda",
              channels: int = 128, columns: int = 1024, config: str = DRILL_CONFIG,
              changes: Optional[dict] = None) -> dict:
    """The four stages; returns each stage's record and the run's log directory
    (experiment ``drill_run``, as the JAX package's drill names it)."""
    os.makedirs(out_dir, exist_ok=True)
    bag, dataset = os.path.join(out_dir, "drill.bag"), os.path.join(out_dir, "dataset")
    print(f"== 1/4 generate bag ({duration:g} s, {channels} x {columns}, bz2) ==", flush=True)
    gen = generate(bag, duration, channels, columns)
    print("== 2/4 convert bag -> scan stream ==", flush=True)
    conv = convert(bag, dataset)
    print(f"converter: {gen['bytes'] / 1e6:.1f} MB, {conv['scans']} scans in "
          f"{conv['seconds']:.2f} s = {conv['mb_per_s']:.2f} MB/s", flush=True)
    print(f"== 3/4 SLAM on the converted stream ({device}) ==", flush=True)
    t0 = time.perf_counter()
    log_dir = run_trial(drill_settings(config, changes), dataset,
                        experiment_name="drill_run", device=device)
    slam_s = time.perf_counter() - t0
    print("== 4/4 metrics ==", flush=True)
    t0 = time.perf_counter()
    metrics = score(log_dir, dataset)
    metrics_s = time.perf_counter() - t0
    print(f"== drill timings: generate {gen['seconds']:.2f} s ({gen['mb_per_s']:.2f} MB/s); "
          f"convert {conv['seconds']:.2f} s ({conv['mb_per_s']:.2f} MB/s); slam {slam_s:.2f} s; "
          f"metrics {metrics_s:.2f} s; ATE RMSE {metrics['ate']['rmse']:.4f} m ==", flush=True)
    return {"generate": gen, "convert": conv, "slam_s": slam_s, "metrics_s": metrics_s,
            "log_dir": log_dir, "metrics": metrics}


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="bag -> converter -> SLAM -> metrics with the port")
    p.add_argument("out_dir", nargs="?", default="outputs/drill")
    p.add_argument("--duration", type=float, default=60.0, help="seconds of bag")
    p.add_argument("--channels", type=int, default=128)
    p.add_argument("--columns", type=int, default=1024)
    p.add_argument("--config", default=DRILL_CONFIG)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    run_drill(args.out_dir, args.duration, args.device, args.channels, args.columns,
              args.config)


if __name__ == "__main__":
    main()
