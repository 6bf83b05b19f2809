"""The robustness drill: the courtyard drive and its degraded variants through the
port's SLAM, each scored against the static courtyard's ground-truth map.

Counterpart of ``examples/scripts/robustness_drill.sh`` (the drives) and
``examples/scripts/collect_robustness.py`` (the table):

    python -m loner_tpu_torch.robustness_drill [--runs label=name ...] [--gt_map PATH]
        [--skip_map] [--out PATH] [--num_scans N] [--device D]

Six runs of cfg/synthetic/courtyard_tpu_r5f.yaml (``CONFIG``) over the
same 151 s trajectory, each through ``run_loner``'s synthetic path
(``build_synthetic_dataset``, then ``run_trial`` with ``--precompile``): the
static courtyard, ``courtyard_actors`` (pedestrians crossing the LiDAR's view),
Gaussian range noise of 0.05 and 0.15 m, and per-return dropout of 0.3 and 0.6.
``--runs label=name`` picks some of them by the JAX script's labels (``static``,
``actors``, ``noise_0.05m``, ``noise_0.15m``, ``dropout_30pct``,
``dropout_60pct``) and names their experiment directories. Datasets are written
once under ``./outputs/synthetic_dataset*`` (the missing ones together, a thread
each) and runs under ``./outputs/<name>``;
a run whose ``runtime.txt`` exists is not driven again.

Each run is scored as the JAX script scores it: ATE and RPE (``delta_m`` 1 m)
against the run's own ground truth; the wall time and the real-time factor;
unless ``--skip_map``, the map cloud (``render_full_map`` at 5 cm voxels, every
third keyframe, variance below 0.25 m^2) against the *static* courtyard's GT map
masked to within 0.1 m of it: F@0.1 m, accuracy and completion. The static
geometry is what every run must reconstruct. Without ``--gt_map`` the GT map is
built from the static dataset (``create_lidar_map.build_gt_map``) and written
beside the datasets. The table goes to ``--out`` (default
``outputs/robustness.yaml``) with the JAX script's labels and keys, as JSON text
that a YAML reader reads.

``--num_scans N`` drives the first N scans of each dataset (a dataset and an
experiment directory of their own); the real-time factor is the sequence seconds
driven over the run's wall time (the whole drive: 151.2 s). ``--device`` defaults
to ``cuda`` and never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "cfg", "synthetic", "courtyard_tpu_r5f.yaml")


@dataclass(frozen=True)
class Variant:
    """One run of the drill: its label in the table, its experiment name and the
    synthetic dataset it drives."""

    label: str
    name: str
    scene: str
    noise_std: float = 0.0
    dropout: float = 0.0


# The JAX scripts' runs, in their order.
VARIANTS = (
    Variant("static", "courtyard_tpu_r5f", "courtyard"),
    Variant("actors", "courtyard_actors_r5", "courtyard_actors"),
    Variant("noise_0.05m", "courtyard_n0.05_r5", "courtyard", noise_std=0.05),
    Variant("noise_0.15m", "courtyard_n0.15_r5", "courtyard", noise_std=0.15),
    Variant("dropout_30pct", "courtyard_d0.3_r5", "courtyard", dropout=0.3),
    Variant("dropout_60pct", "courtyard_d0.6_r5", "courtyard", dropout=0.6),
)
STATIC = VARIANTS[0]


def select(runs: Optional[Sequence[str]] = None, num_scans: Optional[int] = None) -> List[Variant]:
    """The variants of ``runs`` (``label=name`` pairs; all six by default); with a
    scan cut, the default experiment names carry it."""
    by_label = {v.label: v for v in VARIANTS}
    if not runs:
        chosen = list(VARIANTS)
        if num_scans is not None:
            chosen = [Variant(v.label, f"{v.name}_{num_scans}", v.scene, v.noise_std, v.dropout)
                      for v in chosen]
        return chosen
    out = []
    for run in runs:
        label, sep, name = run.partition("=")
        if not sep or not name:
            raise ValueError(f"--runs takes label=name pairs, got {run!r}")
        if label not in by_label:
            raise ValueError(f"unknown run label {label!r}: one of {sorted(by_label)}")
        v = by_label[label]
        out.append(Variant(label, name, v.scene, v.noise_std, v.dropout))
    return out


def dataset_path(variant: Variant, root: str = ".", num_scans: Optional[int] = None) -> str:
    """The variant's synthetic dataset directory under ``root``."""
    from loner_tpu_torch.run_loner import synthetic_dataset_path

    return os.path.join(root, synthetic_dataset_path(
        scene_name=variant.scene, noise_std=variant.noise_std, dropout=variant.dropout,
        courtyard_scans=num_scans))


def datasets(variants: Sequence[Variant], root: str = ".",
             num_scans: Optional[int] = None) -> List[str]:
    """Each variant's dataset, written once: the missing ones together, one thread
    each (the ray casting is numpy, which leaves the interpreter lock while it
    works)."""
    from concurrent.futures import ThreadPoolExecutor

    from loner_tpu_torch.run_loner import build_synthetic_dataset

    paths = [dataset_path(v, root, num_scans) for v in variants]
    missing = {p: v for p, v in zip(paths, variants)
               if not os.path.exists(os.path.join(p, "scans"))}
    if missing:
        print(f"Generating synthetic datasets {sorted(missing)}...", flush=True)
        with ThreadPoolExecutor(max_workers=min(len(missing), os.cpu_count() or 1)) as pool:
            futures = [pool.submit(build_synthetic_dataset, p, scene_name=v.scene,
                                   noise_std=v.noise_std, dropout=v.dropout,
                                   courtyard_scans=num_scans) for p, v in missing.items()]
            for f in futures:
                f.result()
    return paths


def drive(variant: Variant, data: str, config: str = CONFIG, root: str = ".",
          device: str = "cuda") -> str:
    """SLAM at ``config`` (with ``--precompile``) on ``data`` into
    ``<root>/outputs/<name>``, unless its ``runtime.txt`` exists. Returns the
    log directory."""
    from loner_tpu_torch.common.settings import load_config
    from loner_tpu_torch.run_loner import run_trial

    log_dir = os.path.join(root, "outputs", variant.name)
    if os.path.isfile(os.path.join(log_dir, "runtime.txt")):
        print(f"== {variant.name}: already done, skipping", flush=True)
        return log_dir
    settings, _ = load_config(config)
    settings.augment({"system": {"precompile": True,
                                 "log_dir_prefix": os.path.join(root, "outputs")}})
    print(f"== {variant.name}: {variant.scene}, noise {variant.noise_std:g} m, dropout "
          f"{variant.dropout:g}", flush=True)
    return run_trial(settings, data, experiment_name=variant.name, device=device)


def sequence_seconds(data: str) -> float:
    """The seconds a dataset's scans span, first start to last start (the whole
    courtyard drive's 1513 scans at 10 Hz: 151.2)."""
    from loner_tpu_torch.datasets.scan_stream import ScanStreamReader

    starts = ScanStreamReader(data).start_times()
    return float(starts[-1] - starts[0])


def gt_map(root: str = ".", num_scans: Optional[int] = None) -> str:
    """The static courtyard's GT map (``build_gt_map`` over its dataset), written
    once as ``<root>/outputs/gt_map_courtyard[_<num_scans>].pcd``."""
    from loner_tpu_torch.analysis.create_lidar_map import build_gt_map
    from loner_tpu_torch.analysis.renderer_lidar import write_pcd

    path = os.path.join(root, "outputs", "gt_map_courtyard"
                        + ("" if num_scans is None else f"_{num_scans}") + ".pcd")
    if not os.path.isfile(path):
        write_pcd(build_gt_map(datasets([STATIC], root, num_scans)[0]), path)
    return path


def score(log_dir: str, data: str, gt_path: Optional[str], device: str = "cuda") -> dict:
    """One row of the table (``collect_robustness.py``'s keys and roundings); the
    map's keys only with ``gt_path``."""
    from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files

    traj = evaluate_trajectory_files(
        os.path.join(log_dir, "trajectory", "estimated_trajectory.txt"),
        os.path.join(log_dir, "trajectory", "groundtruth.txt"), delta_m=1.0)
    with open(os.path.join(log_dir, "runtime.txt")) as f:
        runtime = float(f.readline().split(":")[1])
    row = {"ate_rmse_m": round(float(traj["ate"]["rmse"]), 4),
           "ate_max_m": round(float(traj["ate"]["max"]), 4),
           "rpe_trans_rmse_m": round(float(traj["rpe_trans"]["rmse"]), 4),
           "runtime_s": round(runtime, 1),
           "rtf": round(sequence_seconds(data) / runtime, 3)}
    if gt_path is not None:
        from loner_tpu_torch.analysis.evaluate_lidar_map import evaluate_lidar_map
        from loner_tpu_torch.analysis.mask_gt_with_trajectory import mask_gt_map
        from loner_tpu_torch.analysis.renderer_lidar import read_pcd, render_full_map

        rendered = render_full_map(log_dir, "final.tar", voxel_size=0.05, skip_step=3,
                                   var_threshold=0.25, device=device)
        gt_masked = mask_gt_map(read_pcd(gt_path), rendered, dist_threshold=0.1)
        stats = evaluate_lidar_map(rendered, gt_masked, voxel_size=0.05, f_score_threshold=0.1,
                                   log_dir=log_dir, device=device)
        row["map_f_at_0.1m"] = round(float(stats["f_score"]), 4)
        row["map_accuracy_m"] = round(float(stats["accuracy"]), 4)
        row["map_completion_m"] = round(float(stats["completion"]), 4)
    return row


def main(argv=None) -> dict:
    from loner_tpu_torch.common.device import resolve_device
    from loner_tpu_torch.common.json_yaml import write_json_yaml

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", nargs="*", default=None,
                   help="label=name pairs (labels: " + ", ".join(v.label for v in VARIANTS) + ")")
    p.add_argument("--gt_map", default=None,
                   help="the static courtyard's GT map (default: built from its dataset)")
    p.add_argument("--skip_map", action="store_true", help="trajectory and RTF only")
    p.add_argument("--out", default=os.path.join("outputs", "robustness.yaml"))
    p.add_argument("--num_scans", type=int, default=None,
                   help="drive only the first N scans of each dataset")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.num_scans is not None and args.num_scans < 2:
        raise ValueError(f"--num_scans must be at least 2, got {args.num_scans}")
    device = str(resolve_device(args.device))

    variants = select(args.runs, args.num_scans)
    runs = [(v, data, drive(v, data, CONFIG, device=device))
            for v, data in zip(variants, datasets(variants, num_scans=args.num_scans))]
    gt_path = None
    if not args.skip_map:
        gt_path = args.gt_map or gt_map(num_scans=args.num_scans)
    table = {}
    for v, data, log_dir in runs:
        table[v.label] = score(log_dir, data, gt_path, device)
        print(f"-- {v.label}: {table[v.label]}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_json_yaml(args.out, table, sort_keys=False)  # the JAX script's order
    print(f"wrote {args.out}", flush=True)
    return table


if __name__ == "__main__":
    main()
