"""Batch metric pipelines over experiment output trees.

Counterpart of ``loner_tpu/analysis/metrics_pipeline.py``: walks
``outputs/<experiment>/[config_<i>/][trial_<j>/]`` layouts, computes trajectory
ATE/RPE (``analysis/traj_metrics.py``) and collects the map statistics and L1
files of each trial, then writes a mean/median/min summary CSV, a LaTeX table
and the per-drive regression record. YAML files are written as JSON text
(``common/json_yaml.py``) and read as JSON first; only a file that is not JSON,
such as one the JAX package wrote, is read with PyYAML, imported there.

    python -m loner_tpu_torch.analysis.metrics_pipeline <experiment_dir> [--delta_m 3.0]
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
from loner_tpu_torch.common.json_yaml import read_json_yaml, write_json_yaml


def find_trial_dirs(experiment_dir: str) -> List[str]:
    """All trial leaf dirs under an experiment (handles config_i/trial_j)."""
    out = []
    for root, _dirs, _files in os.walk(experiment_dir):
        if os.path.isdir(os.path.join(root, "trajectory")):
            out.append(root)
    return sorted(out)


def analyze_trajectories(
    experiment_dir: str,
    gt_file: Optional[str] = None,
    est_name: str = "estimated_trajectory.txt",
    delta_m: float = 3.0,
) -> Dict[str, dict]:
    """Per-trial ATE/RPE; GT defaults to each trial's logged groundtruth."""
    results = {}
    for trial in find_trial_dirs(experiment_dir):
        est = os.path.join(trial, "trajectory", est_name)
        gt = gt_file or os.path.join(trial, "trajectory", "groundtruth.txt")
        if not (os.path.exists(est) and os.path.exists(gt)):
            continue
        try:
            results[os.path.relpath(trial, experiment_dir)] = evaluate_trajectory_files(
                est, gt, delta_m
            )
        except Exception as e:  # noqa: BLE001 — keep the batch going per trial
            results[os.path.relpath(trial, experiment_dir)] = {"error": str(e)}
    return results


def summarize_results(
    results: Dict[str, dict],
    out_csv: Optional[str] = None,
    out_tex: Optional[str] = None,
) -> str:
    """mean/median/min ATE RMSE per config across trials, plus mean RPE
    translation and rotation RMSE."""
    by_config: Dict[str, List[dict]] = {}
    for trial, res in results.items():
        if "error" in res:
            continue
        # config_i/trial_j layouts group by config_i; flat layouts (no
        # trial level) group by the leaf itself.
        config = os.path.dirname(trial) or trial
        by_config.setdefault(config, []).append(res)

    lines = [
        "config,num_trials,ate_rmse_mean,ate_rmse_median,ate_rmse_min,"
        "rpe_trans_rmse_mean,rpe_rot_rmse_mean_deg"
    ]
    tex = [
        "\\begin{tabular}{lcccccc}",
        "config & N & ATE mean & median & min & RPE$_t$ & RPE$_r$ (deg) \\\\",
    ]
    for config, trials in sorted(by_config.items()):
        arr = np.asarray([t["ate"]["rmse"] for t in trials])
        rpe_t = np.asarray([t["rpe_trans"]["rmse"] for t in trials if "rpe_trans" in t])
        rpe_r = np.asarray([t["rpe_rot"]["rmse"] for t in trials if "rpe_rot" in t])
        rt = f"{rpe_t.mean():.4f}" if rpe_t.size else ""
        rr = f"{rpe_r.mean():.4f}" if rpe_r.size else ""
        lines.append(
            f"{config},{len(arr)},{arr.mean():.4f},{np.median(arr):.4f},"
            f"{arr.min():.4f},{rt},{rr}"
        )
        tex.append(
            f"{config} & {len(arr)} & {arr.mean():.4f} & {np.median(arr):.4f}"
            f" & {arr.min():.4f} & {rt} & {rr} \\\\"
        )
    tex.append("\\end{tabular}")

    csv = "\n".join(lines)
    if out_csv:
        with open(out_csv, "w") as f:
            f.write(csv + "\n")
    if out_tex:
        with open(out_tex, "w") as f:
            f.write("\n".join(tex) + "\n")
    return csv


def collect_map_metrics(experiment_dir: str) -> Dict[str, dict]:
    """Collect metrics/statistics*.yaml + metrics/l1*.yaml per trial."""
    results = {}
    for trial in find_trial_dirs(experiment_dir):
        entry = {}
        for f in glob.glob(os.path.join(trial, "metrics", "*.yaml")):
            entry[os.path.splitext(os.path.basename(f))[0]] = read_json_yaml(f)
        if entry:
            results[os.path.relpath(trial, experiment_dir)] = entry
    return results


def write_regression_file(
    experiment_dir: str,
    traj_results: Optional[Dict[str, dict]] = None,
    map_results: Optional[Dict[str, dict]] = None,
    out_path: Optional[str] = None,
    round_digits: int = 4,
) -> dict:
    """Write a canonical, diff-stable ``regression.yaml`` for a drive.

    One flat schema per trial: ATE RMSE, RPE translation + rotation RMSE, and
    (when the map eval has been run) L1 depth mean/rmse, F-score, chamfer, all
    rounded to ``round_digits``, with every mapping's keys sorted."""
    traj_results = (
        analyze_trajectories(experiment_dir) if traj_results is None else traj_results
    )
    map_results = (
        collect_map_metrics(experiment_dir) if map_results is None else map_results
    )

    def rnd(x):
        return round(float(x), round_digits)

    trials = {}
    for trial, res in sorted(traj_results.items()):
        if "error" in res:
            trials[trial] = {"error": res["error"]}
            continue
        entry = {
            "ate_rmse": rnd(res["ate"]["rmse"]),
            "ate_mean": rnd(res["ate"]["mean"]),
            "rpe_trans_rmse": rnd(res["rpe_trans"]["rmse"]),
            "rpe_rot_rmse_deg": rnd(res["rpe_rot"]["rmse"]),
        }
        maps = map_results.get(trial, {})
        for _name, stats in sorted(maps.items()):
            if not isinstance(stats, dict):
                continue
            if "f_score" in stats:  # evaluate_lidar_map statistics file
                entry["map_f_score"] = rnd(stats["f_score"])
                entry["map_chamfer"] = rnd(stats["chamfer"])
                entry["map_accuracy"] = rnd(stats["accuracy"])
                entry["map_completion"] = rnd(stats["completion"])
            elif "mean" in stats and "rmse" in stats:  # compute_l1_depth file
                entry["l1_mean"] = rnd(stats["mean"])
                entry["l1_rmse"] = rnd(stats["rmse"])
        trials[trial] = entry

    ates = [t["ate_rmse"] for t in trials.values() if "ate_rmse" in t]
    record = {
        "schema": 1,
        "experiment": os.path.basename(os.path.normpath(experiment_dir)),
        "num_trials": len(ates),
        "aggregate": (
            {
                "ate_rmse_mean": rnd(np.mean(ates)),
                "ate_rmse_median": rnd(np.median(ates)),
                "ate_rmse_min": rnd(np.min(ates)),
            }
            if ates
            else {}
        ),
        "trials": trials,
    }
    out_path = out_path or os.path.join(experiment_dir, "regression.yaml")
    write_json_yaml(out_path, record)
    return record


def run_pipeline(experiment_dir: str, gt_file: Optional[str] = None,
                 delta_m: float = 3.0) -> dict:
    """Every output of the pipeline for ``experiment_dir``: ``traj_metrics.yaml``,
    ``summary.csv`` / ``summary.tex``, ``map_metrics.yaml`` (when a trial has map
    metrics) and ``regression.yaml``. Returns {"trajectories", "summary",
    "maps", "regression"}."""
    results = analyze_trajectories(experiment_dir, gt_file, delta_m=delta_m)
    write_json_yaml(os.path.join(experiment_dir, "traj_metrics.yaml"), results)
    csv = summarize_results(
        results,
        out_csv=os.path.join(experiment_dir, "summary.csv"),
        out_tex=os.path.join(experiment_dir, "summary.tex"),
    )
    maps = collect_map_metrics(experiment_dir)
    if maps:
        write_json_yaml(os.path.join(experiment_dir, "map_metrics.yaml"), maps)
    record = write_regression_file(experiment_dir, results, maps)
    return {"trajectories": results, "summary": csv, "maps": maps, "regression": record}


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Trajectory + map metrics over an experiment tree")
    p.add_argument("experiment_dir")
    p.add_argument("--gt_file", default=None)
    p.add_argument("--delta_m", type=float, default=3.0)
    args = p.parse_args(argv)

    out = run_pipeline(args.experiment_dir, args.gt_file, args.delta_m)
    print(out["summary"])
    if out["maps"]:
        print(f"map metrics for {len(out['maps'])} trials collected")
    print(f"regression record: {os.path.join(args.experiment_dir, 'regression.yaml')}")


if __name__ == "__main__":
    main()
