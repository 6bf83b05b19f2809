"""The port's robustness drill (``loner_tpu_torch.robustness_drill``) on the CPU.

All six runs of the JAX scripts (``examples/scripts/robustness_drill.sh``,
``collect_robustness.py``) on cfg/synthetic/courtyard_tiny.yaml over the first
``SCANS`` scans of each courtyard dataset, cut for the CPU: a 16 x 128 LiDAR in
place of the 64 x 1024 one, map clouds of 16 x 128 rays x 64 samples a scan,
and the map evaluation without its ICP alignment. Checked: the table's labels
and keys are the JAX script's, in its order, in the file as in the return
value; each run's trajectory figures equal the JAX package's
``evaluate_trajectory_files`` on the run's files, rounded as the JAX script
rounds; the real-time factor is the driven seconds over the run's wall time; a
finished run is not driven again. The map pipeline runs for every row; at this
cut its clouds keep too few points to score (F 0, NaN distances, as the JAX
script's empty masks give).
"""
import functools
import os

import numpy as np
import pytest
import torch
import yaml

from loner_tpu.analysis.traj_metrics import evaluate_trajectory_files as jax_traj
from loner_tpu_torch import robustness_drill as drill
from loner_tpu_torch.analysis import evaluate_lidar_map, renderer_lidar
from loner_tpu_torch.datasets import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "cfg", "synthetic", "courtyard_tiny.yaml")
SCANS = 12
LABELS = ["static", "actors", "noise_0.05m", "noise_0.15m", "dropout_30pct", "dropout_60pct"]
KEYS = ["ate_rmse_m", "ate_max_m", "rpe_trans_rmse_m", "runtime_s", "rtf",
        "map_f_at_0.1m", "map_accuracy_m", "map_completion_m"]


@pytest.fixture
def cut(monkeypatch, tmp_path):
    torch.set_num_threads(2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(drill, "CONFIG", CONFIG)
    monkeypatch.setattr(synthetic, "generate_courtyard_sequence", functools.partial(
        synthetic.generate_courtyard_sequence,
        lidar=synthetic.VirtualLidar(num_channels=16, num_columns=128, max_range=60.0)))
    monkeypatch.setattr(renderer_lidar, "render_full_map", functools.partial(
        renderer_lidar.render_full_map, num_channels=16, num_columns=128, n_samples=64))
    monkeypatch.setattr(evaluate_lidar_map, "evaluate_lidar_map", functools.partial(
        evaluate_lidar_map.evaluate_lidar_map, refine_alignment=False))
    return tmp_path


def test_drill_writes_the_jax_table_and_skips_finished_runs(cut, monkeypatch):
    argv = ["--num_scans", str(SCANS), "--device", "cpu"]
    table = drill.main(argv)

    assert list(table) == LABELS
    for label, row in table.items():
        assert list(row) == KEYS, label
        # The map figures are NaN where no rendered point survives the variance
        # cut (an empty mask), as the JAX script's are; the rest are finite.
        assert all(np.isfinite(row[k]) for k in KEYS[:5]), (label, row)
    with open(cut / "outputs" / "robustness.yaml") as f:
        written = yaml.safe_load(f)
    assert list(written) == LABELS
    np.testing.assert_equal(written, table)  # NaN equal to NaN

    for v in drill.select(None, SCANS):
        log_dir = cut / "outputs" / v.name
        assert v.name.endswith(f"_{SCANS}")
        want = jax_traj(str(log_dir / "trajectory" / "estimated_trajectory.txt"),
                        str(log_dir / "trajectory" / "groundtruth.txt"), delta_m=1.0)
        row = table[v.label]
        assert row["ate_rmse_m"] == round(float(want["ate"]["rmse"]), 4)
        assert row["ate_max_m"] == round(float(want["ate"]["max"]), 4)
        assert row["rpe_trans_rmse_m"] == round(float(want["rpe_trans"]["rmse"]), 4)
        runtime = float(open(log_dir / "runtime.txt").readline().split(":")[1])
        assert row["rtf"] == round((SCANS - 1) * 0.1 / runtime, 3)
    # Every variant's dataset is a cut one, named so.
    assert sorted(p.name for p in (cut / "outputs").glob("synthetic_dataset*")) == sorted(
        f"synthetic_dataset_{SCANS}_{s}" for s in (
            "courtyard", "courtyard_actors", "courtyard_n0.05", "courtyard_n0.15",
            "courtyard_d0.3", "courtyard_d0.6"))

    def no_drive(*args, **kwargs):
        raise AssertionError("a finished run was driven again")

    monkeypatch.setattr("loner_tpu_torch.run_loner.run_trial", no_drive)
    again = drill.main(argv + ["--runs", f"static=courtyard_tpu_r5f_{SCANS}",
                               f"actors=courtyard_actors_r5_{SCANS}", "--skip_map",
                               "--out", "again.yaml"])
    assert list(again) == ["static", "actors"]
    for label, row in again.items():
        assert row == {k: table[label][k] for k in KEYS[:5]}
    assert not (cut / "again.yaml").read_text().count("map_")


@pytest.mark.parametrize("runs", [["static"], ["bogus=x"], ["static=a", "=b"]])
def test_runs_must_be_known_label_name_pairs(runs):
    with pytest.raises(ValueError):
        drill.select(runs)
