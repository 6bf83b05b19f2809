"""The port's map-quality tools against the JAX package's, on the CPU.

Same numpy inputs go through the JAX function and its counterpart in
``loner_tpu_torch`` (``device="cpu"``):

- ``evaluate_lidar_map`` on the clouds of tests/test_map_metrics.py: without the
  alignment ICP every statistic equal (the same numpy and scipy code); with it
  (the port's ``run_icp_schedule`` against JAX's), within 1e-6 absolute on
  distances in metres and equal counts;
- ``build_gt_map`` and ``mask_gt_map`` on a box-room dataset: equal arrays;
- ``compute_l1_depth`` on a tiny SLAM run of the port (tests/test_torch_slam.py's
  settings; JAX loads its checkpoint): the same frames and rays, so the same
  ``num_rays``, and mean and RMSE within 1e-4 relative (the renders agree to
  2e-5 relative, tests/test_torch_render.py; measured: equal);
- ``l1_breakdown`` on that run: the metric's own rays, so the same count, and
  mean, RMSE and max within 1e-4 relative of ``compute_l1_depth``;
- ``get_mesh`` of that trained run (JAX and the port, resolution 32, the
  weight grid's rays cut as in tests/test_torch_mesh.py): counts within 1%,
  symmetric chamfer below 1e-3 m;
- ``metrics_pipeline`` on a tree of two trials: the same summary CSV and LaTeX
  text, and the same ``regression.yaml`` after ``yaml.safe_load``;
- every file the eval path writes (``metrics/statistics.yaml``, ``l1.yaml``,
  ``regression.yaml`` and the pipeline CLI's ``traj_metrics.yaml`` and
  ``map_metrics.yaml``) loads with ``yaml.safe_load`` to the values returned;
- the chain of ``eval_map_quality`` on that run; every entry point raises
  without a card unless asked for the CPU.
"""
import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

from loner_tpu.analysis import compute_l1_depth as jl1
from loner_tpu.analysis import evaluate_lidar_map as jeval
from loner_tpu.analysis import metrics_pipeline as jpipe
from loner_tpu_torch.analysis import compute_l1_depth as tl1
from loner_tpu_torch.analysis import create_lidar_map as tgt
from loner_tpu_torch.analysis import eval_map_quality as tchain
from loner_tpu_torch.analysis import evaluate_lidar_map as teval
from loner_tpu_torch.analysis import mask_gt_with_trajectory as tmask
from loner_tpu_torch.analysis import metrics_pipeline as tpipe
from loner_tpu_torch.analysis.renderer_lidar import read_pcd, write_pcd
from loner_tpu_torch.common.json_yaml import read_json_yaml, write_json_yaml
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, ScanStreamWriter
from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence
from loner_tpu_torch.run_loner import run_trial
from test_map_metrics import _grid_cloud
from test_torch_slam import tiny_settings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
from create_lidar_map import build_gt_map as j_build_gt_map  # noqa: E402
from mask_gt_with_trajectory import mask_gt_map as j_mask_gt_map  # noqa: E402

ICP_ATOL = 1e-6  # metres, statistics after the alignment ICP (measured 1.4e-8)
L1_RTOL = 1e-4
# The L1 metric and the map cloud cut for the CPU (defaults: 25 scans x 2048 rays
# at 1024 samples; 64 x 1024 rays at 1024 samples a virtual scan).
L1_SMALL = dict(num_frames=6, rays_per_frame=256, n_samples=64)
RENDER_SMALL = dict(num_channels=16, num_columns=128, n_samples=64)


def _icp_clouds():
    """tests/test_map_metrics.py's ICP case: 2000 points on three box faces, the
    estimate shifted by 2 cm."""
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 2, (2000, 3)).astype(np.float32)
    gt[::3, 2] = 0.0
    gt[1::3, 0] = 0.0
    gt[2::3, 1] = 0.0
    return gt + np.array([0.02, -0.015, 0.01], np.float32), gt


def _clouds(case: str):
    gt = _grid_cloud()
    if case == "identical":
        return gt, gt.copy(), 0.05
    if case == "offset":
        return gt + np.array([0.0, 0.0, 0.05], np.float32), gt, 0.02
    far = gt[: len(gt) // 2] + np.array([0.0, 0.0, 0.3], np.float32)
    return np.concatenate([gt[len(gt) // 2 :], far]), gt, 0.02


@pytest.mark.parametrize("case", ["identical", "offset", "threshold split"])
def test_evaluate_lidar_map_without_icp_matches_jax(case, tmp_path):
    est, gt, voxel = _clouds(case)
    ref = jeval.evaluate_lidar_map(est, gt, voxel_size=voxel, refine_alignment=False,
                                   log_dir=str(tmp_path / "jax"))
    out = teval.evaluate_lidar_map(est, gt, voxel_size=voxel, refine_alignment=False,
                                   log_dir=str(tmp_path / "port"))
    assert out == ref
    for side in ("jax", "port"):
        with open(tmp_path / side / "metrics" / "statistics.yaml") as f:
            assert yaml.safe_load(f) == ref
    assert read_json_yaml(str(tmp_path / "jax" / "metrics" / "statistics.yaml")) == ref


def test_evaluate_lidar_map_with_icp_matches_jax():
    est, gt = _icp_clouds()
    ref = jeval.evaluate_lidar_map(est, gt, voxel_size=0.01, refine_alignment=True)
    out = teval.evaluate_lidar_map(est, gt, voxel_size=0.01, refine_alignment=True,
                                   device="cpu")
    assert out["accuracy"] < 0.02 and out["f_score"] > 0.95  # the 2 cm shift is absorbed
    for k, v in ref.items():
        if k.startswith("num_"):
            assert out[k] == v
        else:
            assert out[k] == pytest.approx(v, abs=ICP_ATOL), k


@pytest.fixture(scope="module")
def slam(tmp_path_factory):
    """A tiny SLAM run of the port (tests/test_torch_slam.py's settings), its
    dataset and the dataset's GT map."""
    root = str(tmp_path_factory.mktemp("map_metrics"))
    scans, poses, ts, _, _ = generate_sequence(
        num_scans=24, lidar=VirtualLidar(num_channels=16, num_columns=128, max_range=30.0),
        rate_hz=5.0)
    dataset = os.path.join(root, "ds")
    writer = ScanStreamWriter(dataset)
    for s in scans:
        writer.add_scan(s)
    writer.write_gt(poses, ts)
    log_dir = run_trial(tiny_settings(os.path.join(root, "outputs"), True), dataset,
                        experiment_name="map_metrics", device="cpu")
    return {"dataset": dataset, "log_dir": log_dir, "root": root,
            "gt_map": tgt.build_gt_map(dataset)}


def test_scan_stream_reader_members_match_jax(slam):
    from loner_tpu.datasets.scan_stream import ScanStreamReader as JReader

    reader, jreader = ScanStreamReader(slam["dataset"]), JReader(slam["dataset"])
    np.testing.assert_array_equal(reader.time_spans(), jreader.time_spans())
    np.testing.assert_array_equal(reader.start_times(), jreader.start_times())
    assert reader.time_spans() is reader.time_spans()  # cached
    t = float(reader.start_times()[5])
    np.testing.assert_array_equal(reader.gt_interpolator.at(t).matrix,
                                  jreader.gt_interpolator.at(t).matrix)


def test_build_gt_map_and_mask_match_jax(slam):
    ref = j_build_gt_map(slam["dataset"])
    np.testing.assert_array_equal(slam["gt_map"], ref)
    assert ref.shape[0] > 10_000
    np.testing.assert_array_equal(tgt.build_gt_map(slam["dataset"], voxel_size=0.2, skip=3,
                                                   max_range=8.0),
                                  j_build_gt_map(slam["dataset"], voxel_size=0.2, skip=3,
                                                 max_range=8.0))
    rec = ref[::7] + np.random.default_rng(2).normal(0, 0.05, (len(ref[::7]), 3)).astype(
        np.float32)
    tf = np.eye(4)
    tf[:3, 3] = [0.03, -0.02, 0.01]
    for transform in (None, tf):
        masked = tmask.mask_gt_map(ref, rec, transform=transform)
        np.testing.assert_array_equal(masked, j_mask_gt_map(ref, rec, transform=transform))
        assert 0 < len(masked) < len(ref)


def test_compute_l1_depth_matches_jax(slam):
    ref = jl1.compute_l1_depth(slam["log_dir"], write=False, **L1_SMALL)
    out = tl1.compute_l1_depth(slam["log_dir"], device="cpu", **L1_SMALL)
    assert out["num_rays"] == ref["num_rays"] > 500
    for k in ("mean", "rmse"):
        assert out[k] == pytest.approx(ref[k], rel=L1_RTOL), k
    with open(os.path.join(slam["log_dir"], "metrics", "l1.yaml")) as f:
        assert yaml.safe_load(f) == out


def test_l1_breakdown_holds_the_metric_and_splits_its_rays(slam):
    from loner_tpu_torch.analysis.l1_breakdown import l1_breakdown

    ref = tl1.compute_l1_depth(slam["log_dir"], device="cpu", write=False, **L1_SMALL)
    out = l1_breakdown(slam["log_dir"], device="cpu", worst=16, **L1_SMALL)
    assert out["num_rays"] == ref["num_rays"]
    for k in ("mean", "rmse", "max"):
        assert out["metric"][k] == pytest.approx(ref[k], rel=L1_RTOL), k
    for hist in (out["tail"]["range_m"], out["tail"]["elevation_deg"]):
        assert sum(hist["all"]) == out["num_rays"] and sum(hist["tail"]) == out["tail"]["rays"]
    assert len(out["frames"]) > 1 and out["keyframes"] >= 2
    worst = out["worst_rays"]["metric"]
    assert worst.shape == (16,) and (np.diff(worst) <= 0).all()
    assert worst[0] == pytest.approx(ref["max"], rel=L1_RTOL)


def test_get_mesh_of_a_trained_slam_run_matches_jax(slam, monkeypatch, tmp_path):
    # A checkpoint the port trained (the flagship's Fourier field and proposal
    # sampler, cut small), beside tests/test_torch_mesh.py's random weights; the
    # same cuts and bounds as there.
    from loner_tpu.analysis import mesher as jmesher
    from loner_tpu_torch.analysis import mesher as tmesher
    from test_torch_mesh import MESH_CHAMFER_M, MESH_COUNT_SHARE, SMALL_GRID

    for module in (jmesher, tmesher):
        monkeypatch.setattr(module, "build_weight_grid",
                            functools.partial(module.build_weight_grid, **SMALL_GRID))
    vj, fj = jmesher.get_mesh(slam["log_dir"], resolution=32, skip_step=1,
                              out_file=str(tmp_path / "jax.ply"))
    report = {}
    vt, ft = tmesher.get_mesh(slam["log_dir"], resolution=32, skip_step=1, device="cpu",
                              out_file=str(tmp_path / "port.ply"), report=report)
    assert len(vj) > 100 and report["cells_above_level"] > 50
    assert abs(len(vt) - len(vj)) <= MESH_COUNT_SHARE * len(vj)
    assert abs(len(ft) - len(fj)) <= MESH_COUNT_SHARE * len(fj)
    chamfer = cKDTree(vj).query(vt)[0].mean() + cKDTree(vt).query(vj)[0].mean()
    assert chamfer < MESH_CHAMFER_M, chamfer


def test_eval_chain_writes_what_safe_load_reads_back(slam, monkeypatch):
    # Two alignment iterations a stage (the ICP is held to JAX's above): the
    # 8192-point ICP takes ~1 s an iteration on one CPU thread.
    monkeypatch.setattr(teval, "ICP_SCHEDULE", [{"threshold": 0.5, "max_iterations": 2},
                                                {"threshold": 0.1, "max_iterations": 2}])
    monkeypatch.setattr(tchain, "render_full_map",
                        functools.partial(tchain.render_full_map, **RENDER_SMALL))
    monkeypatch.setattr(tchain, "compute_l1_depth",
                        functools.partial(tchain.compute_l1_depth, **L1_SMALL))
    out = tchain.eval_map_quality(slam["log_dir"], slam["gt_map"], device="cpu")
    assert set(out["seconds"]) == {"render", "mask", "evaluate", "l1"}
    assert 0 < out["masked_gt_points"] < out["gt_points"] == len(slam["gt_map"])
    metrics = os.path.join(slam["log_dir"], "metrics")
    for name, value in (("statistics", out["statistics"]), ("l1", out["l1"])):
        with open(os.path.join(metrics, f"{name}.yaml")) as f:
            assert yaml.safe_load(f) == value
    masked = read_pcd(os.path.join(slam["log_dir"], "lidar_renders", "gt_map_masked.pcd"))
    assert masked.shape == (out["masked_gt_points"], 3)
    assert out["statistics"]["num_gt_points"] <= len(masked)


def _two_trial_tree(slam, root: str) -> str:
    """An experiment tree of two trials of the SLAM run; the second's estimate
    moved by 1 cm; map metrics in the first, written by the port."""
    exp = os.path.join(root, "exp")
    for i in range(2):
        trial = os.path.join(exp, "config_0", f"trial_{i}")
        shutil.copytree(os.path.join(slam["log_dir"], "trajectory"),
                        os.path.join(trial, "trajectory"))
    est = os.path.join(exp, "config_0", "trial_1", "trajectory", "estimated_trajectory.txt")
    rows = np.loadtxt(est)
    rows[:, 1:4] += 0.01
    np.savetxt(est, rows, fmt="%.10f")
    metrics = os.path.join(exp, "config_0", "trial_0", "metrics")
    os.makedirs(metrics)
    write_json_yaml(os.path.join(metrics, "statistics.yaml"),
                    {"accuracy": 0.031, "completion": 0.042, "chamfer": 0.073, "f_score": 0.95,
                     "precision": 0.97, "recall": 0.93, "threshold": 0.1})
    write_json_yaml(os.path.join(metrics, "l1.yaml"),
                    {"min": 1e-05, "max": 2.5, "mean": 0.12345678, "rmse": 0.25, "num_rays": 99})
    return exp


def test_metrics_pipeline_matches_jax(slam, tmp_path):
    exp = _two_trial_tree(slam, str(tmp_path))
    assert tpipe.find_trial_dirs(exp) == jpipe.find_trial_dirs(exp)
    results, ref = tpipe.analyze_trajectories(exp), jpipe.analyze_trajectories(exp)
    assert sorted(results) == ["config_0/trial_0", "config_0/trial_1"]
    csv = tpipe.summarize_results(results, out_csv=str(tmp_path / "t.csv"),
                                  out_tex=str(tmp_path / "t.tex"))
    assert csv == jpipe.summarize_results(ref, out_csv=str(tmp_path / "j.csv"),
                                          out_tex=str(tmp_path / "j.tex"))
    assert csv.count("\n") == 1 and csv.splitlines()[1].startswith("config_0,2,")
    for ext in ("csv", "tex"):
        assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()
    assert tpipe.collect_map_metrics(exp) == jpipe.collect_map_metrics(exp)

    record = tpipe.write_regression_file(exp, out_path=str(tmp_path / "t.yaml"))
    jpipe.write_regression_file(exp, out_path=str(tmp_path / "j.yaml"))
    with open(tmp_path / "t.yaml") as f, open(tmp_path / "j.yaml") as g:
        assert yaml.safe_load(f) == yaml.safe_load(g) == record
    trial = record["trials"]["config_0/trial_0"]
    assert trial["l1_mean"] == 0.1235 and trial["map_f_score"] == 0.95
    assert "map_f_score" not in record["trials"]["config_0/trial_1"]
    # A metrics file the JAX package wrote (YAML, not JSON) reads the same.
    with open(tmp_path / "jax_written.yaml", "w") as f:
        yaml.safe_dump(trial, f)
    assert read_json_yaml(str(tmp_path / "jax_written.yaml")) == trial


def test_metrics_pipeline_cli_files_load_with_safe_load(slam, tmp_path, monkeypatch, capsys):
    exp = _two_trial_tree(slam, str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["metrics_pipeline", exp])
    tpipe.main()
    assert "config_0,2," in capsys.readouterr().out
    results = tpipe.analyze_trajectories(exp)
    maps = tpipe.collect_map_metrics(exp)
    for name, value in (("traj_metrics", results), ("map_metrics", maps),
                        ("regression", tpipe.write_regression_file(exp, results, maps))):
        with open(os.path.join(exp, f"{name}.yaml")) as f:
            assert yaml.safe_load(f) == value, name
    assert os.path.exists(os.path.join(exp, "summary.csv"))


@pytest.mark.parametrize("entry", ["compute_l1_depth", "evaluate_lidar_map", "eval_map_quality"])
def test_eval_entry_points_run_on_the_card_unless_asked_for_the_cpu(slam, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est, gt = _icp_clouds()
    calls = {"compute_l1_depth": lambda: tl1.compute_l1_depth(slam["log_dir"]),
             "evaluate_lidar_map": lambda: teval.evaluate_lidar_map(est, gt),
             "eval_map_quality": lambda: tchain.eval_map_quality(slam["log_dir"], gt)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_gt_map_cli_writes_the_map(slam, tmp_path, monkeypatch):
    out = str(tmp_path / "gt.pcd")
    monkeypatch.setattr(sys, "argv", ["create_lidar_map", slam["dataset"], out])
    tgt.main()
    np.testing.assert_allclose(read_pcd(out), slam["gt_map"], atol=1e-5)
    masked = str(tmp_path / "masked.pcd")
    write_pcd(slam["gt_map"][::5], str(tmp_path / "rec.pcd"))
    monkeypatch.setattr(sys, "argv", ["mask", out, str(tmp_path / "rec.pcd"), masked])
    tmask.main()
    assert len(read_pcd(masked)) >= len(slam["gt_map"][::5])


def test_json_yaml_reads_back_alike_in_both_readers(tmp_path):
    """Exponents without a decimal point, non-finite floats (the mean of an empty
    cloud) and strings that look like them."""
    value = {"b": [1e-08, 2.5e+20, float("inf"), -float("inf"), 3, True, None],
             "a": {"nan": float("nan"), "text": 'x: .nan, "q" .inf'}, "n": np.float32(0.25)}
    path = str(tmp_path / "v.yaml")
    write_json_yaml(path, value)
    text = open(path).read()
    assert text.index('"a"') < text.index('"b"') < text.index('"n"')
    for loaded in (read_json_yaml(path), yaml.safe_load(text)):
        assert np.isnan(loaded["a"]["nan"])
        assert loaded["a"]["text"] == value["a"]["text"] and loaded["n"] == 0.25
        assert loaded["b"] == value["b"]

