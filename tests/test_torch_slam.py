"""The PyTorch port's SLAM run end to end, on the CPU.

``loner_tpu_torch.run_loner.run_trial`` on a 24-scan tiny box room (a 16 x 128
virtual LiDAR at 5 Hz), single-threaded and threaded, at
cfg/synthetic/box_room_tiny_tpu.yaml's settings cut further for one CPU core
(fewer rays, samples and iterations; a narrower field):

- the artifact list of tests/test_e2e_slam.py;
- ATE RMSE below 0.15 m for the estimated and the tracking-only trajectory
  (the JAX package's bar);
- ``final.tar`` loads in the JAX package's ``load_experiment`` and renders
  finite depth there, and a fresh ``Mapper`` restored from it writes the same
  state back;
- ``world_cube.yaml`` and ``full_config.yaml`` load with ``yaml.safe_load``
  to the values of ``full_config.pkl``;
- the settings dict of chip_smoke.py's SLAM phase equals the port's load of
  cfg/synthetic/box_room_tpu_rt_r4.yaml, and that of its reference-configuration
  phase the load of cfg/synthetic/box_room.yaml, but for the keys they override
  on purpose; ``run_trial`` never falls back to the CPU by itself; and the
  synchronous signal's rendezvous waits for its consumer and aborts.

The reference's own model runs too: cfg/synthetic/box_room_tiny.yaml (hash
sigma field, OGM sampler), single-threaded and cut the same way, under the same
ATE bar, and its final checkpoint renders in the JAX package.
"""
import os
import pickle
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from loner_tpu.analysis.render_utils import load_experiment, render_depth_chunked
from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.settings import Settings, load_config
from loner_tpu_torch.common.signals import Signal
from loner_tpu_torch.common.world_cube import WorldCube
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, ScanStreamWriter
from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence
from loner_tpu_torch.mapping.mapper import Mapper, load_checkpoint
from loner_tpu_torch.run_loner import run_trial

REPO = Path(__file__).resolve().parents[1]
NUM_SCANS = 24
ATE_MAX = 0.15
ARTIFACTS = [
    "world_cube.yaml", "full_config.yaml", "full_config.pkl", "runtime.txt",
    "trajectory/tracking_only.txt", "trajectory/online_estimates.txt",
    "trajectory/keyframe_trajectory.txt", "trajectory/estimated_trajectory.txt",
    "trajectory/groundtruth.txt", "checkpoints/final.tar",
]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    scans, poses, ts, _, _ = generate_sequence(
        num_scans=NUM_SCANS, lidar=VirtualLidar(num_channels=16, num_columns=128, max_range=30.0),
        rate_hz=5.0)
    writer = ScanStreamWriter(root)
    for s in scans:
        writer.add_scan(s)
    writer.write_gt(poses, ts)
    return root


def tiny_settings(log_prefix: str, single_threaded: bool):
    settings, _ = load_config(str(REPO / "cfg/synthetic/box_room_tiny_tpu.yaml"))
    return settings.augment({
        "system": {"single_threaded": single_threaded, "log_dir_prefix": log_prefix},
        "mapper": {"optimizer": {
            "num_samples": {"lidar": 64},
            "keyframe_schedule": [
                {"num_keyframes": 1, "iteration_schedule": [
                    {"num_iterations": 60, "freeze_poses": True, "freeze_sigma_mlp": False,
                     "freeze_rgb_mlp": True}]},
                {"num_keyframes": -1, "iteration_schedule": [
                    {"num_iterations": 10, "freeze_poses": False, "freeze_sigma_mlp": False,
                     "freeze_rgb_mlp": True}]},
            ],
            "model_config": {"model": {
                "render": {"N_samples_train": 32},
                "nerf_config": {"fourier_sigma": {"n_freqs": 16},
                                "sigma_network": {"n_neurons": 64, "n_hidden_layers": 2}},
                "occ_model": {"proposal": {"n_freqs": 8, "n_neurons": 16}},
            }},
        }},
    })


def tiny_hash_settings(log_prefix: str):
    """cfg/synthetic/box_room_tiny.yaml (the reference's model: hash sigma field at
    6 levels x 2^14, OGM sampler), cut for one CPU core like ``tiny_settings``."""
    settings, _ = load_config(str(REPO / "cfg/synthetic/box_room_tiny.yaml"))
    return settings.augment({
        "system": {"log_dir_prefix": log_prefix},
        "mapper": {"optimizer": {
            "num_samples": {"lidar": 64},
            "keyframe_schedule": [
                {"num_keyframes": 1, "iteration_schedule": [
                    {"num_iterations": 60, "freeze_poses": True, "freeze_sigma_mlp": False,
                     "freeze_rgb_mlp": True}]},
                {"num_keyframes": -1, "iteration_schedule": [
                    {"num_iterations": 10, "freeze_poses": False, "freeze_sigma_mlp": False,
                     "freeze_rgb_mlp": True}]},
            ],
            "model_config": {"model": {"render": {"N_samples_train": 32}}},
        }},
    })


@pytest.fixture(scope="module")
def hash_slam_run(dataset, tmp_path_factory):
    torch.set_num_threads(1)
    settings = tiny_hash_settings(str(tmp_path_factory.mktemp("hash_outputs")))
    assert settings.mapper.optimizer.samples_selection.strategy == "OGM"
    assert "encoding_sigma" not in settings.mapper.optimizer.model_config.model.nerf_config
    return run_trial(settings, dataset, experiment_name="port_hash_ogm", device="cpu")


@pytest.mark.parametrize("trajectory", ["estimated_trajectory", "tracking_only"])
def test_hash_ogm_ate(hash_slam_run, trajectory):
    res = evaluate_trajectory_files(
        os.path.join(hash_slam_run, "trajectory", f"{trajectory}.txt"),
        os.path.join(hash_slam_run, "trajectory", "groundtruth.txt"), delta_m=1.0)
    assert res["ate"]["rmse"] < ATE_MAX, res["ate"]


def test_hash_ogm_final_checkpoint_renders_in_the_jax_package(hash_slam_run):
    ckpt = load_checkpoint(os.path.join(hash_slam_run, "checkpoints", "final.tar"))
    assert ckpt["occ_model_state_dict"].shape == (32, 32, 32)
    assert np.abs(ckpt["occ_model_state_dict"]).max() > 0  # the grid was updated
    assert ckpt["network_state_dict"]["sigma"]["table"].shape[1] == 2
    model = load_experiment(hash_slam_run)
    assert model.occ_grid.shape == (32, 32, 32)
    origin = np.asarray(model.poses[0]["lidar_pose"][:3])
    dirs = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], np.float32)
    out = render_depth_chunked(model, np.broadcast_to(origin, dirs.shape), dirs, (0.5, 14.0),
                               n_samples=64, ret_var=True)
    assert np.isfinite(out["depth"]).all() and np.isfinite(out["variance"]).all()


@pytest.fixture(scope="module", params=["single_threaded", "threaded"])
def slam_run(request, dataset, tmp_path_factory):
    torch.set_num_threads(1)
    prefix = str(tmp_path_factory.mktemp("outputs"))
    settings = tiny_settings(prefix, request.param == "single_threaded")
    return run_trial(settings, dataset, experiment_name=f"port_{request.param}", device="cpu")


def test_artifacts_exist(slam_run):
    for f in ARTIFACTS:
        assert os.path.exists(os.path.join(slam_run, f)), f
    timing = np.loadtxt(os.path.join(slam_run, "timing.csv"), delimiter=",", ndmin=2)
    assert timing[0, 0] == 60 and (timing[1:, 0] == 10).all() and len(timing) >= 3


@pytest.mark.parametrize("trajectory", ["estimated_trajectory", "tracking_only"])
def test_ate(slam_run, trajectory):
    res = evaluate_trajectory_files(
        os.path.join(slam_run, "trajectory", f"{trajectory}.txt"),
        os.path.join(slam_run, "trajectory", "groundtruth.txt"), delta_m=1.0)
    assert res["ate"]["rmse"] < ATE_MAX, res["ate"]


def test_final_checkpoint_renders_in_the_jax_package(slam_run):
    model = load_experiment(slam_run)
    assert len(model.poses) >= 3
    origin = np.asarray(model.poses[0]["lidar_pose"][:3])
    dirs = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], np.float32)
    out = render_depth_chunked(model, np.broadcast_to(origin, dirs.shape), dirs, (0.5, 14.0),
                               n_samples=64, ret_var=True)
    assert np.isfinite(out["depth"]).all() and np.isfinite(out["variance"]).all()


def test_yaml_dumps_load_with_safe_load(slam_run):
    with open(os.path.join(slam_run, "full_config.pkl"), "rb") as f:
        full = pickle.load(f)
    with open(os.path.join(slam_run, "full_config.yaml")) as f:
        assert yaml.safe_load(f) == full
    with open(os.path.join(slam_run, "world_cube.yaml")) as f:
        cube = yaml.safe_load(f)
    assert cube == full["world_cube"] and isinstance(cube["scale_factor"], float)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_mapper_restores_from_final_checkpoint(slam_run, dataset, tmp_path):
    """A fresh Mapper seated from final.tar and re-read scans writes the same
    map state, global step and keyframe poses back out."""
    with open(os.path.join(slam_run, "full_config.pkl"), "rb") as f:
        full = Settings(pickle.load(f))
    full.mapper["log_directory"] = str(tmp_path)
    ckpt = load_checkpoint(os.path.join(slam_run, "checkpoints", "final.tar"))
    mapper = Mapper(full.mapper, Signal(), Signal(), WorldCube.from_dict(full.world_cube),
                    torch.device("cpu"))
    reader = ScanStreamReader(dataset)
    starts = np.array([reader.read_scan(i).get_start_time() for i in range(len(reader))])
    frames = [Frame(reader.read_scan(int(np.argmin(np.abs(starts - s["timestamp"])))))
              for s in ckpt["poses"]]
    mapper.restore_from_checkpoint(ckpt, frames)

    again = mapper.build_ckpt()
    assert len(mapper.keyframe_manager) == len(ckpt["poses"]) >= 3
    assert again["global_step"] == ckpt["global_step"] > 0
    for got, want in zip(again["poses"], ckpt["poses"]):
        for key in ("lidar_pose", "tracked_pose"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-9)
    for tree in ("network_state_dict", "occ_model_state_dict"):
        got, want = dict(_leaves(again[tree])), dict(_leaves(ckpt[tree]))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    with pytest.raises(ValueError, match="keyframes"):
        mapper.restore_from_checkpoint(ckpt, frames[:-1])


def test_synchronous_emit_waits_for_the_consumer_and_aborts():
    """The LiDAR signal's rendezvous returns once the consumer has taken the
    item, and raises instead of waiting forever once ``abort()`` is true."""
    stop = threading.Event()
    sig = Signal(synchronous=True, abort=stop.is_set)
    slot = sig.register()
    got = []
    consumer = threading.Thread(target=lambda: (time.sleep(0.3), got.append(slot.get_value())))
    # The clock starts before the consumer's sleep does, so the wait it reads
    # is at least the sleep, however the threads are scheduled.
    t0 = time.perf_counter()
    consumer.start()
    sig.emit(1)
    assert time.perf_counter() - t0 >= 0.3 and not slot.has_value()
    consumer.join()
    assert got == [1]

    timer = threading.Timer(0.3, stop.set)
    timer.start()
    with pytest.raises(RuntimeError, match="consumer of this signal stopped"):
        sig.emit(2)  # nobody drains it
    timer.join()
    assert slot.get_value() == 2 and not slot.has_value()


def test_smoke_settings_are_the_flagship_yaml():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    smoke = chip_smoke.flagship_slam_settings("/tmp/prefix")
    want, dataset = load_config(str(REPO / "cfg/synthetic/box_room_tpu_rt_r4.yaml"))
    assert dataset is not None
    want.augment({"system": {"log_dir_prefix": "/tmp/prefix", "precompile": True},
                  "mapper": {"optimizer": {"model_config": {"model": {"render": {
                      "compositor": "pallas"}}}}}})
    assert smoke == want.as_plain_dict()


def test_smoke_reference_settings_are_the_box_room_yaml():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    smoke = chip_smoke.box_room_settings("/tmp/prefix")
    want, dataset = load_config(str(REPO / "cfg/synthetic/box_room.yaml"))
    assert dataset is None  # a bare !include of defaults.yaml
    assert want.mapper.optimizer.samples_selection.strategy == "OGM"
    want.augment({"system": {"log_dir_prefix": "/tmp/prefix", "precompile": True}})
    assert smoke == want.as_plain_dict()


def test_run_trial_has_no_silent_cpu_fallback(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = tiny_settings(str(tmp_path), True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_trial(settings, dataset, device="cuda")


@pytest.mark.parametrize("name,build", [
    ("box_room_sky", lambda cs, p: cs.sky_slam_settings(p, True)),
    ("box_room_sky_off", lambda cs, p: cs.sky_slam_settings(p, False)),
    ("courtyard_tpu_r5f", lambda cs, p: cs.courtyard_slam_settings(p)),
])
def test_smoke_sky_and_courtyard_settings_are_their_yaml(name, build):
    """chip_smoke.py's phases 15 and 17 run these configurations as plain dicts:
    equal to the port's load of the YAML but for the keys flagship_slam_settings
    overrides on purpose (log prefix, precompile, the fused test compositor)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    smoke = build(chip_smoke, "/tmp/prefix")
    want, dataset = load_config(str(REPO / f"cfg/synthetic/{name}.yaml"))
    assert dataset is not None
    want.augment({"system": {"log_dir_prefix": "/tmp/prefix", "precompile": True},
                  "mapper": {"optimizer": {"model_config": {"model": {"render": {
                      "compositor": "pallas"}}}}}})
    assert smoke == want.as_plain_dict()


def test_spans_json_replaces_the_timing_csvs(slam_run):
    """Under ``debug.log_times`` the run writes its spans and counters
    (``runtime/profiling.py``) to ``spans.json``, and no ``track_times.csv`` or
    ``map_times.csv``."""
    from loner_tpu_torch.runtime.profiling import read_spans

    path = os.path.join(slam_run, "spans.json")
    names = {e["name"] for e in read_spans(path)}
    assert {"tracker.frame", "tracker.icp", "mapper.queue_wait", "mapper.keyframe",
            "optimizer.copy_out"} <= names, names
    for name in ("track_times.csv", "map_times.csv"):
        assert not os.path.exists(os.path.join(slam_run, name))
    timing = np.loadtxt(os.path.join(slam_run, "timing.csv"), delimiter=",", ndmin=2)
    assert len(read_spans(path, "mapper.keyframe")) == len(timing)
    frames = read_spans(path, "tracker.frame")
    assert frames and all(e["dur"] >= 0 and e["args"]["frames"] >= 1 for e in frames)
