"""Mid-run resume in the PyTorch port against the JAX package, on the CPU.

- ``find_resume_checkpoint`` skips poses-only checkpoints and prefers the
  latest full one, as the JAX package's does.
- ``_match_scan_index``: interval containment, raw and FOV-masked start times.
- On the directory of a tiny port SLAM run interrupted at 2.1 s (the 24-scan
  box room of ``tests/test_torch_slam.py``, single-threaded), and on a copy
  whose checkpoint the JAX package's ``save_checkpoint`` wrote:
  ``rebuild_keyframe_frames``, ``build_seed_frame`` and ``DefaultLogger.preload``
  give the JAX package's arrays (scans to 1e-6: both replay the motion
  compensation in float64 numpy and round to float32; trajectories exactly).
- The interrupted run resumed in place through ``run_trial(resume_from=...)``,
  and the copy through ``python -m loner_tpu_torch.run_loner --resume``:
  keyframes and ``ckpt_<k>`` numbering continue, timestamps strictly
  increase, the tracking seam stays within 25% of the median step
  (``tests/test_resume.py``'s bar), ATE below 0.15 m.
"""
import copy
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from loner_tpu.common.pose import Pose as JPose
from loner_tpu.common.settings import Settings as JSettings
from loner_tpu.common.trajectory import load_tum_trajectory as j_load_tum
from loner_tpu.datasets.scan_stream import ScanStreamReader as JReader
from loner_tpu.mapping.mapper import save_checkpoint as j_save_checkpoint
from loner_tpu.runtime import resume as jresume
from loner_tpu.runtime.logger import DefaultLogger as JLogger
from loner_tpu_torch import run_loner
from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.settings import Settings
from loner_tpu_torch.common.signals import Signal
from loner_tpu_torch.common.trajectory import load_tum_trajectory
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, apply_fov_mask
from loner_tpu_torch.mapping.mapper import load_checkpoint
from loner_tpu_torch.runtime import resume as tresume
from loner_tpu_torch.runtime.logger import DefaultLogger

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_slam import ATE_MAX, dataset, tiny_settings  # noqa: E402,F401

CPU = torch.device("cpu")
HALF_S = 2.1  # seconds of the 4.8 s sequence streamed before the interruption


def _write(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def test_find_resume_checkpoint_skips_poses_only_and_prefers_latest(tmp_path):
    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    full = {"global_step": 10, "network_state_dict": {"w": np.zeros(2)},
            "poses": [{"timestamp": 0.0}]}
    _write(ckpt_dir / "ckpt_0.tar", full)
    _write(ckpt_dir / "ckpt_1.tar", {"global_step": 12, "poses": [{"timestamp": 0.0}]})
    _write(ckpt_dir / "ckpt_10.tar", {"global_step": 14, "poses": [{"timestamp": 0.0}]})
    for find in (tresume.find_resume_checkpoint, jresume.find_resume_checkpoint):
        ckpt, path = find(str(tmp_path))
        assert path.endswith("ckpt_0.tar") and ckpt["global_step"] == 10
    _write(ckpt_dir / "ckpt_2.tar", {**full, "global_step": 13})
    assert tresume.find_resume_checkpoint(str(tmp_path))[1].endswith("ckpt_2.tar")
    _write(ckpt_dir / "final.tar", {**full, "global_step": 20})
    for find in (tresume.find_resume_checkpoint, jresume.find_resume_checkpoint):
        ckpt, path = find(str(tmp_path))
        assert path.endswith("final.tar") and ckpt["global_step"] == 20
    _write(ckpt_dir / "final.tar", {"global_step": 21, "poses": []})  # poses only
    assert tresume.find_resume_checkpoint(str(tmp_path))[1].endswith("ckpt_2.tar")
    shutil.rmtree(ckpt_dir)
    ckpt_dir.mkdir()
    with pytest.raises(FileNotFoundError):
        tresume.find_resume_checkpoint(str(tmp_path))


def test_match_scan_index_interval_containment():
    spans = np.array([[0.0, 0.09], [0.1, 0.19], [0.2, 0.29]])
    for t, want in ((0.1, 1), (0.145, 1), (0.29, 2), (0.0, 0)):
        assert tresume._match_scan_index(spans, t) == want == jresume._match_scan_index(spans, t)
    for t in (0.5, -0.1):
        with pytest.raises(ValueError, match="wrong dataset"):
            tresume._match_scan_index(spans, t)


def test_match_scan_index_finds_fov_masked_scans(dataset):  # noqa: F811
    reader = ScanStreamReader(dataset)
    spans = reader.time_spans()
    for i in (0, 7, len(reader) - 1):
        masked = apply_fov_mask(reader.read_scan(i), [[30, 330]])
        t = masked.get_start_time()
        assert t > spans[i, 0] + 1e-3  # the mask trims the sweep's start
        assert tresume._match_scan_index(spans, t) == i


@pytest.fixture(scope="module")
def interrupted(dataset, tmp_path_factory):  # noqa: F811
    """A port run stopped after HALF_S seconds of data, and a copy of it whose
    final checkpoint the JAX package's save_checkpoint wrote."""
    torch.set_num_threads(1)
    settings = tiny_settings(str(tmp_path_factory.mktemp("resume_out")), True)
    half = run_loner.run_trial(copy.deepcopy(settings), dataset, experiment_name="resume_half",
                               duration=HALF_S, device="cpu")
    copied = str(tmp_path_factory.mktemp("resume_jax_ckpt") / "run")
    shutil.copytree(half, copied)
    ckpt_path = os.path.join(copied, "checkpoints", "final.tar")
    j_save_checkpoint(ckpt_path, load_checkpoint(ckpt_path))
    ckpt = load_checkpoint(os.path.join(half, "checkpoints", "final.tar"))
    track = load_tum_trajectory(os.path.join(half, "trajectory", "tracking_only.txt"))
    return {"settings": settings, "port": half, "jax": copied, "kfs": len(ckpt["poses"]),
            "frames": len(track[1])}


def _settings(log_dir: str):
    with open(os.path.join(log_dir, "full_config.pkl"), "rb") as f:
        plain = pickle.load(f)
    return Settings(copy.deepcopy(plain)), JSettings(copy.deepcopy(plain))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rebuild_seed_and_preload_match_jax(interrupted, dataset, writer):  # noqa: F811
    log_dir = interrupted[writer]
    settings_t, settings_j = _settings(log_dir)
    states = tresume.find_resume_checkpoint(log_dir)[0]["poses"]
    assert len(states) == interrupted["kfs"] >= 2
    track_file = os.path.join(log_dir, "trajectory", "tracking_only.txt")
    reader_t, reader_j = ScanStreamReader(dataset), JReader(dataset)
    l2c = np.eye(4)
    frames_t = tresume.rebuild_keyframe_frames(reader_t, settings_t, states, Pose(l2c),
                                               *load_tum_trajectory(track_file))
    frames_j = jresume.rebuild_keyframe_frames(reader_j, settings_j, states, JPose(l2c),
                                               *j_load_tum(track_file))
    seed_t = tresume.build_seed_frame(reader_t, settings_t, states, frames_t)
    seed_j = jresume.build_seed_frame(reader_j, settings_j, states, frames_j)
    assert len(frames_t) == len(frames_j) == len(states)
    for ft, fj in zip(frames_t + [seed_t], frames_j + [seed_j]):
        for name in ("ray_directions", "distances"):
            a, b = getattr(ft.lidar_points, name), np.asarray(getattr(fj.lidar_points, name))
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(ft.lidar_points.timestamps, fj.lidar_points.timestamps)
        np.testing.assert_allclose(ft._gt_lidar_pose.matrix, fj._gt_lidar_pose.matrix, atol=1e-12)
    # The seed is the uncompensated scan, the last keyframe's the compensated one.
    assert np.abs(frames_t[-1].lidar_points.ray_directions
                  - seed_t.lidar_points.ray_directions).max() > 1e-6
    np.testing.assert_array_equal(seed_t.lidar_points.ray_directions,
                                  reader_t.read_scan(tresume._match_scan_index(
                                      reader_t.time_spans(), states[-1]["timestamp"]))
                                  .ray_directions)

    logger_t = DefaultLogger(Signal(), Signal(), log_dir)
    logger_j = JLogger(Signal(), Signal(), log_dir)
    traj = os.path.join(log_dir, "trajectory")
    logger_t.preload(traj, states)
    logger_j.preload(traj, states)
    assert logger_t._timestamps == logger_j._timestamps
    assert len(logger_t._timestamps) < interrupted["frames"]
    for name in ("_icp_only", "_frame_log", "_gt_path"):
        np.testing.assert_array_equal(np.stack(getattr(logger_t, name)),
                                      np.stack(getattr(logger_j, name)), err_msg=name)
    np.testing.assert_array_equal(logger_t._t_world_to_kf, logger_j._t_world_to_kf)
    np.testing.assert_array_equal(logger_t._gt_pose_offset.matrix, np.eye(4))


@pytest.fixture(scope="module", params=["run_trial", "cli"])
def resumed(request, interrupted, dataset):  # noqa: F811
    """The port-written run resumed through run_trial; the JAX-checkpointed copy
    through the CLI."""
    torch.set_num_threads(1)
    if request.param == "run_trial":
        log_dir = interrupted["port"]
        out = run_loner.run_trial(copy.deepcopy(interrupted["settings"]), dataset,
                                  resume_from=log_dir, device="cpu")
        assert out == log_dir  # continues in place
    else:
        log_dir = interrupted["jax"]
        argv = sys.argv
        sys.argv = ["run_loner", "--resume", log_dir, "--device", "cpu"]
        try:
            run_loner.main()
        finally:
            sys.argv = argv
    reader = ScanStreamReader(dataset)
    return {"log_dir": log_dir, "span": (reader.start_times()[0], reader.start_times()[-1])}


def test_resumed_keyframes_and_checkpoints_continue(resumed, interrupted):
    final = load_checkpoint(os.path.join(resumed["log_dir"], "checkpoints", "final.tar"))
    n = len(final["poses"])
    assert n > interrupted["kfs"]
    for k in range(n):
        assert os.path.exists(os.path.join(resumed["log_dir"], "checkpoints", f"ckpt_{k}.tar")), k
    ts = [p["timestamp"] for p in final["poses"]]
    assert len(set(np.round(ts, 6))) == n and np.all(np.diff(ts) > 0)
    timing = np.loadtxt(os.path.join(resumed["log_dir"], "timing.csv"), delimiter=",", ndmin=2)
    assert len(timing) == n  # the resumed run appends to the interrupted run's log


def test_resumed_trajectory_covers_the_sequence(resumed, interrupted):
    _, ts = load_tum_trajectory(
        os.path.join(resumed["log_dir"], "trajectory", "estimated_trajectory.txt"))
    assert len(ts) > interrupted["frames"] - 2 and np.all(np.diff(ts) > 0)
    t0, t1 = resumed["span"]
    assert abs(ts[0] - t0) < 0.3 and ts[-1] > t1 - 0.5


def test_resumed_tracking_is_continuous(resumed):
    poses, ts = load_tum_trajectory(
        os.path.join(resumed["log_dir"], "trajectory", "tracking_only.txt"))
    assert np.all(np.diff(ts) > 0)
    # The sequence moves at constant speed: every step, the seam's too, stays
    # near the median step.
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    med = np.median(steps)
    assert np.all(np.abs(steps - med) < 0.25 * med), steps


@pytest.mark.parametrize("trajectory", ["estimated_trajectory", "tracking_only"])
def test_resumed_ate(resumed, trajectory):
    res = evaluate_trajectory_files(
        os.path.join(resumed["log_dir"], "trajectory", f"{trajectory}.txt"),
        os.path.join(resumed["log_dir"], "trajectory", "groundtruth.txt"), delta_m=1.0)
    assert res["ate"]["rmse"] < ATE_MAX, res["ate"]


def test_rebuild_with_sky_rays_gives_the_live_keyframes(tmp_path):
    """With ``tracker.compute_sky_rays``, the rebuilt keyframes carry the sky
    rays the live run found (found again at the tracked pose, after the motion
    compensation, as the live tracker does), and the scans the live keyframes
    held. The JAX package's rebuild raises here: it computes sky rays on a frame
    that has no pose yet."""
    from loner_tpu.tracking.tracker import Tracker as JTracker
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
    from loner_tpu_torch.datasets.synthetic import BoxRoomScene, VirtualLidar, generate_sequence
    from loner_tpu_torch.mapping import mapper as tmapper
    from loner_tpu_torch.tracking.tracker import Tracker

    torch.set_num_threads(1)
    root = str(tmp_path / "ds")
    scans, poses, ts, _, _ = generate_sequence(
        num_scans=24, scene=BoxRoomScene(open_top=True),
        lidar=VirtualLidar(num_channels=16, num_columns=128, max_range=30.0), rate_hz=5.0)
    writer = ScanStreamWriter(root)
    for s in scans:
        writer.add_scan(s)
    writer.write_gt(poses, ts)
    settings = tiny_settings(str(tmp_path / "out"), True).augment({
        "system": {"sky_segmentation": True}, "tracker": {"compute_sky_rays": True},
        "mapper": {"optimizer": {"num_samples": {"sky": 8}}}})
    live = {}
    finish = tmapper.Mapper.finish

    def spy(self):
        live["kfs"] = self.keyframe_manager.get_keyframes()
        live["sky"] = self.optimizer.config.enable_sky
        return finish(self)

    tmapper.Mapper.finish = spy
    try:
        log_dir = run_loner.run_trial(settings, root, experiment_name="sky", device="cpu")
    finally:
        tmapper.Mapper.finish = finish
    assert live["sky"]

    settings_t, settings_j = _settings(log_dir)
    states = tresume.find_resume_checkpoint(log_dir)[0]["poses"]
    track = load_tum_trajectory(os.path.join(log_dir, "trajectory", "tracking_only.txt"))
    reader = ScanStreamReader(root)
    frames = tresume.rebuild_keyframe_frames(
        reader, settings_t, states, Pose(np.eye(4)), *track,
        compute_sky_rays=lambda f: Tracker.compute_sky_rays(object.__new__(Tracker), f))
    assert len(frames) == len(live["kfs"]) >= 2
    for kf, frame in zip(live["kfs"], frames):
        a, b = kf._frame.lidar_points, frame.lidar_points
        np.testing.assert_allclose(b.distances, a.distances, atol=1e-3)
        assert a.sky_rays.shape[1] > 0
        np.testing.assert_array_equal(b.sky_rays, a.sky_rays)
    with pytest.raises(AttributeError):
        jresume.rebuild_keyframe_frames(
            JReader(root), settings_j, states, JPose(np.eye(4)), *j_load_tum(
                os.path.join(log_dir, "trajectory", "tracking_only.txt")),
            compute_sky_rays=lambda f: JTracker.compute_sky_rays(object.__new__(JTracker), f))
