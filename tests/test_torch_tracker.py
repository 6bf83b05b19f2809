"""The PyTorch port's Tracker against the JAX package's, on the CPU.

Both trackers take the same 10 synthetic box-room scans (a 16 x 128 virtual
LiDAR at 10 Hz along an arc, decimated to 5 Hz; motion compensation on), pipelined and not.
They decimate to the same frames, drop the same frames when ``min_fitness``
rejects one (a scan replaced by noise), and emit the same poses: translation
within 1e-4 m and rotation within 1e-4 rad, over the whole chain.
"""
import numpy as np
import pytest
import torch

from loner_tpu.common.settings import Settings as JSettings
from loner_tpu.common.signals import Signal as JSignal
from loner_tpu.datasets.synthetic import VirtualLidar, generate_sequence
from loner_tpu.tracking.tracker import Tracker as JTracker
from loner_tpu_torch.common.pose import Pose as TPose
from loner_tpu_torch.common.sensors import LidarScan as TScan
from loner_tpu_torch.common.settings import Settings as TSettings
from loner_tpu_torch.common.signals import Signal as TSignal
from loner_tpu_torch.tracking.tracker import Tracker as TTracker

torch.set_num_threads(1)

N_SCANS = 10
TRANS_TOL = 1e-4  # m
ROT_TOL = 1e-4  # rad
NOISE_STD = 0.01  # m


def _settings(pipelined: bool) -> dict:
    stage = lambda t: {"threshold": t, "max_iterations": 10}  # noqa: E731
    return {
        "system": {"lidar_only": True},
        "calibration": {"lidar_to_camera": {"xyz": [0, 0, 0], "orientation": [0, 0, 0, 1]}},
        "tracker": {
            "icp": {"schedule": [stage(1.5), stage(0.125)], "scan_duration": 0.9,
                    "pipelined": pipelined,
                    "downsample": {"type": "UNIFORM", "target_uniform_point_count": 1500}},
            "synchronization": {"enabled": False, "max_time_delta": 3.0},
            "frame_synthesis": {"frame_decimation_rate_hz": 5, "frame_match_tolerance": 0.01,
                                "frame_delta_t_sec_tolerance": 0.02, "decimate_on_load": False},
            "motion_compensation": {"enabled": True},
        },
    }


def _scans(corrupt: int = -1):
    # The first second of the JAX tests' 100-scan loop (1.5 pi over 10 s).
    # Range noise breaks the exact distance ties of the LiDAR's symmetric ray
    # pattern, where either package's k-NN may pick either neighbour.
    scans, _, _, _, _ = generate_sequence(
        num_scans=N_SCANS, lidar=VirtualLidar(num_channels=16, num_columns=128, max_range=30.0),
        angular_span=0.15 * np.pi, noise_std=NOISE_STD)
    if corrupt >= 0:  # a scan of noise: ICP cannot register it
        s = scans[corrupt]
        rng = np.random.default_rng(0)
        d = rng.normal(size=s.ray_directions.shape)
        s.ray_directions = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
        s.distances = rng.uniform(20.0, 28.0, s.distances.shape).astype(np.float32)
    return scans


def _track(tracker_cls, settings_cls, signal_cls, scans, pipelined, **kw):
    lidar, frames = signal_cls(), signal_cls()
    out = frames.register()
    tracker = tracker_cls(settings_cls(_settings(pipelined)), None, lidar, frames, **kw)
    for scan in scans:
        lidar.emit((scan, None))
        tracker.update()
    tracker.flush()
    emitted = []
    while out.has_value():
        f = out.get_value()
        emitted.append((f.get_time(), f.get_lidar_pose().matrix.copy()))
    return emitted


def _port_scans(scans):
    return [TScan(s.ray_directions.copy(), s.distances.copy(), s.timestamps.copy()) for s in scans]


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("corrupt", [-1, 6])
def test_tracker_matches_jax(pipelined, corrupt):
    scans = _scans(corrupt)
    got_j = _track(JTracker, JSettings, JSignal, scans, pipelined)
    got_t = _track(TTracker, TSettings, TSignal, _port_scans(scans), pipelined,
                   device=torch.device("cpu"))
    times_j = [t for t, _ in got_j]
    assert [t for t, _ in got_t] == times_j
    # 5 Hz from a 10 Hz stream: every other scan; the noise scan is dropped.
    expected = [scans[i].get_start_time() for i in range(0, N_SCANS, 2) if i != corrupt]
    assert times_j == expected
    for (_, m_t), (_, m_j) in zip(got_t, got_j):
        d_t, d_r = TPose(m_j).distance_to(TPose(m_t))
        assert d_t <= TRANS_TOL and np.deg2rad(d_r) <= ROT_TOL, (d_t, d_r)
    # The poses follow the motion: the last frame is far from the first.
    assert np.linalg.norm(got_t[-1][1][:3, 3]) > 0.3


def test_tracker_rejects_what_is_not_ported():
    # tracker.icp.device is ported (tests/test_torch_multidevice.py): on the CPU
    # only 0 is a device, and an index the machine does not have raises.
    s = _settings(True)
    s["tracker"]["icp"]["device"] = 1
    with pytest.raises(ValueError, match="tracker.icp.device"):
        TTracker(TSettings(s), None, TSignal(), TSignal(), torch.device("cpu"))
    # The camera branch is ported: an rgb signal is taken.
    TTracker(TSettings(_settings(True)), TSignal(), TSignal(), TSignal(), torch.device("cpu"))
