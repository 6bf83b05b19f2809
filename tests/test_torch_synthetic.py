"""The port's synthetic scenes against the JAX package's, bit for bit.

Both generators are numpy: the courtyard scene (with and without its moving
actors), the waypoint trajectory, and scans with actors (each ray against every
actor at its own fire time), range noise and dropout, on a reduced 8 x 64
sensor, must give the same bits in both packages.
"""
import numpy as np
import pytest

from loner_tpu.common.pose import Pose as JPose
from loner_tpu.datasets import synthetic as jsyn
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.datasets import synthetic as tsyn

SENSOR = dict(num_channels=8, num_columns=64, max_range=60.0)


def _scene_arrays(scene):
    out = [scene.room_min, scene.room_max, np.asarray(scene.open_top)]
    for lo, hi in scene.obstacles:
        out += [lo, hi]
    for actor in scene.actors:
        out += [actor.size, actor.waypoints, np.asarray([actor.speed, actor.t_start])]
    return out


@pytest.mark.parametrize("with_actors", [False, True])
def test_make_courtyard_matches_jax(with_actors):
    scene_t, wp_t, speed_t = tsyn.make_courtyard(with_actors=with_actors)
    scene_j, wp_j, speed_j = jsyn.make_courtyard(with_actors=with_actors)
    assert speed_t == speed_j and len(scene_t.actors) == (3 if with_actors else 0)
    np.testing.assert_array_equal(wp_t, wp_j)
    got, want = _scene_arrays(scene_t), _scene_arrays(scene_j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    t = np.linspace(95.0, 200.0, 50)
    for a_t, a_j in zip(scene_t.actors, scene_j.actors):
        np.testing.assert_array_equal(a_t.center_at(t), a_j.center_at(t))


def test_make_waypoint_trajectory_matches_jax():
    _, wp, speed = tsyn.make_courtyard()
    poses_t, ts_t = tsyn.make_waypoint_trajectory(wp, speed=speed)
    poses_j, ts_j = jsyn.make_waypoint_trajectory(wp, speed=speed)
    assert poses_t.shape == (1513, 4, 4)  # the drive's 1513 scans at 10 Hz
    np.testing.assert_array_equal(poses_t, poses_j)
    np.testing.assert_array_equal(ts_t, ts_j)
    sharp_t = tsyn.make_waypoint_trajectory(wp[:4], speed=2.0, rate_hz=5.0, z=0.7, smooth_s=1.0)
    sharp_j = jsyn.make_waypoint_trajectory(wp[:4], speed=2.0, rate_hz=5.0, z=0.7, smooth_s=1.0)
    for a, b in zip(sharp_t, sharp_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noise_std,dropout", [(0.0, 0.0), (0.03, 0.1)])
def test_courtyard_scans_with_actors_match_jax(noise_std, dropout):
    scene_t, wp, speed = tsyn.make_courtyard(with_actors=True)
    scene_j, _, _ = jsyn.make_courtyard(with_actors=True)
    poses, ts = tsyn.make_waypoint_trajectory(wp, speed=speed)
    lidar_t, lidar_j = tsyn.VirtualLidar(**SENSOR), jsyn.VirtualLidar(**SENSOR)
    hit_actor = False
    for i in (0, 40, 200):  # the loiterer is in view from the start
        a = tsyn.make_scan(scene_t, lidar_t, Pose(poses[i]), ts[i], noise_std, dropout, seed=i)
        b = jsyn.make_scan(scene_j, lidar_j, JPose(poses[i]), ts[i], noise_std, dropout, seed=i)
        for name in ("ray_directions", "distances", "timestamps"):
            np.testing.assert_array_equal(getattr(a, name), np.asarray(getattr(b, name)), name)
        static = tsyn.make_scan(tsyn.make_courtyard()[0], lidar_t, Pose(poses[i]), ts[i],
                                noise_std, dropout, seed=i)
        hit_actor |= a.distances.shape != static.distances.shape or not np.array_equal(
            a.distances, static.distances)
    assert hit_actor  # the actors changed some returns


def test_generate_courtyard_sequence_matches_jax_on_its_first_scans():
    scans_t, poses_t, ts_t, _, lidar_t = tsyn.generate_courtyard_sequence(
        lidar=tsyn.VirtualLidar(**SENSOR), num_scans=3, with_actors=True, noise_std=0.02)
    scans_j, poses_j, ts_j, _, _ = jsyn.generate_courtyard_sequence(
        lidar=jsyn.VirtualLidar(**SENSOR), with_actors=True, noise_std=0.02)
    assert len(scans_t) == len(poses_t) == len(ts_t) == 3 and len(scans_j) == 1513
    np.testing.assert_array_equal(poses_t, poses_j[:3])
    np.testing.assert_array_equal(ts_t, ts_j[:3])
    for a, b in zip(scans_t, scans_j):
        for name in ("ray_directions", "distances", "timestamps"):
            np.testing.assert_array_equal(getattr(a, name), np.asarray(getattr(b, name)), name)
    default = tsyn.generate_courtyard_sequence(num_scans=0)[4]
    assert (default.num_channels, default.num_columns, default.max_range) == (64, 1024, 60.0)
    assert lidar_t.num_channels == 8
