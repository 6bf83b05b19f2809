"""Synthetic LiDAR scene: a box room with box obstacles, analytic raycast.

Counterpart of the box-room part of ``loner_tpu/datasets/synthetic.py``
(numpy and scipy only; the moving actors, the courtyard and the virtual camera
are not ported). Depths are closed-form ray/AABB intersections, so the same
seed gives scans bit-equal to the JAX package's, and ICP, mapping and SLAM can
be checked against exact ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as _R

from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import LidarScan


@dataclass
class BoxRoomScene:
    """Axis-aligned room (viewed from inside) + solid box obstacles."""

    room_min: np.ndarray = field(default_factory=lambda: np.array([-8.0, -6.0, -2.0]))
    room_max: np.ndarray = field(default_factory=lambda: np.array([8.0, 6.0, 3.0]))
    # Each obstacle: (min_corner (3,), max_corner (3,))
    obstacles: List[Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=lambda: [
            (np.array([2.0, -2.0, -2.0]), np.array([4.0, 0.0, 1.0])),
            (np.array([-5.0, 2.0, -2.0]), np.array([-3.0, 4.0, 0.5])),
        ]
    )
    # Open-sky variant: the ceiling (z = room_max[2]) is removed — rays
    # exiting through it return no hit (inf depth -> dropped by
    # make_scan), which is what real outdoor lidar sees above the
    # horizon. Drives the sky-ray supervision path (reference
    # tracker.py:257-296, keyframe.py:87-101).
    open_top: bool = False
    # Skylight variant: only the axis-aligned xy rectangle
    # (xy_min, xy_max) of the ceiling is open. Unlike open_top, the
    # remaining ceiling ring still returns hits at high elevations, so
    # the spherical sky image has INTERIOR empty cells (surrounded by
    # returns on all sides) — the geometry where sky supervision is
    # cleanly separable from wall returns.
    top_opening: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def raycast(self, origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
        """Exact first-hit distance for rays (N, 3), (N, 3) -> (N,)."""
        o, d = np.asarray(origins, np.float64), np.asarray(directions, np.float64)
        d = np.where(np.abs(d) < 1e-12, 1e-12, d)

        # Exit distance of the room (origin inside): for each axis take the
        # positive slab crossing, then the min across axes.
        t_lo = (self.room_min - o) / d
        t_hi = (self.room_max - o) / d
        t_pos = np.minimum(np.maximum(t_lo, t_hi), np.inf)
        t_exit = t_pos.min(axis=-1)
        if self.open_top or self.top_opening is not None:
            # Rays whose first room crossing is the (removed) ceiling
            # escape to the sky: no return.
            exit_pt = o + d * t_exit[:, None]
            through_top = (
                np.abs(exit_pt[:, 2] - self.room_max[2]) < 1e-9
            ) & (d[:, 2] > 0)
            if self.top_opening is not None and not self.open_top:
                xy_min, xy_max = self.top_opening
                through_top &= np.all(
                    (exit_pt[:, :2] > np.asarray(xy_min))
                    & (exit_pt[:, :2] < np.asarray(xy_max)),
                    axis=-1,
                )
            t_exit = np.where(through_top, np.inf, t_exit)
        depth = t_exit

        # Entry distance into each obstacle (slab method).
        for bmin, bmax in self.obstacles:
            t0 = (bmin - o) / d
            t1 = (bmax - o) / d
            t_near = np.minimum(t0, t1).max(axis=-1)
            t_far = np.maximum(t0, t1).min(axis=-1)
            hit = (t_near <= t_far) & (t_far > 0) & (t_near > 0)
            depth = np.where(hit, np.minimum(depth, t_near), depth)

        return depth

    def sample_free_positions(self, n: int, margin: float = 0.5, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = []
        while len(out) < n:
            p = rng.uniform(self.room_min + margin, self.room_max - margin)
            inside_obstacle = any(
                np.all(p > bmin - margin) and np.all(p < bmax + margin)
                for bmin, bmax in self.obstacles
            )
            if not inside_obstacle:
                out.append(p)
        return np.stack(out)


@dataclass
class VirtualLidar:
    """Spinning lidar model: channels x azimuth columns, column-major time."""

    num_channels: int = 32
    num_columns: int = 512
    vertical_fov_deg: Tuple[float, float] = (-22.5, 22.5)
    max_range: float = 60.0
    min_range: float = 0.3
    scan_duration: float = 0.1

    def ray_directions(self) -> np.ndarray:
        """(3, num_channels * num_columns) sensor-frame unit directions,
        ordered column-major (all channels of azimuth 0, then azimuth 1, ...)
        so per-point timestamps are sorted."""
        elev = np.deg2rad(
            np.linspace(self.vertical_fov_deg[0], self.vertical_fov_deg[1], self.num_channels)
        )
        azim = np.linspace(0, 2 * np.pi, self.num_columns, endpoint=False)
        az, el = np.meshgrid(azim, elev, indexing="ij")  # (cols, channels)
        x = np.cos(el) * np.cos(az)
        y = np.cos(el) * np.sin(az)
        z = np.sin(el)
        return np.stack([x, y, z]).reshape(3, -1).astype(np.float32)

    def timestamps(self, t_start: float) -> np.ndarray:
        col_times = t_start + np.linspace(
            0, self.scan_duration, self.num_columns, endpoint=False
        )
        return np.repeat(col_times, self.num_channels)


def make_scan(
    scene: BoxRoomScene,
    lidar: VirtualLidar,
    pose: Pose,
    t_start: float,
    noise_std: float = 0.0,
    dropout: float = 0.0,
    seed: int = 0,
) -> LidarScan:
    """Simulate one sweep from ``pose`` (no motion during sweep).

    ``noise_std`` adds i.i.d. Gaussian range noise (meters);
    ``dropout`` discards each return with that probability (sensor
    dropouts / dark surfaces — the robustness-drill degradation axes;
    the reference's real datasets carry both, cf. the Ouster range
    noise spec and the canteen crowds).
    """
    dirs_sensor = lidar.ray_directions()
    rot = pose.get_rotation()
    dirs_world = (rot @ dirs_sensor).T  # (N, 3)
    origins = np.broadcast_to(pose.get_translation(), dirs_world.shape)
    depth = scene.raycast(origins, dirs_world)
    rng = np.random.default_rng(seed)
    if noise_std > 0:
        depth = depth + rng.normal(0, noise_std, depth.shape)
    valid = (depth > lidar.min_range) & (depth < min(lidar.max_range, 1e5))
    if dropout > 0:
        valid &= rng.random(depth.shape) >= dropout
    return LidarScan(
        dirs_sensor[:, valid],
        depth[valid].astype(np.float32),
        lidar.timestamps(t_start)[valid],
    )


def make_trajectory(
    scene: BoxRoomScene,
    num_poses: int,
    rate_hz: float = 10.0,
    radius: float = 3.5,
    height: float = 0.5,
    angular_span: float = 1.5 * np.pi,
    t_start: float = 100.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Circular arc trajectory inside the room, yaw tangent to motion.

    Returns ((N, 4, 4) poses, (N,) start timestamps).
    """
    ts = t_start + np.arange(num_poses) / rate_hz
    angles = np.linspace(0, angular_span, num_poses)
    poses = np.tile(np.eye(4), (num_poses, 1, 1))
    poses[:, 0, 3] = radius * np.cos(angles)
    poses[:, 1, 3] = radius * np.sin(angles)
    poses[:, 2, 3] = height
    yaw = angles + np.pi / 2
    poses[:, :3, :3] = _R.from_euler("z", yaw.reshape(-1, 1)).as_matrix()
    return poses, ts


def generate_sequence(
    num_scans: int = 50,
    scene: Optional[BoxRoomScene] = None,
    lidar: Optional[VirtualLidar] = None,
    noise_std: float = 0.0,
    rate_hz: float = 10.0,
    angular_span: float = 1.5 * np.pi,
) -> Tuple[List[LidarScan], np.ndarray, np.ndarray, BoxRoomScene, VirtualLidar]:
    """A full synthetic sequence: scans + GT poses + timestamps."""
    scene = scene or BoxRoomScene()
    lidar = lidar or VirtualLidar()
    poses, ts = make_trajectory(scene, num_scans, rate_hz=rate_hz, angular_span=angular_span)
    scans = [
        make_scan(scene, lidar, Pose(poses[i]), ts[i], noise_std=noise_std, seed=i)
        for i in range(num_scans)
    ]
    return scans, poses, ts, scene, lidar
