"""Synthetic LiDAR scenes: a box room with box obstacles, the reference-scale
courtyard, moving box actors; analytic raycast; a virtual pinhole camera that
sees a closed-form surface intensity.

Counterpart of ``loner_tpu/datasets/synthetic.py`` (numpy and scipy only).
Depths are closed-form ray/AABB intersections, so the same seed gives scans
and images bit-equal to the JAX package's, and ICP, mapping, SLAM and the
intensity head can be checked against exact ground truth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation as _R

from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import LidarScan


@dataclass
class DynamicBox:
    """A moving axis-aligned box actor (pedestrian/vehicle stand-in).

    The box center follows a piecewise-linear waypoint path at constant
    speed; the box is axis-aligned at all times (adequate for robustness
    drills — what matters is that returns appear at transient, wrong-for-
    the-map positions, like the pedestrians in the reference's real
    datasets). Before t_start / after the path ends the actor parks at
    the first / last waypoint.
    """

    size: np.ndarray  # (3,) full extents
    waypoints: np.ndarray  # (K, 3) centers
    speed: float = 1.4
    t_start: float = 0.0

    def center_at(self, t: np.ndarray) -> np.ndarray:
        """(T,) times -> (T, 3) centers (piecewise-linear, arc-length)."""
        wp = np.asarray(self.waypoints, np.float64)
        seg = np.linalg.norm(np.diff(wp, axis=0), axis=-1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        s = np.clip((np.asarray(t, np.float64) - self.t_start) * self.speed, 0.0, cum[-1])
        idx = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(seg) - 1)
        frac = (s - cum[idx]) / np.maximum(seg[idx], 1e-12)
        return wp[idx] + frac[:, None] * (wp[idx + 1] - wp[idx])


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
    # Moving actors (robustness drills): raycast consults them only when
    # per-ray times are provided.
    actors: List[DynamicBox] = field(default_factory=list)
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

    def raycast(
        self,
        origins: np.ndarray,
        directions: np.ndarray,
        times: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Exact first-hit distance for rays (N, 3), (N, 3) -> (N,).

        ``times`` (N,) enables the dynamic actors: each ray is tested
        against every actor's AABB at that ray's own emission time (the
        spinning-lidar rolling shutter is modeled exactly, not at a
        single mid-scan snapshot)."""
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

        if times is not None:
            for actor in self.actors:
                # Per-ray box position: the slab test vectorizes
                # unchanged with (N, 3) corners.
                c = actor.center_at(times)
                bmin = c - 0.5 * np.asarray(actor.size)
                bmax = c + 0.5 * np.asarray(actor.size)
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


def surface_intensity(points: np.ndarray) -> np.ndarray:
    """Deterministic RGB albedo, a smooth function of the world hit position:
    exact ground truth for the intensity head. (N, 3) -> (N, 3) in [0, 1]."""
    p = np.asarray(points, np.float64)
    r = 0.5 + 0.5 * np.sin(1.7 * p[:, 0]) * np.cos(1.3 * p[:, 1])
    g = 0.5 + 0.5 * np.sin(1.1 * p[:, 1] + 0.5) * np.cos(0.9 * p[:, 2])
    b = 0.5 + 0.5 * np.sin(0.8 * p[:, 2] + 1.0) * np.cos(1.5 * p[:, 0])
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


# Camera axes in the LiDAR frame (camera z = LiDAR x forward, camera x = -LiDAR
# y right, camera y = -LiDAR z down): the optical-frame extrinsic. Columns are
# the camera basis vectors in LiDAR coordinates.
LIDAR_TO_CAMERA_ROT = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


@dataclass
class VirtualCamera:
    """Pinhole camera rendering the analytic scene's surface intensity."""

    width: int = 96
    height: int = 64
    fov_deg: float = 70.0

    @property
    def k(self) -> np.ndarray:
        fx = 0.5 * self.width / np.tan(np.deg2rad(self.fov_deg) / 2.0)
        return np.array([[fx, 0.0, self.width / 2.0], [0.0, fx, self.height / 2.0],
                         [0.0, 0.0, 1.0]])

    def lidar_to_camera(self) -> Pose:
        mat = np.eye(4)
        mat[:3, :3] = LIDAR_TO_CAMERA_ROT
        return Pose(mat)

    def render(self, scene: "BoxRoomScene", lidar_pose: Pose) -> np.ndarray:
        """(H, W, 3) image in [0, 1] from the camera rigidly attached to
        ``lidar_pose`` by the optical-frame extrinsic."""
        from loner_tpu_torch.common.camera import get_ray_directions

        dirs_cam, _, _ = get_ray_directions(self.height, self.width, self.k)
        cam_pose = lidar_pose * self.lidar_to_camera()
        rot, t = cam_pose.get_rotation(), cam_pose.get_translation()
        dirs_w = dirs_cam @ rot.T
        dirs_w = dirs_w / np.linalg.norm(dirs_w, axis=-1, keepdims=True)
        origins = np.broadcast_to(t, dirs_w.shape)
        depth = scene.raycast(origins, dirs_w)
        hits = origins + dirs_w * depth[:, None]
        return surface_intensity(hits).reshape(self.height, self.width, 3)


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
    times = lidar.timestamps(t_start) if scene.actors else None
    depth = scene.raycast(origins, dirs_world, times=times)
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


def make_waypoint_trajectory(
    waypoints: np.ndarray,
    speed: float = 1.6,
    rate_hz: float = 10.0,
    z: float = 1.5,
    smooth_s: float = 4.0,
    t_start: float = 100.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Constant-speed trajectory along an xy waypoint polyline.

    Positions are arc-length sampled, then box-filtered over
    ``smooth_s`` seconds so corners become arcs — the heading (yaw,
    from the smoothed finite-difference velocity) is continuous and
    turn rates stay within what the 5 Hz ICP tracker absorbs (~5°/frame
    at walking speed). Returns ((N, 4, 4) poses, (N,) timestamps).
    """
    wp = np.asarray(waypoints, np.float64)[:, :2]
    seg = np.linalg.norm(np.diff(wp, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    n = max(2, int(np.floor(cum[-1] / speed * rate_hz)))
    s = np.linspace(0.0, cum[-1], n)
    idx = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(seg) - 1)
    frac = (s - cum[idx]) / np.maximum(seg[idx], 1e-12)
    xy = wp[idx] + frac[:, None] * (wp[idx + 1] - wp[idx])

    half = max(1, int(smooth_s * rate_hz / 2))
    pad = np.concatenate([np.repeat(xy[:1], half, 0), xy, np.repeat(xy[-1:], half, 0)])
    kernel = np.ones(2 * half + 1) / (2 * half + 1)
    sm = np.stack(
        [np.convolve(pad[:, k], kernel, mode="valid") for k in range(2)], axis=-1
    )

    vel = np.gradient(sm, axis=0)
    yaw = np.arctan2(vel[:, 1], vel[:, 0])
    # At the endpoints the box filter flattens the velocity to ~0 —
    # hold the nearest well-defined heading instead of atan2 noise.
    speed_ok = np.linalg.norm(vel, axis=-1) > 1e-6
    if speed_ok.any():
        first, last = np.argmax(speed_ok), len(yaw) - 1 - np.argmax(speed_ok[::-1])
        yaw[:first] = yaw[first]
        yaw[last + 1 :] = yaw[last]

    ts = t_start + np.arange(n) / rate_hz
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = sm[:, 0]
    poses[:, 1, 3] = sm[:, 1]
    poses[:, 2, 3] = z
    poses[:, :3, :3] = _R.from_euler("z", yaw.reshape(-1, 1)).as_matrix()
    return poses, ts


def _box(x0, y0, z0, x1, y1, z1) -> Tuple[np.ndarray, np.ndarray]:
    return (np.array([x0, y0, z0], np.float64), np.array([x1, y1, z1], np.float64))


def make_courtyard(
    with_actors: bool = False,
) -> Tuple[BoxRoomScene, np.ndarray, float]:
    """Reference-scale outdoor scene: a 64 x 48 m walled courtyard.

    Sized to the reference's canteen-class operating envelope
    (ray_range [1, 50], the reference's cfg/fusion_portable/
    canteen.yaml:19): open sky, two building blocks, a tower, a
    colonnade of 0.5 m pillars, a 0.6 m divider wall, benches and
    planters — structure spanning three orders of spatial scale
    (64 m walls down to 0.5 m furniture). Returns
    (scene, trajectory waypoints, walking speed); the waypoint loop
    circles the perimeter then re-enters the south corridor and the
    central plaza — a genuine revisit after ~150 m of travel.
    """
    obstacles = [
        # building A (south-west block, 16 x 12 x 9)
        _box(-24.0, -18.0, -0.5, -8.0, -6.0, 9.0),
        # building B (north-east block, 18 x 14 x 7)
        _box(8.0, 2.0, -0.5, 26.0, 16.0, 7.0),
        # tower (tall, small footprint)
        _box(-26.0, 10.0, -0.5, -20.0, 16.0, 14.0),
        # divider wall (0.6 m thick, 2 m high)
        _box(-4.0, 6.0, -0.5, 12.0, 6.6, 2.0),
    ]
    # colonnade: 6 pillars, 0.5 m square, 5 m tall, along y = -12
    for x in (0.0, 4.0, 8.0, 12.0, 16.0, 20.0):
        obstacles.append(_box(x - 0.25, -12.25, -0.5, x + 0.25, -11.75, 5.0))
    # benches (0.5 m high) and planters (1.2 m cubes): small-scale detail
    obstacles += [
        _box(-2.0, -2.0, -0.5, 0.0, -1.3, 0.5),
        _box(2.0, -6.0, -0.5, 4.0, -5.3, 0.5),
        _box(-14.0, 14.0, -0.5, -12.0, 14.7, 0.5),
        _box(0.0, 12.0, -0.5, 1.2, 13.2, 0.7),
        _box(-18.0, 0.0, -0.5, -16.8, 1.2, 0.7),
        _box(18.0, -18.0, -0.5, 19.2, -16.8, 0.7),
    ]
    scene = BoxRoomScene(
        room_min=np.array([-32.0, -24.0, -0.5]),
        room_max=np.array([32.0, 24.0, 18.0]),
        obstacles=obstacles,
        open_top=True,
    )
    if with_actors:
        # Two pedestrians crossing the sensor's path mid-run and one
        # loiterer shadowing the south corridor.
        scene.actors = [
            DynamicBox(
                size=np.array([0.5, 0.5, 1.8]),
                waypoints=np.array([[10.0, -20.0, 0.4], [10.0, -2.0, 0.4]]),
                speed=1.2,
                t_start=102.0,
            ),
            DynamicBox(
                size=np.array([0.6, 0.6, 1.8]),
                waypoints=np.array([[28.0, 0.0, 0.4], [4.0, -8.0, 0.4]]),
                speed=1.4,
                t_start=120.0,
            ),
            DynamicBox(
                size=np.array([0.5, 0.5, 1.8]),
                waypoints=np.array(
                    [[-20.0, -21.0, 0.4], [20.0, -21.0, 0.4], [-20.0, -21.0, 0.4]]
                ),
                speed=1.0,
                t_start=100.0,
            ),
        ]
    # Perimeter loop (counterclockwise), then a revisit of the south
    # corridor and a final turn into the central plaza between the two
    # buildings (crossing the colonnade line at x = -2, between pillar
    # rows).
    waypoints = np.array(
        [
            [-28.0, -20.0],
            [28.0, -20.0],
            [28.0, 20.0],
            [-2.0, 20.0],
            [-28.0, 20.0],
            [-28.0, -20.0],  # loop closed: full revisit of the start
            [0.0, -20.0],    # re-traverse half the south corridor
            [-2.0, -8.0],    # through the colonnade gap
            [-2.0, 2.0],     # central plaza
        ]
    )
    return scene, waypoints, 1.6


def generate_courtyard_sequence(
    with_actors: bool = False,
    noise_std: float = 0.0,
    dropout: float = 0.0,
    rate_hz: float = 10.0,
    lidar: Optional[VirtualLidar] = None,
    num_scans: Optional[int] = None,
) -> Tuple[List[LidarScan], np.ndarray, np.ndarray, BoxRoomScene, VirtualLidar]:
    """The reference-scale drive sequence (~150 s at walking speed), or its
    first ``num_scans`` scans with their poses and times.

    The default sensor is 64 channels x 1024 columns (~65k points/scan)
    — the reference's operating envelope is an Ouster OS1-128 masked to
    the same +/-22.5 deg vFOV (canteen.yaml:28, 60-130k points/scan per
    the motion-compensation sizes in src/common/sensors.py); a 32x512
    virtual sensor under-constrains ICP at 50 m ranges (0.37 m azimuth
    spacing at 30 m) and costs ~2x the odometry drift.
    """
    scene, waypoints, speed = make_courtyard(with_actors=with_actors)
    lidar = lidar or VirtualLidar(
        num_channels=64, num_columns=1024, max_range=60.0
    )
    poses, ts = make_waypoint_trajectory(waypoints, speed=speed, rate_hz=rate_hz)
    if num_scans is not None:
        poses, ts = poses[:num_scans], ts[:num_scans]
    scans = [
        make_scan(
            scene, lidar, Pose(poses[i]), ts[i],
            noise_std=noise_std, dropout=dropout, seed=i,
        )
        for i in range(len(ts))
    ]
    return scans, poses, ts, scene, lidar


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


def write_sequence(root: str, scans: List[LidarScan], poses: np.ndarray, ts: np.ndarray,
                   scene: Optional["BoxRoomScene"] = None,
                   camera: Optional[VirtualCamera] = None, meta: Optional[dict] = None) -> str:
    """Write a sequence as a scan-stream dataset at ``root`` (the port's
    ``ScanStreamWriter``): the scans, the GT trajectory and, with ``camera``,
    one image a scan rendered at the scan's pose and stamped at its start time,
    as ``examples/run_loner.py``'s synthetic dataset command writes them.
    Returns ``root``."""
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter

    writer = ScanStreamWriter(root, meta=meta)
    for s in scans:
        writer.add_scan(s)
    if camera is not None:
        for i, s in enumerate(scans):
            writer.add_image(camera.render(scene, Pose(poses[i])), s.get_start_time())
    writer.write_gt(poses, ts)
    return root
