"""Write an Ouster-style ROS1 bag of the box room, for the real-data drill.

Counterpart of ``examples/scripts/make_synthetic_bag.py``: with the same
arguments it writes the same bag bytes, and the same ground-truth TUM file.
The bag has what makes real Ouster bags (Fusion Portable, Newer College) hard
to ingest:

- organized clouds of ``--channels`` x ``--columns`` at the ouster_ros 48-byte
  stride, with intensity, reflectivity, ring and range fields to step over;
- ring-major point order, so per-point times are not monotonic in the blob;
- per-point times as u32 scan-local nanoseconds (``ouster_ns``, the driver's),
  absolute f64 epoch seconds in a FLOAT64 ``t`` field (``epoch_f64``) or zeros
  (``zeros``, which needs ``--recompute_timestamps`` in the converter);
- dropped returns as zero rows;
- motion within a sweep: each column is raycast from its own interpolated pose;
- bz2-compressed multi-MB chunks (``--compression bz2``);
- ground truth as /tf messages in the stream at ``--tf_rate``, and a TUM file
  beside the bag (``<bag>_gt.tum``).

Header stamps are ``--epoch`` + t (1.7e9 by default). The scene and trajectory
come from ``datasets/synthetic.py``, so a SLAM run on the converted bag has
exact ground truth.

    python -m loner_tpu_torch.datasets.synthetic_bag outputs/drill/drill.bag \\
        --duration 60 --channels 128 --columns 1024 --compression bz2
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
from scipy.spatial.transform import Rotation as _R

from loner_tpu_torch.common.trajectory import TrajectoryInterpolator, dump_trajectory_to_tum
from loner_tpu_torch.datasets.rosbag_writer import (
    OUSTER_FIELDS,
    OUSTER_POINT_STEP,
    BagWriter,
    ouster_blob,
    pointcloud2_bytes,
    tf_message_bytes,
)
from loner_tpu_torch.datasets.synthetic import BoxRoomScene, make_trajectory, surface_intensity


def build_scan_arrays(scene, interp, t_start, channels, columns,
                      v_fov=(-22.5, 22.5), scan_period=0.1,
                      max_range=60.0, noise_std=0.01, seed=0):
    """Raycast one organized sweep, each column from its own pose.

    Returns (xyz (C*W, 3) f32 ring-major in the sensor frame, t_ns (C*W,)
    scan-local, intensity, ring, range_mm, column times), dropped returns zeroed.
    """
    rng = np.random.default_rng(seed)
    elev = np.deg2rad(np.linspace(v_fov[0], v_fov[1], channels))
    azim = np.linspace(0, 2 * np.pi, columns, endpoint=False)
    az, el = np.meshgrid(azim, elev, indexing="xy")  # (channels, columns)
    dirs_sensor = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    )  # (channels, columns, 3), ring-major

    col_times = t_start + np.arange(columns) / columns * scan_period
    rots = np.empty((columns, 3, 3))
    trans = np.empty((columns, 3))
    for c, t in enumerate(col_times):
        m = interp.at(t).matrix
        rots[c], trans[c] = m[:3, :3], m[:3, 3]

    dirs_world = np.einsum("cij,kcj->kci", rots, dirs_sensor)  # (ch, cols, 3)
    origins = np.broadcast_to(trans[None], dirs_world.shape)
    flat_d = dirs_world.reshape(-1, 3)
    flat_o = origins.reshape(-1, 3)
    depth = scene.raycast(flat_o, flat_d)
    depth = depth + rng.normal(0, noise_std, depth.shape)
    hits = flat_o + flat_d * depth[:, None]

    dropped = (depth <= 0.05) | (depth > max_range) | (
        rng.random(depth.shape) < 0.002  # sporadic no-returns
    )
    xyz_sensor = dirs_sensor.reshape(-1, 3) * depth[:, None]
    xyz_sensor[dropped] = 0.0

    inten = (surface_intensity(hits).mean(axis=1) * 255.0).astype(np.float32)
    inten[dropped] = 0.0
    t_ns_col = ((col_times - t_start) * 1e9).astype(np.uint64)
    t_ns = np.broadcast_to(t_ns_col[None, :], (channels, columns)).reshape(-1)
    ring = np.broadcast_to(
        np.arange(channels, dtype=np.uint8)[:, None], (channels, columns)
    ).reshape(-1)
    range_mm = (depth * 1000.0).clip(0, 2**32 - 1).astype(np.uint64)
    range_mm[dropped] = 0
    return xyz_sensor.astype(np.float32), t_ns, inten, ring, range_mm, col_times


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Write an Ouster-style ROS1 bag of the box room")
    p.add_argument("out_bag")
    p.add_argument("--duration", type=float, default=60.0, help="seconds")
    p.add_argument("--rate", type=float, default=10.0, help="scan rate Hz")
    p.add_argument("--channels", type=int, default=128)
    p.add_argument("--columns", type=int, default=1024)
    p.add_argument("--compression", choices=["none", "bz2"], default="bz2")
    p.add_argument("--chunk_mb", type=float, default=4.0)
    p.add_argument("--timestamp_mode", choices=["ouster_ns", "epoch_f64", "zeros"],
                   default="ouster_ns",
                   help="ouster_ns: u32 ns scan-local (the driver's); epoch_f64: absolute f64 "
                   "epoch seconds in a FLOAT64 't' field; zeros: degenerate stamps that need "
                   "--recompute_timestamps")
    p.add_argument("--epoch", type=float, default=1.7e9,
                   help="bag epoch (header stamps are epoch + t)")
    p.add_argument("--noise_std", type=float, default=0.01)
    p.add_argument("--traj_height", type=float, default=1.6,
                   help="trajectory z (the default clears the box obstacles)")
    p.add_argument("--tf_rate", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lidar_topic", default="/os_cloud_node/points")
    return p.parse_args(argv)


def write_bag(args: argparse.Namespace) -> dict:
    """Write the bag and its TUM ground truth; returns {"bag", "gt", "scans",
    "points", "bytes", "seconds"}."""
    n_scans = int(round(args.duration * args.rate))
    scene = BoxRoomScene()
    # The trajectory at 4x the scan rate, for smooth interpolation within a
    # sweep; a loop around the room as in the synthetic drives.
    traj_hz = args.rate * 4
    n_poses = int(round(args.duration * traj_hz)) + 8
    poses, pose_ts = make_trajectory(
        scene, n_poses, rate_hz=traj_hz, height=args.traj_height,
        angular_span=2.0 * np.pi * args.duration / 60.0, t_start=0.0,
    )
    interp = TrajectoryInterpolator(poses, pose_ts)

    os.makedirs(os.path.dirname(os.path.abspath(args.out_bag)), exist_ok=True)
    gt_path = os.path.splitext(args.out_bag)[0] + "_gt.tum"
    dump_trajectory_to_tum(poses, pose_ts + args.epoch, gt_path)

    t_wall = time.time()
    total_points = 0
    with BagWriter(args.out_bag, compression=args.compression,
                   chunk_bytes=int(args.chunk_mb * 1024 * 1024)) as bag:
        bag.add_connection(args.lidar_topic, "sensor_msgs/PointCloud2")
        bag.add_connection("/tf", "tf2_msgs/TFMessage")

        tf_ts = np.arange(0.0, args.duration, 1.0 / args.tf_rate)
        tf_i = 0
        for i in range(n_scans):
            t0 = i / args.rate
            while tf_i < len(tf_ts) and tf_ts[tf_i] <= t0:
                t = tf_ts[tf_i]
                m = interp.at(t).matrix
                q = _R.from_matrix(m[:3, :3]).as_quat()  # xyzw
                bag.write("/tf", tf_message_bytes(t + args.epoch, "map", "body", m[:3, 3], q,
                                                  seq=tf_i), t + args.epoch)
                tf_i += 1

            xyz, t_ns, inten, ring, range_mm, _ = build_scan_arrays(
                scene, interp, t0, args.channels, args.columns,
                scan_period=1.0 / args.rate if args.rate < 10 else 0.1,
                noise_std=args.noise_std, seed=args.seed + i,
            )
            stamp = t0 + args.epoch
            if args.timestamp_mode == "zeros":
                t_ns = np.zeros_like(t_ns)
            if args.timestamp_mode == "epoch_f64":
                # FLOAT64 absolute times at a free offset of the stride.
                fields = [f for f in OUSTER_FIELDS if f[0] != "t"] + [("t", 32, 8)]
                blob = np.frombuffer(
                    ouster_blob(xyz, np.zeros(len(xyz)), inten, ring, range_mm), np.uint8,
                ).reshape(-1, OUSTER_POINT_STEP).copy()
                abs_t = (t_ns.astype(np.float64) * 1e-9) + stamp
                blob[:, 32:40] = abs_t.view(np.uint8).reshape(-1, 8)
                payload = blob.tobytes()
            else:
                fields = OUSTER_FIELDS
                payload = ouster_blob(xyz, t_ns, inten, ring, range_mm)
            msg = pointcloud2_bytes(stamp, "os_sensor", args.channels, args.columns, fields,
                                    OUSTER_POINT_STEP, payload, seq=i)
            bag.write(args.lidar_topic, msg, stamp)
            total_points += len(xyz)
            if (i + 1) % 50 == 0:
                print(f"  scan {i + 1}/{n_scans}, {os.path.getsize(args.out_bag) / 1e6:.0f} MB "
                      f"on disk, {time.time() - t_wall:.0f} s", flush=True)

    dt = time.time() - t_wall
    size = os.path.getsize(args.out_bag)
    print(f"wrote {args.out_bag}: {size / 1e9:.3f} GB, {n_scans} scans, "
          f"{total_points / 1e6:.1f} M points, {dt:.1f} s ({size / 1e6 / dt:.1f} MB/s), "
          f"gt: {gt_path}", flush=True)
    return {"bag": args.out_bag, "gt": gt_path, "scans": n_scans, "points": total_points,
            "bytes": size, "seconds": dt}


def main(argv: Optional[List[str]] = None) -> None:
    write_bag(parse_args(argv))


if __name__ == "__main__":
    main()
