"""Convert a ROS1 bag (PointCloud2 and optional TF ground truth) into a
scan-stream dataset, with the port's own reader, host ops and heuristics.

Counterpart of ``examples/convert_rosbag.py``, with the same flags and the same
output to the bit (npz arrays, ``poses_gt.tum``; ``meta.yaml`` as JSON text with
the same values). It runs once per dataset, on the host:

    python -m loner_tpu_torch.convert_rosbag input.bag out_dir \\
        [--lidar_topic /os_cloud_node/points] [--gt_topic /tf --gt_frame body] \\
        [--gt_file gt.tum] [--min_range 0.3] [--recompute_timestamps]
    python -m loner_tpu_torch.convert_rosbag input.bag --config cfg/fusion_portable/canteen.yaml

With ``--config`` (a sequence config): ``dataset`` is the default output
directory, ``groundtruth_traj`` the default ``--gt_file`` and ``dataset_family:
fusion_portable`` turns on ``--recompute_timestamps``. Each scan is decoded by
``ops/scan_ops.py::decode_point_blob`` (finite points beyond ``--min_range``),
its per-point times normalised (``datasets/scan_stream.py``) and sorted.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import List, Optional

import numpy as np

from loner_tpu_torch.common.sensors import LidarScan
from loner_tpu_torch.common.settings import load_sequence_config
from loner_tpu_torch.datasets.rosbag_reader import Bag
from loner_tpu_torch.datasets.scan_stream import (
    ScanStreamWriter,
    normalize_timestamps,
    recompute_scan_timestamps,
)
from loner_tpu_torch.ops.scan_ops import decode_point_blob


def field_layout(msg):
    """(x, y, z offsets, time offset, time kind) of a PointCloud2 message; the
    time field is the first of t / time / timestamp / time_stamp, kind 0 f32,
    1 f64, 2 u32 ns, -1 none."""
    offsets = {f.name: (f.offset, f.datatype) for f in msg.fields}
    ox, oy, oz = offsets["x"][0], offsets["y"][0], offsets["z"][0]
    t_off, t_kind = -1, -1
    for name in ("t", "time", "timestamp", "time_stamp"):
        if name in offsets:
            t_off, dtype = offsets[name]
            t_kind = {7: 0, 8: 1, 6: 2}.get(dtype, -1)  # PointField FLOAT32, FLOAT64, UINT32
            break
    return ox, oy, oz, t_off, t_kind


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Convert a ROS1 bag into a scan-stream dataset")
    parser.add_argument("bag")
    parser.add_argument("out_dir", nargs="?", default=None,
                        help="output directory (default: the sequence config's `dataset`)")
    parser.add_argument("--config", default=None,
                        help="sequence yaml (e.g. cfg/fusion_portable/canteen.yaml): `dataset` "
                        "is the default out_dir, `groundtruth_traj` the default --gt_file, "
                        "`dataset_family: fusion_portable` sets --recompute_timestamps")
    parser.add_argument("--lidar_topic", default="/os_cloud_node/points")
    parser.add_argument("--gt_file", default=None, help="TUM ground-truth file to copy")
    parser.add_argument("--gt_topic", default=None,
                        help="TF topic carrying ground-truth poses (e.g. /tf)")
    parser.add_argument("--gt_frame", default=None,
                        help="child frame to take from --gt_topic (default: all)")
    parser.add_argument("--min_range", type=float, default=0.3)
    parser.add_argument("--timestamps_relative_to_start", action="store_true", default=True)
    parser.add_argument("--recompute_timestamps", action="store_true",
                        help="rebuild per-point times from the column index (Fusion Portable)")
    args = parser.parse_args(argv)

    if args.config:
        seq = load_sequence_config(args.config)
        raw = seq["raw"] if seq is not None else {}
        if args.out_dir is None and "dataset" in raw:
            args.out_dir = os.path.expanduser(str(raw["dataset"]))
        if args.gt_file is None and raw.get("groundtruth_traj"):
            gt = os.path.expanduser(str(raw["groundtruth_traj"]))
            if os.path.exists(gt):
                args.gt_file = gt
            else:
                print(f"warning: groundtruth_traj {gt} not found; skipping GT copy")
        if raw.get("dataset_family") == "fusion_portable":
            args.recompute_timestamps = True
    if args.out_dir is None:
        parser.error("out_dir is required (or pass --config with a `dataset` key)")
    return args


def convert(args: argparse.Namespace) -> int:
    """Write the dataset ``args`` describe; returns the number of scans."""
    topics = [args.lidar_topic] + ([args.gt_topic] if args.gt_topic else [])
    writer = ScanStreamWriter(args.out_dir, meta={"source_bag": os.path.basename(args.bag)})
    count = 0
    gt_rows = []
    with Bag(args.bag) as bag:
        for topic, msg, _ in bag.read_messages(topics=topics):
            if args.gt_topic and topic == args.gt_topic:
                for tf in msg.transforms:
                    if args.gt_frame and tf.child_frame_id != args.gt_frame:
                        continue
                    tr, q = tf.transform.translation, tf.transform.rotation
                    gt_rows.append((tf.header.stamp.to_sec(), tr.x, tr.y, tr.z,
                                    q.x, q.y, q.z, q.w))
                continue
            scan_time = msg.header.stamp.to_sec()
            ox, oy, oz, t_off, t_kind = field_layout(msg)
            if args.recompute_timestamps:
                # Index mode: each kept point's pre-filter index, for its column.
                t_off, t_kind = 0, 3
            dirs, ranges, times = decode_point_blob(
                bytes(msg.data), msg.width * msg.height, msg.point_step, (ox, oy, oz),
                time_offset=t_off, time_kind=t_kind, min_range=args.min_range)
            if args.recompute_timestamps:
                # An organized cloud's width is its column count; 2048 is the
                # Fusion Portable Ouster's.
                h_res = int(msg.width) if int(msg.height) > 1 else 2048
                times = recompute_scan_timestamps(times, h_resolution=h_res)
            times = normalize_timestamps(times, scan_time, args.timestamps_relative_to_start)
            order = np.argsort(times)
            writer.add_scan(LidarScan(dirs[:, order], ranges[order], times[order]))
            count += 1

    if args.gt_file:
        shutil.copy(args.gt_file, os.path.join(args.out_dir, "poses_gt.tum"))
    elif gt_rows:
        gt_rows.sort()
        with open(os.path.join(args.out_dir, "poses_gt.tum"), "w") as f:
            for row in gt_rows:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
    return count


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    t0 = time.perf_counter()
    count = convert(args)
    print(f"Converted {count} scans to {args.out_dir} in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
