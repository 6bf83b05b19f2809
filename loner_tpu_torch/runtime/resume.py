"""Mid-run SLAM resume from a full checkpoint.

Counterpart of ``loner_tpu/runtime/resume.py``, LiDAR only. A checkpoint
{global_step, network_state_dict, poses, occ/proposal state, world_cube},
written by either package, continues a run:

- keyframes are rebuilt by re-reading their scans from the dataset at the
  checkpointed timestamps;
- motion compensation is replayed from ``tracking_only.txt`` (the tracked-pose
  chain the original compensation used);
- the tracker re-seeds from the last keyframe's tracked pose and its
  uncompensated scan, so post-resume ICP and the keyframe manager's re-basing
  act as if the run had not stopped;
- the logger reloads its trajectories, cut at the checkpoint's last keyframe
  (later frames were tracked but never mapped: they stream again).

Adam's moments are not restored: each schedule phase starts a fresh Adam.
"""
from __future__ import annotations

import os
import re
from typing import Callable, List, Optional, Tuple

import numpy as np

from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import Image, LidarScan
from loner_tpu_torch.common.trajectory import load_tum_trajectory
from loner_tpu_torch.datasets.scan_stream import ScanStreamReader, apply_fov_mask
from loner_tpu_torch.mapping.mapper import load_checkpoint


def find_resume_checkpoint(log_directory: str) -> Tuple[dict, str]:
    """The newest full checkpoint (one with network state) in
    ``<log_directory>/checkpoints``: ``final.tar`` if it is one, else the
    highest-numbered full ``ckpt_<k>.tar`` (poses-only checkpoints cannot seed
    the map). Returns (checkpoint, path)."""
    ckpt_dir = os.path.join(log_directory, "checkpoints")
    final = os.path.join(ckpt_dir, "final.tar")
    if os.path.exists(final):
        ckpt = load_checkpoint(final)
        if "network_state_dict" in ckpt:
            return ckpt, final
    numbered = sorted(((int(m.group(1)), name) for name in os.listdir(ckpt_dir)
                       if (m := re.fullmatch(r"ckpt_(\d+)\.tar", name))), reverse=True)
    for _, name in numbered:
        path = os.path.join(ckpt_dir, name)
        ckpt = load_checkpoint(path)
        if "network_state_dict" in ckpt:
            return ckpt, path
    raise FileNotFoundError(f"No full checkpoint (with network_state_dict) under {ckpt_dir}")


def _read_processed_scan(reader: ScanStreamReader, idx: int, settings) -> LidarScan:
    """Scan ``idx`` as the run streamed it: FOV-masked where the run masks."""
    scan = reader.read_scan(idx)
    fov = settings.system.lidar_fov
    if fov.enabled:
        scan = apply_fov_mask(scan, fov.range)
    return scan


def _match_scan_index(spans: np.ndarray, t: float, tol: float = 1e-3) -> int:
    """Index of the scan whose raw [start, end] interval contains ``t``.

    A checkpointed keyframe's timestamp is its FOV-masked scan's first
    timestamp, which can lie anywhere inside the raw sweep; scans are disjoint
    in time, so interval containment is unique."""
    starts, ends = spans[:, 0], spans[:, 1]
    idx = int(np.searchsorted(starts, t + tol)) - 1
    if 0 <= idx < len(starts) and starts[idx] - tol <= t <= ends[idx] + tol:
        return idx
    raise ValueError(f"No scan's time span contains keyframe timestamp {t} "
                     "— wrong dataset for this checkpoint?")


def rebuild_keyframe_frames(reader: ScanStreamReader, settings, states, t_l2c: Optional[Pose],
                            track_poses: np.ndarray, track_ts: np.ndarray,
                            compute_sky_rays: Optional[Callable[[Frame], None]] = None
                            ) -> List[Frame]:
    """The checkpointed keyframes' Frames: their scans re-read, the original
    motion compensation replayed from the tracked-pose chain
    (``tracking_only.txt``'s poses and times), with ``compute_sky_rays``
    their sky rays found again, and in camera mode their matched images (the
    first image whose timestamp lies in the scan's span, within the frame
    match tolerance; a keyframe without one trains no camera rays)."""
    spans = reader.time_spans()
    image_times: List[float] = []
    if not settings.system.lidar_only:
        image_times = [reader.read_image_timestamp(i) for i in range(len(reader.image_files()))]
    tol = float(settings.tracker.frame_synthesis.get("frame_match_tolerance", 0.01))
    gt_interp = reader.gt_interpolator
    # The original run's zero-origin offset.
    gt0_inv = None if gt_interp is None else Pose(np.linalg.inv(reader.gt_poses()[0]))
    motion_comp = bool(settings.tracker.motion_compensation.enabled)

    kf_frames: List[Frame] = []
    for state in states:
        kf_time = float(state["timestamp"])
        scan = _read_processed_scan(reader, _match_scan_index(spans, kf_time), settings)
        frame = Frame(scan, t_l2c)
        if gt_interp is not None and gt_interp.contains(kf_time):
            frame._gt_lidar_pose = gt0_inv * gt_interp.at(kf_time)
        s0, s1 = scan.get_start_time(), scan.get_end_time()
        match = next((i for i, t in enumerate(image_times) if s0 - tol <= t <= s1 + tol), None)
        if match is not None:
            frame.image = Image(*reader.read_image(match))

        # The tracker compensated each scan between its predecessor's tracked
        # pose at that scan's middle time and its own, at arrival.
        ti = int(np.argmin(np.abs(track_ts - kf_time)))
        if motion_comp and ti > 0 and abs(track_ts[ti] - kf_time) <= 1e-3:
            prev_scan = _read_processed_scan(
                reader, _match_scan_index(spans, float(track_ts[ti - 1])), settings)
            prev_mid = 0.5 * (prev_scan.get_start_time() + prev_scan.get_end_time())
            tracked = Pose.from_twist(np.asarray(state["tracked_pose"], np.float64))
            mid = 0.5 * (scan.get_start_time() + scan.get_end_time())
            scan.motion_compensate((Pose(track_poses[ti - 1]), tracked), (prev_mid, mid), tracked)
        if compute_sky_rays is not None:
            frame._lidar_pose = Pose.from_twist(np.asarray(state["tracked_pose"], np.float64))
            compute_sky_rays(frame)
        kf_frames.append(frame)
    return kf_frames


def build_seed_frame(reader: ScanStreamReader, settings, states, kf_frames: List[Frame]) -> Frame:
    """The frame that re-seeds the tracking chain: the last rebuilt keyframe's
    pose and time with its uncompensated scan (the live tracker built each
    reference cloud before it compensated the scan in place)."""
    seed = kf_frames[-1].clone()
    last = _match_scan_index(reader.time_spans(), float(states[-1]["timestamp"]))
    seed.lidar_points = _read_processed_scan(reader, last, settings)
    return seed


def resume_run(loner, reader: ScanStreamReader, prev_log_directory: str) -> int:
    """Restore a started ``Loner`` from ``prev_log_directory``'s newest full
    checkpoint. Call after ``loner.start()`` and before ``warm_up`` and
    streaming. Returns the index of the first scan to stream, the one after the
    last checkpointed keyframe."""
    settings = loner._settings
    ckpt, ckpt_path = find_resume_checkpoint(prev_log_directory)
    states = ckpt["poses"]
    if not states:
        raise ValueError(f"{ckpt_path} holds no keyframes to resume from")

    # Rays, poses and the field all live in the world cube's coordinates.
    if "world_cube" in ckpt:
        cube, ours = ckpt["world_cube"], loner.get_world_cube().as_dict()
        if not (np.allclose(cube["scale_factor"], ours["scale_factor"])
                and np.allclose(cube["shift"], ours["shift"])):
            raise ValueError(f"World cube mismatch vs {ckpt_path}: checkpoint {cube}, "
                             f"recomputed {ours}; resume needs the same dataset and "
                             "world-cube settings")

    track_file = os.path.join(prev_log_directory, "trajectory", "tracking_only.txt")
    track_poses, track_ts = load_tum_trajectory(track_file)
    tracker = loner.tracker
    sky = bool(settings.tracker.get("compute_sky_rays", False))
    kf_frames = rebuild_keyframe_frames(reader, settings, states, tracker.t_lidar_to_camera,
                                        track_poses, track_ts,
                                        compute_sky_rays=tracker.compute_sky_rays if sky else None)
    loner.mapper.restore_from_checkpoint(ckpt, kf_frames)
    # The keyframes' frames now hold their tracked poses (KeyFrame.from_pose_state).
    tracker.seed_reference(build_seed_frame(reader, settings, states, kf_frames))
    loner.logger.preload(os.path.join(prev_log_directory, "trajectory"), states)

    resume_time = float(states[-1]["timestamp"])
    later = np.nonzero(reader.start_times() > resume_time + 1e-6)[0]
    return int(later[0]) if len(later) else len(reader)
