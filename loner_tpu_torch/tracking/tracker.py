"""Tracker: frame-to-frame ICP odometry.

Counterpart of ``loner_tpu/tracking/tracker.py``: decimated frames are
registered against the previous frame's cloud with the 2-stage point-to-plane
ICP schedule (``tracking/icp.py``, on the tracker's torch device), chained onto
the reference pose, optionally motion-compensated, and optionally given sky
rays found by spherical-projection morphology. Runs as a host thread beside
the mapper; ``SharedState`` throttles it against the mapper.

On a CUDA device the ICP runs on the tracker's own high-priority stream, so it
never queues behind the mapper's work on the default stream, and the whole
schedule is one captured CUDA graph (``icp.ICPGraph``), captured by
``warm_up`` or ``prepare_graphs`` before the worker threads start. Each CUDA
section of the tracker holds ``cuda_graphs.CAPTURE_LOCK``, so it never runs
while the mapper captures. Frames carry numpy arrays only: no tensor crosses
between the two threads, nor between cards.

``tracker.icp.device: k`` puts the ICP on card k (``cuda:k``: its clouds, its
stream, its graph and the chained velocity init), so it need not share the
mapper's card; the pose comes back to the host as before. On the CPU only 0 is
valid, and an index the machine does not have raises (the JAX package falls
back to its default device instead).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch
from scipy import ndimage

from loner_tpu_torch.common.cuda_graphs import CAPTURE_LOCK
from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.signals import Signal, SharedState, StopSignal
from loner_tpu_torch.ops.voxel import voxel_downsample
from loner_tpu_torch.tracking.frame_synthesis import FrameSynthesis
from loner_tpu_torch.tracking.icp import ICPGraph, ICPResult, run_icp_schedule


def icp_device(device: torch.device, index) -> torch.device:
    """The tracker's ICP device: ``device``, or card ``index`` when
    ``tracker.icp.device`` is set (on the CPU only 0). Raises for an index the
    machine does not have."""
    if index is None:
        return device
    index = int(index)
    if device.type == "cpu":
        if index != 0:
            raise ValueError(f"tracker.icp.device: {index} on the CPU (only 0 is valid)")
        return device
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise ValueError(f"tracker.icp.device: {index}, but this machine has {count} cards")
    return torch.device("cuda", index)


class Tracker:
    def __init__(self, settings, rgb_signal: Optional[Signal], lidar_signal: Signal,
                 frame_signal: Signal, device: torch.device) -> None:
        self._rgb_slot = rgb_signal.register() if rgb_signal is not None else None
        self._lidar_slot = lidar_signal.register()
        self._frame_signal = frame_signal
        self._settings = settings.tracker
        self._device = icp_device(torch.device(device), self._settings.icp.get("device", None))
        # Higher priority (lower number) than the default stream's mapping work.
        self._stream = (torch.cuda.Stream(self._device, priority=-1)
                        if self._device.type == "cuda" else None)

        self.t_lidar_to_camera = Pose.from_settings(settings.calibration.lidar_to_camera)
        self._frame_synthesizer = FrameSynthesis(
            self._settings.frame_synthesis, self.t_lidar_to_camera,
            bool(settings.system.lidar_only),
        )
        self.processed_stop_signal = False

        self._reference_points: Optional[np.ndarray] = None
        self._reference_pose = Pose.identity()
        self._reference_time: Optional[float] = None
        # Constant-velocity model: the last frame-to-frame transform is the
        # ICP's initial guess.
        self._last_relative = np.eye(4)
        self._use_velocity_init = bool(self._settings.icp.get("constant_velocity_init", True))
        # Pipelined ICP: frame i+1's registration is enqueued on the device
        # before frame i's result is fetched, with the velocity init chained
        # as a device tensor; the fetch of result i overlaps the work of i+1.
        # Each frame is emitted one frame later.
        self._pipelined = bool(self._settings.icp.get("pipelined", True))
        self._pending = None  # (frame, ICPResult, cloud)
        self._last_relative_dev: Optional[torch.Tensor] = None
        self._good_cloud: Optional[np.ndarray] = None  # the last accepted cloud

        self._frame_count = 0
        self._last_tracked_frame_time = 0.0
        self._shared_state: Optional[SharedState] = None

        self._frame_rate = self._settings.frame_synthesis.frame_decimation_rate_hz
        self._max_time_delta = self._settings.synchronization.max_time_delta
        self._icp_pad = int(self._settings.icp.downsample.get("target_uniform_point_count", 5000))
        self._icp_schedule = [dict(s) for s in self._settings.icp.schedule]
        self.icp_graph = (ICPGraph(self._device, self._icp_schedule, self._icp_pad)
                          if self._device.type == "cuda" else None)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def prepare_graphs(self) -> None:
        """Capture the ICP graph (a CUDA device) unless it is captured; the
        runtime calls this before the worker threads start."""
        if self.icp_graph is not None and not self.icp_graph.captured:
            with self._on_stream():
                self.icp_graph.capture()

    def warm_up(self) -> float:
        """Capture the ICP graph and run the ICP schedule once on dummy clouds
        at the configured pad size. Returns seconds."""
        t0 = time.time()
        self.prepare_graphs()
        rng = np.random.default_rng(0)
        cloud = rng.uniform(-5.0, 5.0, (self._icp_pad, 3)).astype(np.float32)
        target = cloud + rng.normal(0, 0.01, cloud.shape).astype(np.float32)
        result = self._dispatch_icp(cloud, target, np.eye(4) if self._use_velocity_init else None)
        with self._on_stream():
            result.transformation.cpu()
        return time.time() - t0

    # -- resume --------------------------------------------------------------
    def seed_reference(self, frame: Frame) -> None:
        """Prime the tracking chain from a restored keyframe (``runtime/resume.py``).
        ``frame`` holds the keyframe's tracked pose and uncompensated scan: ICP
        then chains as in the original run, and the keyframe manager's re-basing
        onto the optimised pose stays one correction. The pipeline starts empty:
        no pending result, the velocity init back to the identity on the host.
        The ICP graph keeps its static buffers; the next call fills them."""
        cloud = self._build_icp_cloud(frame)
        self._reference_points = cloud
        self._good_cloud = cloud
        self._reference_pose = frame.get_lidar_pose().clone()
        self._reference_time = frame.get_middle_time()
        self._last_relative = np.eye(4)
        self._last_relative_dev = None
        self._pending = None
        self._last_tracked_frame_time = frame.get_time()
        # Decimation continues from the seed frame.
        self._frame_synthesizer._prev_accepted_timestamp = frame.get_time()

    # -- pipeline ------------------------------------------------------------
    def update(self) -> bool:
        tic = time.time()
        num_tracked = 0
        did_work = False

        # Throttle: do not run ahead of the mapper.
        if (self._settings.synchronization.enabled and self._shared_state is not None
                and self._shared_state.last_mapped_frame_time is not None):
            while (self._last_tracked_frame_time
                   - (self._shared_state.last_mapped_frame_time + self._max_time_delta)
                   > 1.0 / self._frame_rate):
                time.sleep(0.01)

        if self._rgb_slot is not None and self._rgb_slot.has_value():
            val = self._rgb_slot.get_value()
            # The rgb stream's StopSignal is only drained: the LiDAR stream's,
            # which ``Loner.stop`` emits first, flushes the ICP and stops.
            if not isinstance(val, StopSignal):
                self._frame_synthesizer.process_image(val)
                did_work = True

        if self._lidar_slot.has_value():
            val = self._lidar_slot.get_value()
            if isinstance(val, StopSignal):
                # Drain the ICP pipeline before confirming the stop: the mapper
                # must see the last in-flight frame ahead of its own StopSignal.
                self.flush()
                self.processed_stop_signal = True
                return True
            scan, gt_pose = val
            self._frame_synthesizer.process_lidar(scan, gt_pose)
            did_work = True

        while self._frame_synthesizer.has_frame():
            frame = self._frame_synthesizer.pop_frame()
            frame._id = self._frame_count
            self._frame_count += 1
            for done in self.track_frame(frame):
                self._emit_frame(done)
                num_tracked += 1

        if num_tracked > 0 and self._settings.get("debug", {}).get("log_times", False):
            with open(f"{self._settings.log_directory}/track_times.csv", "a+") as f:
                f.write(f"{time.time() - tic},{num_tracked}\n")
        return did_work or num_tracked > 0

    def _emit_frame(self, frame: Frame) -> None:
        if self._settings.get("compute_sky_rays", False):
            self.compute_sky_rays(frame)
        if self._settings.get("debug", {}).get("write_frame_point_clouds", False):
            from loner_tpu_torch.runtime.debug_artifacts import dump_frame_point_cloud

            dump_frame_point_cloud(frame, self._settings.log_directory, frame._id)
        self._frame_signal.emit(frame)
        self._last_tracked_frame_time = frame.get_time()

    def flush(self) -> None:
        """Resolve and emit any in-flight pipelined frame."""
        for done in self.finish():
            self._emit_frame(done)

    def run(self, shared_state: SharedState) -> None:
        self._shared_state = shared_state
        while not self.processed_stop_signal:
            # Back off when idle: a busy poll starves the mapper thread.
            did_work = self.update()
            time.sleep(1e-4 if did_work else 5e-3)
        # Drain leftovers so no producer can rendezvous on a dead consumer.
        for slot in (self._lidar_slot, self._rgb_slot):
            while slot is not None and slot.has_value():
                slot.get_value()
        print("Tracking Done.")

    # -- core -----------------------------------------------------------------
    def _build_icp_cloud(self, frame: Frame) -> np.ndarray:
        downsample = self._settings.icp.downsample
        scan_duration = self._settings.icp.scan_duration
        if downsample.type in (None, "NONE"):
            return frame.build_point_cloud(scan_duration=scan_duration)
        if downsample.type == "VOXEL":
            return voxel_downsample(frame.build_point_cloud(scan_duration=scan_duration),
                                    downsample.voxel_downsample_size)
        if downsample.type == "UNIFORM":
            return frame.build_point_cloud(scan_duration=scan_duration,
                                           target_points=downsample.target_uniform_point_count)
        raise ValueError(f"Unrecognized downsample type {downsample.type}")

    def _dispatch_icp(self, cloud: np.ndarray, target: np.ndarray, init) -> ICPResult:
        with CAPTURE_LOCK, self._on_stream():
            if self.icp_graph is not None:
                return self.icp_graph(cloud, target, init)
            return run_icp_schedule(cloud, target, self._icp_schedule, pad_size=self._icp_pad,
                                    init=init, device=self._device)

    def _apply_registration(self, frame: Frame, registration: np.ndarray) -> None:
        """Compose the tracked pose, motion-compensate, and advance the chain."""
        # Re-project onto SE(3): the chain composes one registration per frame
        # for the whole run, and its float32 round-off would accumulate.
        tracked = Pose(self._reference_pose.matrix @ registration).orthonormalized()
        new_reference_time = frame.get_middle_time()
        frame._lidar_pose = tracked
        if self._settings.motion_compensation.enabled:
            frame.lidar_points.motion_compensate(
                (self._reference_pose, frame._lidar_pose),
                (self._reference_time, new_reference_time),
                frame._lidar_pose,
            )
        self._reference_time = new_reference_time
        self._reference_pose = tracked
        self._last_relative = registration

    def _resolve_pending(self):
        """Fetch the in-flight frame's ICP result. Returns (frame | None, chain_ok)."""
        frame, result, cloud = self._pending
        self._pending = None
        # One copy to the host for the transform and the fitness; on the
        # tracker's stream, so it waits for the ICP only.
        with CAPTURE_LOCK, self._on_stream():
            host = torch.cat([result.transformation.reshape(16),
                              result.fitness.reshape(1)]).cpu().numpy()
        registration = host[:16].reshape(4, 4).astype(np.float64)
        min_fitness = float(self._settings.icp.get("min_fitness", 0.1))
        if not (np.isfinite(registration).all() and float(host[16]) >= min_fitness):
            # Drop the frame, restore the last good reference cloud, and break
            # the device-chained velocity init (it holds the bad transform).
            self._reference_points = self._good_cloud
            self._last_relative_dev = None
            return None, False
        self._apply_registration(frame, registration)
        self._good_cloud = cloud
        return frame, True

    def track_frame(self, frame: Frame):
        """Track one frame. Returns the frames ready to emit, poses set: in
        pipelined mode a frame resolves when the next one arrives, so the list
        holds the previous frame (or nothing at the head of the pipeline)."""
        cloud = self._build_icp_cloud(frame)

        if self._reference_points is None:
            # The first frame anchors the coordinate system.
            frame._lidar_pose = self._reference_pose.clone()
            self._reference_points = cloud
            self._good_cloud = cloud
            self._reference_time = frame.get_middle_time()
            return [frame]

        if not self._pipelined:
            result = self._dispatch_icp(cloud, self._reference_points,
                                        self._last_relative if self._use_velocity_init else None)
            self._pending = (frame, result, cloud)
            emitted, _ = self._resolve_pending()
            if emitted is None:
                print("Warning: Failed to track frame. Skipping.")
                return []
            self._reference_points = cloud
            return [emitted]

        # Pipelined: enqueue this frame's registration against the previous
        # frame's cloud first, the velocity init chained as a device tensor...
        init = None
        if self._use_velocity_init:
            init = (self._last_relative_dev if self._last_relative_dev is not None
                    else self._last_relative)
        result = self._dispatch_icp(cloud, self._reference_points, init)
        self._last_relative_dev = result.transformation

        # ...then fetch the previous frame's result.
        out = []
        if self._pending is not None:
            emitted, chain_ok = self._resolve_pending()
            if emitted is not None:
                out.append(emitted)
            if not chain_ok:
                print("Warning: Failed to track frame. Skipping.")
                # The registration above used the rejected frame's cloud: redo
                # it against the restored good reference.
                result = self._dispatch_icp(
                    cloud, self._reference_points,
                    self._last_relative if self._use_velocity_init else None)
                self._last_relative_dev = result.transformation

        self._pending = (frame, result, cloud)
        self._reference_points = cloud
        return out

    def finish(self):
        """Drain the ICP pipeline: resolve and return the last in-flight frame."""
        if self._pending is None:
            return []
        emitted, _ = self._resolve_pending()
        if emitted is None:
            print("Warning: Failed to track frame. Skipping.")
            return []
        self._good_cloud = self._reference_points
        return [emitted]

    # -- sky rays --------------------------------------------------------------
    def compute_sky_rays(self, frame: Frame) -> None:
        """Directions with no LiDAR return above the horizon, by morphology on
        a spherical projection; stored in the sensor frame."""
        TOP_ROWS = 3
        HORIZON_OFFSET = 10.0

        dirs = frame.lidar_points.ray_directions
        x, y, z = dirs[0], dirs[1], dirs[2]
        theta = np.round(np.rad2deg(np.arctan2(y, x))).astype(np.int64)
        phi = np.round(np.rad2deg(np.arctan2(np.sqrt(x * x + y * y), z))).astype(np.int64)

        phi_img = phi - phi.min()
        theta_img = theta - theta.min()
        theta_img[theta_img == 360] = 0

        img = np.zeros((phi_img.max() + 1, 360), np.uint8)
        img[phi_img, theta_img] = 1
        img = ndimage.binary_dilation(img, np.ones((3, 3)))
        img = ndimage.binary_erosion(img, np.ones((3, 3))).astype(np.uint8)
        img[:TOP_ROWS] = 1

        zero_phi, zero_theta = np.nonzero(img == 0)
        zero_phi = np.deg2rad(zero_phi + phi.min())
        zero_theta = np.deg2rad(zero_theta + theta.min())
        zero_dirs = np.stack([np.sin(zero_phi) * np.cos(zero_theta),
                              np.sin(zero_phi) * np.sin(zero_theta),
                              np.cos(zero_phi)])  # sensor frame

        # Keep only directions above the horizon in the world frame.
        world = frame.get_lidar_pose().get_rotation() @ zero_dirs
        phi_w = 90.0 - np.rad2deg(np.arctan2(np.sqrt(world[0] ** 2 + world[1] ** 2), world[2]))
        frame.lidar_points.sky_rays = zero_dirs[:, phi_w > HORIZON_OFFSET].astype(np.float32)
