"""Mapper: keyframe gating, the windowed optimisation and checkpoints.

Counterpart of ``loner_tpu/mapping/mapper.py``. Drains the frame signal,
elects keyframes, runs the optimiser on the active window, emits the keyframe
pose states, and writes checkpoints with the reference's cadence and names
(``ckpt_<kf>.tar`` per keyframe: poses only, except every 10th keyframe at
STANDARD and every one at VERBOSE, which hold the full state; ``final.tar`` at
shutdown). A checkpoint is a pickled dict of numpy arrays in the JAX package's
schema, so either package reads what the other wrote.
"""
from __future__ import annotations

import copy
import os
import pickle
import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.common.signals import SharedState, Signal, StopSignal
from loner_tpu_torch.common.world_cube import WorldCube
from loner_tpu_torch.convert import (  # noqa: F401  (tree_to_numpy: the public name)
    field_params_to_jax,
    occ_grid_to_jax,
    proposal_params_to_jax,
    tree_to_numpy,
)
from loner_tpu_torch.runtime import profiling


def save_checkpoint(path: str, ckpt: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def build_ckpt(field_params: Dict[str, Any], occ_state: Any, poses: List[dict],
               world_cube: WorldCube, global_step: int) -> dict:
    """A full checkpoint from the port's state. ``poses`` are keyframe pose
    states (``timestamp``, ``lidar_pose`` twist, ...); ``occ_state`` is the OGM
    grid (written as the (V, V, V) f32 array), the proposal params, or None for
    the uniform sampler."""
    ckpt = {
        "global_step": int(global_step),
        "network_state_dict": field_params_to_jax(field_params),
        "poses": poses,
        "world_cube": world_cube.as_dict(),
    }
    if occ_state is not None:
        ckpt["occ_model_state_dict"] = (proposal_params_to_jax(occ_state)
                                        if isinstance(occ_state, dict)
                                        else occ_grid_to_jax(occ_state))
    return ckpt


def build_camera_geometry(calibration) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(camera-frame pixel directions (H W, 3) f32, LiDAR-to-camera (4, 4) f32)
    for the camera branch, or None without a calibrated camera (a LiDAR-only
    run)."""
    if calibration is None:
        return None
    intr = calibration.camera_intrinsic
    if intr.get("k") is None or intr.get("width") is None:
        return None
    from loner_tpu_torch.common.camera import get_ray_directions
    from loner_tpu_torch.common.pose import Pose

    k = np.asarray(intr.k, np.float64).reshape(3, 3)
    new_k = intr.get("new_k")
    new_k = k if new_k is None else np.asarray(new_k, np.float64).reshape(3, 3)
    dist = intr.get("distortion")
    dirs, _, _ = get_ray_directions(int(intr.height), int(intr.width), new_k,
                                    dist=None if dist is None else np.asarray(dist, np.float64),
                                    k=k)
    l2c = Pose.from_settings(calibration.lidar_to_camera).matrix
    return dirs.astype(np.float32), np.asarray(l2c, np.float32)


class Mapper:
    def __init__(
        self,
        settings,
        frame_signal: Signal,
        keyframe_update_signal: Signal,
        world_cube: WorldCube,
        device: torch.device,
        enable_sky_segmentation: bool = False,
        calibration=None,
    ) -> None:
        from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManager
        from loner_tpu_torch.mapping.optimizer import Optimizer, OptimizerConfig
        from loner_tpu_torch.models.field import FieldConfig

        self._frame_slot = frame_signal.register()
        self._keyframe_update_signal = keyframe_update_signal
        self._settings = settings
        self._world_cube = world_cube

        seed = int(settings.optimizer.get("seed", 0))
        self._keyframe_manager = KeyFrameManager(settings.keyframe_manager, seed=seed)

        model_cfg = settings.optimizer.model_config
        model_type = str(model_cfg.model.get("model_type", "nerf_decoupled"))
        if model_type != "nerf_decoupled":
            raise ValueError(f"unknown model_type {model_type!r}")
        # system.mesh_devices (injected by Loner.start): 0 or absent is one
        # device, an int N > 1 the 1-D keyframe-slot mesh, [kf, ray] the mesh that
        # also shards each slot's points (parallel/mesh.py), from this device on.
        from loner_tpu_torch.parallel.mesh import mesh_from_setting

        mesh = mesh_from_setting(settings.get("mesh_devices", 0), device)
        # The optimiser's full window class is the keyframe window's size; sky
        # rays are on where the tracker segments sky and the schedule samples it.
        opt_cfg = replace(
            OptimizerConfig.from_settings(settings.optimizer, model_cfg),
            window_size=int(settings.keyframe_manager.window_selection.window_size),
            enable_sky=enable_sky_segmentation and int(settings.optimizer.num_samples.sky) > 0,
        )
        field_cfg = FieldConfig.from_settings(model_cfg.model.nerf_config,
                                              int(model_cfg.model.num_colors))
        debug = settings.debug
        self._optimizer = Optimizer(
            opt_cfg, field_cfg, world_cube.scale_factor, world_cube.shift,
            settings.optimizer.keyframe_schedule, device,
            skip_pose_refinement=bool(settings.optimizer.skip_pose_refinement),
            use_gt_poses=bool(debug.get("use_groundtruth_poses", False)),
            freeze_poses=bool(settings.optimizer.freeze_poses),
            seed=seed,
            log_directory=settings.get("log_directory"),
            profile_optimizer=bool(debug.get("profile_optimizer", False)),
            camera_rays=build_camera_geometry(calibration),
            mesh=mesh,
            **{k: bool(debug.get(k, False)) for k in (
                "log_losses", "write_ray_point_clouds", "store_ray", "draw_samples",
                "draw_rays_eps")},
        )

        self.processed_stop_signal = False
        self._shared_state: Optional[SharedState] = None
        self._optimizer_enabled = bool(settings.optimizer.get("enabled", True))
        self._log_level = settings.get("log_level", "DISABLED")
        self._log_directory = settings.get("log_directory", ".")
        os.makedirs(f"{self._log_directory}/checkpoints", exist_ok=True)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def keyframe_manager(self):
        return self._keyframe_manager

    def warm_up(self, n_points: int) -> float:
        """Build the kernels and run each reachable phase runner once (see
        ``Optimizer.warm_up``)."""
        if not self._optimizer_enabled:
            return 0.0
        return self._optimizer.warm_up(n_points)

    def update(self) -> bool:
        """Take one frame from the tracker; map it if it is a keyframe. Spans
        (``runtime/profiling.py``, always recorded): ``mapper.queue_wait`` (from
        the tracker's emit to here) and ``mapper.keyframe`` (its optimisation
        and checkpoint); each keyframe adds one to the counter ``keyframes``."""
        did_work = False

        if self._frame_slot.has_value():
            new_frame = self._frame_slot.get_value()
            did_work = True
            if isinstance(new_frame, StopSignal):
                self.processed_stop_signal = True
                return True
            emitted = getattr(new_frame, "_emitted_ns", None)
            if emitted is not None:
                profiling.record("mapper.queue_wait", emitted, time.perf_counter_ns(),
                                 always=True, frame=new_frame._id)

            if self._settings.debug.get("use_groundtruth_poses", False):
                # A shallow copy: the Frame is shared with the logger thread.
                new_frame = copy.copy(new_frame)
                new_frame._lidar_pose = new_frame._gt_lidar_pose

            accepted = self._keyframe_manager.process_frame(new_frame) is not None
            if self._shared_state is not None:
                self._shared_state.last_mapped_frame_time = (
                    self._keyframe_manager.get_last_mapped_time())

            if self._optimizer_enabled and accepted:
                profiling.count("keyframes")
                with profiling.span("mapper.keyframe", always=True,
                                    keyframe=self._optimizer._keyframe_count):
                    self._optimizer.iterate_optimizer(
                        self._keyframe_manager.get_active_window())
                    pose_state = self._keyframe_manager.get_poses_state()
                    kf_idx = self._optimizer._keyframe_count - 1
                    path = f"{self._log_directory}/checkpoints/ckpt_{kf_idx}.tar"
                    if (kf_idx % 10 == 0 and self._log_level == "STANDARD") or (
                            self._log_level == "VERBOSE"):
                        save_checkpoint(path, self.build_ckpt())
                    else:
                        save_checkpoint(path, {"global_step": self._optimizer.state.global_step,
                                               "poses": pose_state})
                self._keyframe_update_signal.emit(pose_state)
        elif self._shared_state is not None:
            t = self._keyframe_manager.get_last_mapped_time()
            if t is not None:
                self._shared_state.last_mapped_frame_time = t
        return did_work

    def run(self, shared_state: SharedState) -> None:
        self._shared_state = shared_state
        while not self.processed_stop_signal:
            did_work = self.update()
            time.sleep(1e-4 if did_work else 5e-3)
        self.finish()
        print("Mapping Done.")

    def build_ckpt(self) -> dict:
        """A full checkpoint of the map state and the keyframe poses."""
        opt = self._optimizer
        return build_ckpt(opt.state.field_params, opt.state.occ_grid,
                          self._keyframe_manager.get_poses_state(), self._world_cube,
                          opt.state.global_step)

    def close(self) -> None:
        """Stop the mesh's other ranks, if the mapper runs on a mesh."""
        self._optimizer.close()

    def finish(self) -> None:
        path = f"{self._log_directory}/checkpoints/final.tar"
        print("Saving Last Checkpoint to", path)
        save_checkpoint(path, self.build_ckpt())

    def restore_from_checkpoint(self, ckpt: dict, kf_frames) -> None:
        """Rebuild the keyframe set from a full checkpoint's pose states and
        re-read Frames, and seat the optimiser's map state. ``kf_frames[i]`` is
        the Frame whose scan matches ``ckpt['poses'][i]['timestamp']``."""
        from loner_tpu_torch.mapping.keyframe import KeyFrame

        states = ckpt["poses"]
        if len(states) != len(kf_frames):
            raise ValueError(f"checkpoint has {len(states)} keyframes, got "
                             f"{len(kf_frames)} rebuilt frames")
        keyframes = [KeyFrame.from_pose_state(frame, state, anchored=(i == 0))
                     for i, (state, frame) in enumerate(zip(states, kf_frames))]
        self._keyframe_manager.restore(keyframes)
        self._optimizer.restore(ckpt["network_state_dict"], ckpt.get("occ_model_state_dict"),
                                ckpt["global_step"], len(keyframes))
