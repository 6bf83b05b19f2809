"""Loner: the top-level SLAM orchestrator.

Counterpart of ``loner_tpu/runtime/loner.py``. One process: the tracker and
the mapper are host threads joined by the signal bus, on one explicit torch
device. On a CUDA device the tracker's ICP runs on its own stream beside the
mapper's work on the default stream (on card k with ``tracker.icp.device: k``).
With ``system.mesh_devices`` the mapper's optimizer spreads over several devices:
this process is rank 0 and the others are processes the mapper starts and
``close`` stops (``parallel/mesh.py``). The threads start at the first scan,
after ``warm_up`` has captured the CUDA graphs (``common/cuda_graphs.py``).

Kept from the JAX package: the signals (LiDAR and rgb [synchronous], frame,
keyframe-update), the 2-phase StopSignal shutdown, the single-threaded
deterministic mode (deep-copying queues), the dumps of ``world_cube.yaml``,
``full_config.yaml`` and ``full_config.pkl``, and the output directory
``outputs/<experiment>_<MMDDYY_HHMMSS>/[config_<i>/][trial_<j>/]``. The two
YAML files are written as JSON text (``common/json_yaml.py``): every float has a decimal
point, which ``yaml.safe_load`` reads back to the same values: no YAML writer
is needed. In camera mode (``system.lidar_only: False``) images come in through
``process_rgb``; the tracker matches them to scans and the mapper gets the
camera calibration, which supervises the intensity head.
"""
from __future__ import annotations

import datetime
import os
import pickle
import threading
import time
from typing import List, Optional, Union

import numpy as np
import torch

from loner_tpu_torch.common.json_yaml import write_json_yaml
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.sensors import Image, LidarScan
from loner_tpu_torch.common.settings import Settings
from loner_tpu_torch.common.signals import SharedState, Signal, StopSignal
from loner_tpu_torch.common.world_cube import WorldCube, compute_world_cube
from loner_tpu_torch.mapping.mapper import Mapper
from loner_tpu_torch.runtime.logger import DefaultLogger
from loner_tpu_torch.runtime import profiling
from loner_tpu_torch.tracking.tracker import Tracker


class Loner:
    def __init__(self, settings: Union[Settings, str], device: Union[torch.device, str]) -> None:
        if isinstance(settings, str):
            settings = Settings.load_from_file(settings)
        self._settings = settings
        self._device = torch.device(device)
        self._single_threaded = bool(settings.system.single_threaded)
        self._lidar_only = bool(settings.system.lidar_only)

        self._worker_error: Optional[tuple] = None  # (thread name, exception)
        self._lidar_signal = Signal(synchronous=True, single_process=self._single_threaded,
                                    abort=lambda: self._worker_error is not None)
        self._rgb_signal = Signal(synchronous=True, single_process=self._single_threaded,
                                  abort=lambda: self._worker_error is not None)
        self._frame_signal = Signal(single_process=self._single_threaded)
        self._keyframe_update_signal = Signal(single_process=self._single_threaded)

        self._mapper: Optional[Mapper] = None
        self._tracker: Optional[Tracker] = None
        self._logger: Optional[DefaultLogger] = None
        self._tracking_thread: Optional[threading.Thread] = None
        self._mapping_thread: Optional[threading.Thread] = None

        self._world_cube: Optional[WorldCube] = None
        self._initialized = False
        self._shared_state = SharedState()

    # -- setup -----------------------------------------------------------------
    def initialize(
        self,
        all_lidar_poses: Optional[np.ndarray],
        ray_range: List[float],
        dataset_path: str = ".",
        experiment_name: Optional[str] = None,
        config_idx: Optional[int] = None,
        trial_idx: Optional[int] = None,
        traj_bounding_box: Optional[dict] = None,
        log_directory: Optional[str] = None,
    ) -> None:
        """The world cube and the log directory. ``log_directory`` continues an
        existing run in place (mid-run resume: CSV logs append, checkpoints keep
        their numbering, the config dumps are written again)."""
        self._world_cube = compute_world_cube(
            None, None, None, all_lidar_poses, ray_range, padding=0.3,
            traj_bounding_box=traj_bounding_box,
        )
        self._initialized = True
        self._dataset_path = os.path.abspath(os.path.expanduser(dataset_path))

        now_str = datetime.datetime.now().strftime("%m%d%y_%H%M%S")
        expname = self._settings.get("experiment_name", "experiment")
        self._experiment_name = f"{expname}_{now_str}"
        prefix = os.path.expanduser(self._settings.system.log_dir_prefix)
        if log_directory is not None:
            self._log_directory = os.path.abspath(log_directory)
            self._experiment_name = os.path.basename(self._log_directory)
        elif experiment_name is None:
            self._log_directory = os.path.join(prefix, self._experiment_name)
        else:
            self._log_directory = os.path.join(prefix, experiment_name)
            if config_idx is not None:
                self._log_directory = os.path.join(self._log_directory, f"config_{config_idx}")
            if trial_idx is not None:
                self._log_directory = os.path.join(self._log_directory, f"trial_{trial_idx}")
        os.makedirs(self._log_directory, exist_ok=True)

    def get_world_cube(self) -> WorldCube:
        return self._world_cube

    @property
    def log_directory(self) -> str:
        return self._log_directory

    @property
    def mapper(self) -> Optional[Mapper]:
        return self._mapper

    @property
    def tracker(self) -> Optional[Tracker]:
        return self._tracker

    @property
    def logger(self) -> Optional[DefaultLogger]:
        return self._logger

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if not self._initialized:
            raise RuntimeError("Can't Start: System Uninitialized. Call initialize first.")
        self._logger = DefaultLogger(self._frame_signal, self._keyframe_update_signal,
                                     self._log_directory)

        s = self._settings
        s["experiment_name"] = self._experiment_name
        s["dataset_path"] = self._dataset_path
        s["log_directory"] = self._log_directory
        s["world_cube"] = self._world_cube.as_dict()
        for sub in ("mapper", "tracker"):
            s[sub]["experiment_name"] = self._experiment_name
            s[sub]["log_directory"] = self._log_directory
            s[sub]["lidar_only"] = self._lidar_only
        s["mapper"]["mesh_devices"] = s.system.get("mesh_devices", 0) or 0

        # Debug flags ANDed with the global enable.
        debug = {key: bool(val) and bool(s.debug.global_enabled)
                 for key, val in s.debug.flags.items()}
        s["debug"] = Settings({"flags": s.debug.flags, "global_enabled": s.debug.global_enabled,
                               **debug})
        s["mapper"]["debug"] = s["debug"]
        s["tracker"]["debug"] = s["debug"]

        plain = s.as_plain_dict()
        write_json_yaml(os.path.join(self._log_directory, "world_cube.yaml"),
                        self._world_cube.as_dict())
        write_json_yaml(os.path.join(self._log_directory, "full_config.yaml"), plain)
        with open(os.path.join(self._log_directory, "full_config.pkl"), "wb") as f:
            pickle.dump(plain, f)

        self._started_ns = time.perf_counter_ns()
        self._profiler = profiling.RunProfiler(self._log_directory,
                                     enabled=bool(s.debug.get("profile", False)))
        self._profiler.start()

        self._mapper = Mapper(s.mapper, self._frame_signal, self._keyframe_update_signal,
                              self._world_cube, self._device,
                              enable_sky_segmentation=bool(s.system.sky_segmentation),
                              calibration=None if self._lidar_only else s.calibration)
        self._tracker = Tracker(s, self._rgb_signal, self._lidar_signal, self._frame_signal,
                                self._device)

        print(f"Starting LONER SLAM (PyTorch) on {self._device}")

    def _start_workers(self) -> None:
        """Launch the tracking and mapping threads, at the first scan (or at
        ``stop``): CUDA graphs are captured before them (``warm_up``; the
        tracker's ICP graph in any case), while no other thread runs CUDA work."""
        if self._single_threaded or self._tracking_thread is not None:
            return
        self._tracker.prepare_graphs()
        self._tracking_thread = threading.Thread(
            target=self._run_worker, args=("tracking", self._tracker.run), daemon=True)
        self._mapping_thread = threading.Thread(
            target=self._run_worker, args=("mapping", self._mapper.run), daemon=True)
        self._tracking_thread.start()
        self._mapping_thread.start()

    def warm_up(self, n_points: int) -> float:
        """Build the kernels, capture the tracker's ICP graph and every
        reachable mapping program (on the CPU: run each once), before data
        streams in and before the worker threads start. Call between
        ``start()`` and the first ``process_lidar`` with the per-scan point
        count."""
        if self._tracker is None or self._mapper is None:
            raise RuntimeError("warm_up must be called after start()")
        if self._tracking_thread is not None:
            raise RuntimeError("warm_up must come before the first process_lidar")
        t_track = self._tracker.warm_up()
        t_map = self._mapper.warm_up(n_points)
        print(f"Warm-up: tracker {t_track:.1f}s, mapper {t_map:.1f}s")
        return t_track + t_map

    def stop(self) -> None:
        self._start_workers()
        if not self._single_threaded:
            print("Stopping LONER SLAM workers")
            self._lidar_signal.emit(StopSignal())
            self._rgb_signal.emit(StopSignal())
            while not self._tracker.processed_stop_signal:
                self._check_workers()
                self._logger.update()
                time.sleep(0.1)
            # No new frames will be emitted; now stop the mapper.
            self._frame_signal.emit(StopSignal())
            while not self._mapper.processed_stop_signal:
                self._check_workers()
                self._logger.update()
                time.sleep(0.1)
        else:
            # Drain the tracker's pipelined ICP (one frame can still be in
            # flight) and let the mapper consume it before finishing.
            self._tracker.flush()
            self._mapper.update()

        self._profiler.stop()
        self._logger.finish()

        if not self._single_threaded:
            self._tracking_thread.join(timeout=30)
            self._mapping_thread.join(timeout=30)
        else:
            self._mapper.finish()
        if self._settings.debug.get("log_times", False):
            # The run's spans and the process's counters (runtime/profiling.py).
            profiling.export(os.path.join(self._log_directory, "spans.json"),
                             since_ns=self._started_ns)
        self.close()
        print("LONER SLAM successfully terminated.")

    def close(self) -> None:
        """Stop the mapper's mesh ranks (``system.mesh_devices``), if any; the
        run's end calls it, and so should a caller whose run failed."""
        if self._mapper is not None:
            self._mapper.close()

    def _run_worker(self, name: str, run) -> None:
        try:
            run(self._shared_state)
        except BaseException as e:
            self._worker_error = (name, e)
            raise

    def _check_workers(self) -> None:
        """A worker thread that failed will never drain its queue or confirm
        the stop: raise its error here instead of waiting for it forever."""
        if self._worker_error is not None:
            name, error = self._worker_error
            raise RuntimeError(f"the {name} thread failed") from error

    # -- data ingestion ---------------------------------------------------------
    def process_lidar(self, lidar_scan: LidarScan, gt_pose: Optional[Pose] = None) -> None:
        if not np.all(np.diff(lidar_scan.timestamps) >= 0):
            raise ValueError("sort your points by timestamps!")
        self._logger.update()
        self._start_workers()
        try:
            self._lidar_signal.emit((lidar_scan, gt_pose))
        except RuntimeError:
            self._check_workers()
            raise
        if self._single_threaded:
            self._tracker.update()
            self._mapper.update()

    def process_rgb(self, image: Image) -> None:
        self._logger.update()
        self._start_workers()
        try:
            self._rgb_signal.emit(image)
        except RuntimeError:
            self._check_workers()
            raise
        if self._single_threaded:
            self._tracker.update()
            self._mapper.update()
