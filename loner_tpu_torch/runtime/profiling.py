"""Profiling hooks: torch.profiler traces.

Counterpart of ``loner_tpu/runtime/profiling.py``: ``debug.profile`` wraps the
whole run in a trace (``RunProfiler``), ``debug.profile_optimizer`` traces each
keyframe optimisation (``optimizer_trace``). Traces are Chrome trace JSON files
under ``<logdir>/profile/``, for Perfetto or chrome://tracing. The timing CSVs
(timing.csv, track_times.csv, map_times.csv) are written by their modules.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class RunProfiler:
    """Whole-run trace, written to ``<logdir>/profile/trace/trace.json``."""

    def __init__(self, log_directory: str, enabled: bool = False) -> None:
        self._enabled = enabled
        self._dir = os.path.join(log_directory, "profile", "trace")
        self._prof: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        if not self._enabled or self._prof is not None:
            return
        os.makedirs(self._dir, exist_ok=True)
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(os.path.join(self._dir, "trace.json"))
        self._prof = None


@contextmanager
def optimizer_trace(log_directory: Optional[str], enabled: bool, keyframe_idx: int = 0):
    """Trace of one keyframe optimisation, written to
    ``<logdir>/profile/optimizer/kf_<keyframe_idx>.json``."""
    if not enabled or log_directory is None:
        yield
        return
    trace_dir = os.path.join(log_directory, "profile", "optimizer")
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"kf_{keyframe_idx}.json"))
