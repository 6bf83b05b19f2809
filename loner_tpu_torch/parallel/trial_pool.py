"""Per-device subprocess pool for parallel SLAM trials.

Counterpart of ``loner_tpu/parallel/trial_pool.py``. One process cannot run two
trials at once (each starts tracker and mapper threads on one device), so each
trial is a child process (``python -m loner_tpu_torch.run_loner --_trial_spec
<spec>``), at most ``workers`` at a time, each pinned to one card by
``CUDA_VISIBLE_DEVICES`` before it initialises CUDA. A child that fails leaves
its siblings running; its return code is reported, not raised.
"""
from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

POLL_S = 0.2  # seconds between polls of the children

@dataclass
class TrialResult:
    index: int
    returncode: int
    device: Optional[str]
    wall_s: float


def device_env(device: Optional[str]) -> dict:
    """The child's environment, pinned to one CUDA device (unpinned for None)."""
    env = os.environ.copy()
    if device is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(device)
    return env


def run_pool(commands: Sequence[List[str]], workers: int,
             devices: Optional[Sequence[str]] = None,
             on_start: Optional[Callable[[int, Optional[str]], None]] = None) -> List[TrialResult]:
    """Run ``commands`` with at most ``workers`` children at a time; worker slot i
    pins ``devices[i % len(devices)]``. Children inherit stdout and stderr.
    Returns one ``TrialResult`` a command, in order."""
    workers = max(1, int(workers))
    slots: List[Optional[tuple]] = [None] * workers  # (process, index, t0, device)
    results: List[Optional[TrialResult]] = [None] * len(commands)
    next_idx = 0
    while next_idx < len(commands) or any(s is not None for s in slots):
        for i in range(workers):
            if slots[i] is not None:
                proc, idx, t0, dev = slots[i]
                rc = proc.poll()
                if rc is None:
                    continue
                results[idx] = TrialResult(idx, rc, dev, time.time() - t0)
                slots[i] = None
            if next_idx < len(commands):
                dev = str(devices[i % len(devices)]) if devices else None
                if on_start is not None:
                    on_start(next_idx, dev)
                proc = subprocess.Popen(commands[next_idx], env=device_env(dev))
                slots[i] = (proc, next_idx, time.time(), dev)
                next_idx += 1
        time.sleep(POLL_S)
    return [r for r in results if r is not None]
