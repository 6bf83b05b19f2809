"""Share-nothing job pool over local torch devices.

Counterpart of ``loner_tpu/parallel/device_pool.py``: one worker thread per
device drains a shared queue of jobs, each worker under
``torch.cuda.device(d)`` and on a stream of its own (on a CPU device, neither).
Results come back in job order; a worker's exception stops the queue and is
raised. With one device the jobs run in the calling thread, one after another.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, List, Optional, Sequence, TypeVar

import torch

T = TypeVar("T")
R = TypeVar("R")


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises without one (no fallback)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass the devices to run on (e.g. [cpu])")
    return [torch.device("cuda", i) for i in range(n)]


def _on_device(device: torch.device, own_stream: bool):
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    if own_stream:
        stack.enter_context(torch.cuda.stream(torch.cuda.Stream(device)))
    return stack


def map_jobs(fn: Callable[[T, torch.device], R], jobs: Sequence[T],
             devices: Optional[Sequence[torch.device]] = None) -> List[R]:
    """``fn(job, device)`` for every job, one worker thread per device (default:
    every CUDA device), results in job order."""
    jobs = list(jobs)
    if not jobs:
        return []
    devices = [torch.device(d) for d in (devices if devices is not None else cuda_devices())]
    if len(devices) == 1:
        with _on_device(devices[0], own_stream=False):
            return [fn(job, devices[0]) for job in jobs]

    work: "queue.Queue[tuple]" = queue.Queue()
    for item in enumerate(jobs):
        work.put(item)
    results: List[R] = [None] * len(jobs)  # type: ignore[list-item]
    errors: List[BaseException] = []
    stop = threading.Event()

    def worker(device: torch.device) -> None:
        with _on_device(device, own_stream=True):
            while not stop.is_set():
                try:
                    i, job = work.get_nowait()
                except queue.Empty:
                    break
                try:
                    results[i] = fn(job, device)
                except BaseException as e:  # raised in the caller below
                    errors.append(e)
                    stop.set()
                    break
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()

    threads = [threading.Thread(target=worker, args=(d,), daemon=True) for d in devices]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
