"""CUDA graphs of the port's programs: capture and replay with launch counts,
the capture lock, and the size of a graph's memory pool.

The kernel wrappers (``ops/{composite,fourier_mlp,hash_grid,sigma_mlp}.py``)
count their launches in Python, where the wrapper runs. Under a CUDA graph that
code runs once, at capture, and the kernel runs at every replay. ``CountedGraph``
takes the counts a capture added back out and adds them again at each replay, so
every count, the hash backward's split by variant among them, stays a count of
launches on the card.

Capture and threads. A capture is made with ``capture_error_mode=
"thread_local"`` while holding ``CAPTURE_LOCK``. The runtime makes every capture
it can before its worker threads start (``Loner.warm_up``, the tracker's ICP
graph before the threads launch); a capture the mapper makes later in its
thread (a keyframe schedule's program met for the first time, a grown point
pad) holds the lock, and the tracker holds it around each of its CUDA sections,
so the tracker is idle while the mapper captures. The thread-local mode keeps
that capture from failing on CUDA calls of threads that take no part in it.

Every capture is the span ``graph.capture`` (``runtime/profiling.py``, always
recorded) and adds one to the counter ``captures``.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

CAPTURE_LOCK = threading.RLock()

Counts = Dict[Tuple[str, str], int]


def _counters() -> dict:
    from loner_tpu_torch.ops import composite, fourier_mlp, hash_grid, sigma_mlp

    return {"composite": composite.counts, "fourier_mlp": fourier_mlp.counts,
            "hash_grid": hash_grid.counts, "sigma_mlp": sigma_mlp.counts}


def launch_counts() -> Counts:
    """Every wrapper's launch counts, keyed by (module, attribute)."""
    return {(name, attr): value for name, c in _counters().items()
            for attr, value in vars(c).items()}


def add_launch_counts(delta: Counts, times: int = 1) -> None:
    counters = _counters()
    for (name, attr), value in delta.items():
        setattr(counters[name], attr, getattr(counters[name], attr) + times * value)


class CountedGraph:
    """One ``torch.cuda.CUDAGraph`` whose replays count as the launches its
    capture made (``launches``: (module, attribute) -> launches a replay)."""

    def __init__(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self.launches: Counts = {}

    def _capture(self, fn: Callable, pool, stream, generators: Iterable[torch.Generator]):
        for generator in generators:
            self._graph.register_generator_state(generator)
        with torch.cuda.graph(self._graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            return fn()

    def _replay(self) -> None:
        self._graph.replay()

    def capture(self, fn: Callable, pool=None, stream: Optional[torch.cuda.Stream] = None,
                generators: Iterable[torch.Generator] = ()):
        """Capture ``fn()`` (on ``stream``, into ``pool``; ``generators``: the
        non-default generators it draws from, so each replay advances them).
        Returns what ``fn`` returned: tensors at the graph's static addresses."""
        from loner_tpu_torch.runtime import profiling

        before = launch_counts()
        with CAPTURE_LOCK, profiling.span("graph.capture", always=True):
            out = self._capture(fn, pool, stream, generators)
        profiling.count("captures")
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launch_counts(self.launches, -1)
        return out

    def replay(self) -> None:
        self._replay()
        add_launch_counts(self.launches)

    def pool(self):
        return self._graph.pool()

    def release(self) -> None:
        """Destroy the captured graph; a replay after this raises."""
        self._graph.reset()


def pool_bytes(pool) -> int:
    """Device bytes reserved by a graph memory pool (its segments)."""
    if pool is None:
        return 0
    key = tuple(pool)
    return sum(int(s["total_size"]) for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == key)
