"""A device trace of a window: ``torch.profiler`` over the work, reduced to the
kernels' intervals on the card and the host's ranges beside them.

``busy_s`` is the union of the device operations' intervals (not their sum:
streams overlap), ``window_s`` the host's wall clock around the traced work,
which ends in ``torch.cuda.synchronize()``. ``breakdown`` gives the device
operations that took most time and the longest idle gaps, each named by the
host range that overlaps it most.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Tuple

NAME_CHARS = 120  # a breakdown entry's name, cut to this many characters


class Trace:
    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float) -> None:
        """``kernels`` and ``host``: (name, start, end) in microseconds on the
        profiler's one clock; ``window_s``: the traced wall in seconds."""
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.host = host
        self.window_s = window_s
        self._union = _union([(s, e) for _, s, e in self.kernels])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union) / 1e6

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Seconds of the device operations whose names ``match`` (a sum)."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        return [(a[1], b[0]) for a, b in zip(self._union, self._union[1:]) if b[0] > a[1]]

    def top(self, count: int, chars: int = NAME_CHARS) -> List[Tuple[str, float]]:
        """The ``count`` device operations of most seconds, by name (cut to
        ``chars`` characters)."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n[:chars]] = by_name.get(n[:chars], 0.0) + (e - s) / 1e6
        return sorted(by_name.items(), key=lambda kv: -kv[1])[:count]

    def breakdown(self) -> Dict[str, list]:
        ops = self.top(10)
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        gaps = [[self._host_during(s, e), (e - s) / 1e6] for s, e in longest]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": gaps}

    def _host_during(self, start: float, end: float) -> str:
        best, overlap, best_len = "no host range", 0.0, float("inf")
        for n, s, e in self.host:
            o = min(e, end) - max(s, start)
            # The innermost range of the most overlap: ties go to the shorter one.
            if o > overlap or (o == overlap and o > 0 and (e - s) < best_len):
                best, overlap, best_len = n[:NAME_CHARS], o, e - s
        return best


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def traced(work: Callable[[], None], device=None) -> Trace:
    """Run ``work`` under the profiler (CPU and CUDA activities) and return its
    trace; the wall ends in ``torch.cuda.synchronize()``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return from_profile(prof, wall)


def from_profile(prof, window_s: float) -> Trace:
    """The device operations of a profile: its CUDA events less the host ranges
    it reports again on the device (``record_function``'s), which span kernels
    counted already."""
    import torch

    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type == cpu}
    kernels = [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events
               if e.device_type == cuda and e.name not in host_names]
    host = [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events
            if e.device_type == cpu]
    return Trace(kernels, host, window_s)

