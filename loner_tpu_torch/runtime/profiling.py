"""Tracing of the port: spans, counters, device layer marks and profiler traces.

Counterpart of ``loner_tpu/runtime/profiling.py``: ``debug.profile`` wraps the
whole run in a trace (``RunProfiler``), ``debug.profile_optimizer`` traces each
keyframe optimisation (``optimizer_trace``). Traces are Chrome trace JSON files
under ``<logdir>/profile/``, for Perfetto or chrome://tracing.

Spans. ``span(name, **ids)`` is a context manager that records the name, its
start and end on ``time.perf_counter_ns()``, the span it opened inside (on the
same thread), its self time (less its children's) and a trace id, the id of
the outermost span around it: one phase, keyframe or frame. Spans are kept in
memory, the newest ``STORE`` of them; the counter ``spans_dropped`` counts the
ones that went. A span of the hot path is recorded only while tracing is on:
while a ``torch.profiler`` session is active or after ``enable()``; with
tracing off its site costs one flag check and returns a shared no-op context.
``span(name, always=True)`` records always: set-up (``graph.capture``,
``kernels.build``, ``warm_up``) and the SLAM runtime's frame and keyframe spans,
which cost nothing next to what they time. Under an active profiler every span
is also a ``torch.profiler.record_function`` range named ``loner/<name>``, on
the profiler's clock beside the device operations. ``record`` adds a span
whose ends were taken elsewhere (a frame's wait in a queue).

Counters (``count``, ``counters()``) are integer adds, always on; ``counters(
traced=True)`` holds only what was counted while tracing was on.
``counters()`` also holds the kernel wrappers' launch counts
(``common/cuda_graphs.py::launch_counts``), read when it is called.

Layer marks. ``LayerMarks`` is a program's device ring of the timestamps that
``ops/marks.py`` writes at the layer boundaries of the mapper's iteration
(``MARKS``); the segment from mark i to mark i + 1 is ``SEGMENTS[i]`` of layer
``LAYERS[i]``. While tracing is on, a phase adds its iterations' segments as
device spans (``device.<segment>``), mapped onto ``perf_counter_ns``.

``export(path)`` writes the spans, the device segments and the counters as one
Chrome trace JSON; under ``debug.log_times`` the runtime writes
``<logdir>/spans.json`` at its stop. ``timing.csv`` is written by the optimizer.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

STORE = 1 << 16  # spans kept in memory, the newest

COUNTERS = (
    "replays.draw", "replays.step", "replays.step_occ",  # graph replays of a phase
    "dispatches", "dispatch_waits", "dispatch_waits_ready",  # run_dispatches
    "phases", "captures", "captures.late", "mesh_polls", "kernels.built",
    "camera.rays", "camera.points",  # a camera phase's rays and field points, per iteration
    "frames_tracked", "frames_throttled", "keyframes",  # the SLAM runtime
    "spans_dropped",
)

# The layer marks of the mapper's iteration (``mapping/phase_graph.py``), in
# the order they run. The backward's marks come from identity autograd
# functions at the forward's boundaries (``LayerMarks.boundary``). The camera
# branch's four marks fire in every iteration: without a camera branch its two
# segments are empty.
MARKS = ("iteration", "rays", "field", "composite", "losses", "camera", "camera.end",
         "camera.bwd", "camera.bwd_end", "composite.bwd", "field.bwd", "rays.bwd", "optimizer",
         "end")
(ITERATION, RAYS, FIELD, COMPOSITE, LOSSES, CAMERA, CAMERA_END, CAMERA_BWD, CAMERA_BWD_END,
 COMPOSITE_BWD, FIELD_BWD, RAYS_BWD, OPTIMIZER, END) = range(len(MARKS))
ANCHOR = len(MARKS)  # the mark that maps the device clock onto the host's
# Segment i runs from mark i to mark i + 1. "grad_zero": the fixed-point sums'
# zeroing; "losses": the proposal's linear loss; "camera" and "camera.bwd": the
# camera branch, forward and backward (its rays, their samples, the field at
# their points, the intensity head, the compositing and the weighted MSE added
# to the loss; under a mesh the camera rays are built beside the LiDAR rays, for
# the window's counts); "bwd_start": the backward's start; "losses.bwd": the
# proposal's linear loss, backward.
SEGMENTS = ("grad_zero", "rays", "field", "composite", "losses", "camera", "bwd_start",
            "camera.bwd", "losses.bwd", "composite.bwd", "field.bwd", "rays.bwd", "optimizer")
SAMPLER, SIGMA_FIELD, COMPOSITING, OPTIMIZER_STEP, CAMERA_BRANCH = (
    "ray build and sampler", "sigma field", "compositing and loss", "optimizer step",
    "camera branch")
LAYERS = (OPTIMIZER_STEP, SAMPLER, SIGMA_FIELD, COMPOSITING, SAMPLER, CAMERA_BRANCH, SAMPLER,
          CAMERA_BRANCH, SAMPLER, COMPOSITING, SIGMA_FIELD, SAMPLER, OPTIMIZER_STEP)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int  # 0: opened inside no span
    trace_id: int
    self_ns: int
    thread: str  # "device" for a device segment
    ids: dict


_enabled = False
_store: collections.deque = collections.deque(maxlen=STORE)
_totals: Dict[str, List[int]] = {}  # name -> [spans, ns], never dropped
_next_id = itertools.count(1)
_local = threading.local()
_counts = dict.fromkeys(COUNTERS, 0)
_traced = dict.fromkeys(COUNTERS, 0)

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def profiler_active() -> bool:
        """A ``torch.profiler`` (or autograd profiler) session is recording."""
        return _autograd_profiler._is_profiler_enabled
else:  # older PyTorch: the C flag
    profiler_active = torch._C._autograd._profiler_enabled


def enable() -> None:
    """Turn tracing on without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def tracing() -> bool:
    return _enabled or profiler_active()


# -- spans -----------------------------------------------------------------------
def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _add(span: Span) -> None:
    if len(_store) == STORE:
        count("spans_dropped")
    _store.append(span)
    total = _totals.setdefault(span.name, [0, 0])
    total[0] += 1
    total[1] += span.end_ns - span.start_ns


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "ids", "start", "child_ns", "span_id", "parent", "trace_id", "range")

    def __init__(self, name: str, ids: dict) -> None:
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.span_id = next(_next_id)
        self.trace_id = self.parent.trace_id if self.parent is not None else self.span_id
        self.child_ns = 0
        self.range = None
        if profiler_active():
            self.range = _autograd_profiler.record_function("loner/" + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        duration = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += duration
        _add(Span(self.name, self.start, end, self.span_id,
                  parent.span_id if parent is not None else 0, self.trace_id,
                  duration - self.child_ns, threading.current_thread().name, self.ids))
        return False


def span(name: str, *, always: bool = False, **ids):
    """A span around a ``with`` block (see the module docstring); ``ids`` are
    kept with it."""
    if not (always or _enabled or profiler_active()):
        return _NO_SPAN
    return _OpenSpan(name, ids)


def record(name: str, start_ns: int, end_ns: int, *, always: bool = False, **ids) -> None:
    """A span whose ends were taken elsewhere, on ``perf_counter_ns``, as a
    child of the span open on this thread."""
    if not (always or tracing()):
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    span_id = next(_next_id)
    if parent is not None:
        parent.child_ns += end_ns - start_ns
    _add(Span(name, int(start_ns), int(end_ns), span_id,
              parent.span_id if parent is not None else 0,
              parent.trace_id if parent is not None else span_id, int(end_ns - start_ns),
              threading.current_thread().name, ids))


def spans(name: Optional[str] = None) -> List[Span]:
    """The spans in the store (oldest first), or those named ``name``."""
    return [s for s in list(_store) if name is None or s.name == name]


def totals() -> Dict[str, Tuple[int, float]]:
    """Every span name's (spans, seconds) since the start or ``clear``, the
    dropped ones included."""
    return {name: (n, ns / 1e9) for name, (n, ns) in list(_totals.items())}


def clear() -> None:
    """Forget the spans and their totals (the counters stay)."""
    _store.clear()
    _totals.clear()


# -- counters ----------------------------------------------------------------------
def count(name: str, n: int = 1) -> None:
    _counts[name] += n
    if _enabled or profiler_active():
        _traced[name] += n


def counters(traced: bool = False) -> Dict[str, int]:
    """A snapshot of the counters and, unless ``traced``, the kernel wrappers'
    launch counts (``launches.<module>.<counter>``); ``traced``: what was
    counted while tracing was on."""
    if traced:
        return dict(_traced)
    from loner_tpu_torch.common.cuda_graphs import launch_counts

    out = dict(_counts)
    out.update({f"launches.{m}.{a}": v for (m, a), v in launch_counts().items()})
    return out


# -- device layer marks --------------------------------------------------------------
class _Boundary(torch.autograd.Function):
    """Identity; marks ``fwd`` in the forward and ``bwd`` when the gradient
    reaches this point of the backward."""

    @staticmethod
    def forward(ctx, x, marks, fwd: int, bwd: int):
        marks.mark(fwd)
        ctx.marks, ctx.bwd = marks, bwd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.marks.mark(ctx.bwd)
        return grad, None, None, None


class LayerMarks:
    """The layer marks of one program: a ring of ``rows`` iterations x
    ``len(MARKS)`` device timestamps, written at row ``slot`` (the program's
    device int64 iteration slot). The iteration marks ``ITERATION`` first,
    passes its tensors through ``boundary`` at the forward's layer boundaries,
    calls ``after_backward`` after its backward and marks ``END`` last."""

    def __init__(self, rows: int, slot: torch.Tensor) -> None:
        self.slot = slot
        self.ring = torch.zeros((rows, len(MARKS)), dtype=torch.int64, device=slot.device)
        self._anchor = torch.zeros((1, ANCHOR + 1), dtype=torch.int64, device=slot.device)
        self._unfired: List[int] = []

    def mark(self, mark_id: int, offset: int = 0) -> None:
        from loner_tpu_torch.ops.marks import mark

        mark(mark_id, self.ring, self.slot, offset)

    def boundary(self, x: torch.Tensor, fwd: int, bwd: int) -> torch.Tensor:
        """``x`` through mark ``fwd``; the backward marks ``bwd`` when the
        gradient reaches ``x``, or, where nothing differentiates ``x``,
        ``after_backward`` does."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Boundary.apply(x, self, fwd, bwd)
        self.mark(fwd)
        self._unfired.append(bwd)
        return x

    def after_backward(self) -> None:
        for mark_id in sorted(self._unfired):
            self.mark(mark_id)
        self._unfired.clear()
        self.mark(OPTIMIZER)

    def offset_ns(self) -> int:
        """``perf_counter_ns`` minus the device's clock, from one anchor mark
        read back after a synchronisation: a device time plus this is at most
        the read's length late. 0 on the CPU (the plain marks' clock)."""
        if self.ring.device.type != "cuda":
            return 0
        from loner_tpu_torch.ops.marks import mark

        mark(ANCHOR, self._anchor)
        device_ns = int(self._anchor[0, ANCHOR])  # waits for the device
        return time.perf_counter_ns() - device_ns

    def add_spans(self, chunks: Sequence[torch.Tensor]) -> int:
        """Add the iterations of ``chunks`` (rows in iteration order) as device
        spans, children of the span open on this thread; the read is the span
        ``phase.read_marks``. Returns the iterations added; a row not marked in
        order is left out."""
        with span("phase.read_marks"):
            rows = torch.cat(list(chunks)).cpu().tolist()
            offset = self.offset_ns()
        stack = _stack()
        parent = stack[-1] if stack else None
        added = 0
        for it, row in enumerate(rows):
            if row[0] <= 0 or any(b < a for a, b in zip(row, row[1:])):
                continue
            for i, name in enumerate(SEGMENTS):
                span_id = next(_next_id)
                _add(Span("device." + name, row[i] + offset, row[i + 1] + offset, span_id,
                          parent.span_id if parent is not None else 0,
                          parent.trace_id if parent is not None else span_id,
                          row[i + 1] - row[i], "device", {"iteration": it, "layer": LAYERS[i]}))
            added += 1
        return added


# -- export --------------------------------------------------------------------------
def export(path: str, since_ns: int = 0) -> None:
    """The spans that started at ``since_ns`` or later, the device segments and
    the counters, as one Chrome trace JSON (times in microseconds on
    ``perf_counter_ns``)."""
    pid = os.getpid()
    events = [{"name": s.name, "cat": "device" if s.thread == "device" else "host", "ph": "X",
               "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
               "tid": s.thread, "args": {"span": s.span_id, "parent": s.parent_id,
                                         "trace": s.trace_id, "self_us": s.self_ns / 1e3,
                                         **s.ids}}
              for s in list(_store) if s.start_ns >= since_ns]
    snapshot = counters()
    events.append({"name": "counters", "ph": "C", "ts": time.perf_counter_ns() / 1e3,
                   "pid": pid, "args": snapshot})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"clock": "perf_counter_ns", "counters": snapshot,
                                 "traced_counters": counters(traced=True)}}, fh)


def read_spans(path: str, name: Optional[str] = None) -> List[dict]:
    """The span events of a file ``export`` wrote (those named ``name``)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and (name is None or e["name"] == name)]


# -- torch.profiler traces --------------------------------------------------------------
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
