"""The port's layer marks and spans in a device trace (``trace.py``).

The mapper's iteration launches a tiny kernel, ``loner_mark_kernel<ID>``, at
each layer boundary (``loner_tpu_torch/runtime/profiling.py``: ``MARKS``, and
``LAYERS``, the layer of the segment from mark i to mark i + 1). Here the
trace's device operations are split by the marks: an iteration is one run of
the marks 0, 1, ..., in order, and its layer's seconds are the union of the
device intervals that fall between its marks. The port's host spans are
``record_function`` ranges named ``loner/<span>`` on the profiler's clock;
each idle microsecond of the trace (its gaps, and its edges inside the spans:
before the first device operation and after the last) goes to the innermost
one that covers it.

Every function returns None where the trace or the port has nothing to read
(a port without marks or spans, as before they were added).
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

MARK = re.compile(r"loner_mark_kernel<(\d+)>")
SPAN_PREFIX = "loner/"
DISPATCH = ("dispatch.wait", "dispatch.enqueue")  # dispatch_idle_ms_per_iter
NO_SPAN = "no span"


def _profiling():
    try:
        from loner_tpu_torch.runtime import profiling
    except ImportError:
        return None
    return profiling


def layer_table() -> Optional[Tuple[str, ...]]:
    """The layer of each segment between consecutive marks, from the port."""
    layers = getattr(_profiling(), "LAYERS", None)
    return tuple(layers) if layers else None


def traced_replays() -> Optional[int]:
    """The step graphs' replays counted while tracing was on (the profiled
    window), from the port's counters."""
    counters = getattr(_profiling(), "counters", None)
    if counters is None:
        return None
    c = counters(traced=True)
    return c.get("replays.step", 0) + c.get("replays.step_occ", 0)


def iterations(trace, n_marks: int) -> List[List[Tuple[float, float]]]:
    """Each iteration's marks, (start, end) in microseconds: the runs of marks
    0 .. n_marks - 1 in order; a run broken off is left out."""
    out: List[List[Tuple[float, float]]] = []
    run: List[Tuple[float, float]] = []
    for name, start, end in trace.kernels:
        m = MARK.search(name)
        if m is None:
            continue
        mark_id = int(m.group(1))
        if mark_id >= n_marks:
            continue  # the phase's anchor
        if mark_id == len(run):
            run.append((start, end))
            if len(run) == n_marks:
                out.append(run)
                run = []
        else:
            run = [(start, end)] if mark_id == 0 else []
    return out


def _union_s(intervals) -> float:
    total, last = 0.0, None
    for s, e in sorted(intervals):
        if last is None or s > last[1]:
            if last is not None:
                total += last[1] - last[0]
            last = [s, e]
        else:
            last[1] = max(last[1], e)
    if last is not None:
        total += last[1] - last[0]
    return total / 1e6


def _between(trace, starts: List[float], start: float, end: float):
    """The device intervals of operations other than the marks that start in
    [start, end), cut to end (``starts``: the kernels' starts, in order)."""
    lo, hi = bisect.bisect_left(starts, start), bisect.bisect_left(starts, end)
    return [(s, min(e, end)) for n, s, e in trace.kernels[lo:hi] if MARK.search(n) is None]


def partition(trace) -> Optional[dict]:
    """``{"iterations": n, "layers": {layer: seconds over the n iterations},
    "segments": [[seconds of each segment] per iteration], "between":
    [seconds before each iteration since the last one ended], "busy": [device
    seconds from the last iteration's end to this one's]}``, or None without a
    whole iteration of marks."""
    layers = layer_table()
    if layers is None:
        return None
    its = iterations(trace, len(layers) + 1)
    if not its:
        return None
    out = {"iterations": len(its), "layers": dict.fromkeys(layers, 0.0), "segments": [],
           "between": [], "busy": []}
    starts = [s for _, s, _ in trace.kernels]
    previous_end = None
    for marks in its:
        seg = [_union_s(_between(trace, starts, marks[i][1], marks[i + 1][0]))
               for i in range(len(layers))]
        for layer, s in zip(layers, seg):
            out["layers"][layer] += s
        out["segments"].append(seg)
        lead = marks[0][0] if previous_end is None else previous_end
        end = marks[-1][1]
        out["between"].append(_union_s(_between(trace, starts, lead, marks[0][0])))
        lo = max(bisect.bisect_left(starts, lead) - 1, 0)  # one may start before and run on
        hi = bisect.bisect_left(starts, end)
        out["busy"].append(_union_s([(max(s, lead), min(e, end))
                                     for _, s, e in trace.kernels[lo:hi] if e > lead]))
        previous_end = end
    return out


def layer_ms_per_iter(ctx: dict, layer: str) -> Optional[float]:
    """Device milliseconds of ``layer`` a traced iteration, where the marks of
    the trace match the step replays counted in the profiled window."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    parts = partition(tr)
    if parts is None or parts["iterations"] != traced_replays():
        return None
    return 1e3 * parts["layers"][layer] / parts["iterations"]


def _spans(trace) -> List[Tuple[str, float, float]]:
    return [(n[len(SPAN_PREFIX):], s, e) for n, s, e in trace.host if n.startswith(SPAN_PREFIX)]


def idle_by_span(trace) -> Optional[Dict[str, float]]:
    """Seconds of the trace's idle by the program span that holds them: each
    piece of a gap, or of an edge of the trace inside the spans, goes to the
    innermost (shortest) ``loner/`` span that covers it, and a ``mesh.wait``
    inside a ``dispatch.wait`` to the latter; ``NO_SPAN`` holds what no span
    covers. None where the trace has no span or no device operation."""
    spans = _spans(trace)
    if not spans or not trace.kernels:
        return None
    first = min(s for _, s, _ in trace.kernels)
    last = max(e for _, _, e in trace.kernels)
    edges = [(min(s for _, s, _ in spans), first), (last, max(e for _, _, e in spans))]
    # The pieces between consecutive span ends, each with its owner.
    times = sorted({t for _, s, e in spans for t in (s, e)})
    owners = []
    for a, b in zip(times, times[1:]):
        cover = [sp for sp in spans if sp[1] <= a and sp[2] >= b]
        owner = NO_SPAN
        if cover:
            owner = min(cover, key=lambda sp: sp[2] - sp[1])[0]
            if owner == "mesh.wait" and any(sp[0] == "dispatch.wait" for sp in cover):
                owner = "dispatch.wait"
        owners.append(owner)
    out: Dict[str, float] = {}
    for g0, g1 in trace.gaps() + [(a, b) for a, b in edges if b > a]:
        covered = 0.0
        for i in range(max(bisect.bisect_right(times, g0) - 1, 0), len(owners)):
            a, b = max(times[i], g0), min(times[i + 1], g1)
            if times[i] >= g1:
                break
            if b > a:
                out[owners[i]] = out.get(owners[i], 0.0) + (b - a) / 1e6
                covered += b - a
        if g1 - g0 - covered > 1e-9:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (g1 - g0 - covered) / 1e6
    return out


def is_phase_seam(name: str) -> bool:
    """A span of the phase's own work outside its dispatches."""
    return name == "phase" or name.startswith("phase.") or name == "mesh.wait"


def idle_ms_per_iter(ctx: dict, dispatch: bool, err=None) -> Optional[float]:
    """Idle milliseconds a traced iteration in the dispatch spans (``dispatch``)
    or in the phase's seams; ``err`` gets a line with the idle in no span and
    the share of dispatch waits that found their dispatch done."""
    tr, n = ctx.get("trace"), ctx.get("traced_iterations")
    if tr is None or not n:
        return None
    by_span = idle_by_span(tr)
    if by_span is None:
        return None
    if err is not None:
        counters = _profiling().counters(traced=True)
        err("idle ms an iteration by span: " + ", ".join(
            f"{k} {1e3 * v / n:.4f}" for k, v in sorted(by_span.items(), key=lambda kv: -kv[1]))
            + f"; dispatch waits already done: {counters.get('dispatch_waits_ready', 0)} of "
            f"{counters.get('dispatch_waits', 0)}")
    total = sum(v for k, v in by_span.items()
                if (k in DISPATCH) == dispatch and (dispatch or is_phase_seam(k)))
    return 1e3 * total / n
