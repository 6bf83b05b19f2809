"""The port's tracing (``runtime/profiling.py``) and the benchmark's readers of it
(``portbench/layers.py``, ``portbench/metrics``).

- The span store: nesting, parent and trace ids, self time, the bound with
  ``spans_dropped``; with tracing off nothing is recorded and no profiler range
  is entered; an active ``torch.profiler`` turns spans on as ``loner/<name>``.
- A phase program at tiny widths on the CPU, both benchmark configurations,
  eager and through a graph type that runs on the CPU: every iteration writes
  every layer mark in order, and its device segments tile it; the counters
  follow ``run_dispatches``' schedule at each configuration's k and d.
- Each new reader on a synthetic trace with known marks, kernels, gaps and
  spans gives exact milliseconds, and nothing on a mark-count mismatch.
- On a CUDA card (marked ``cuda``; skipped without one), both one-card cells at
  their size: the marked layers of each traced iteration, with the draws before
  it, sum to its device busy time within 5%, and each device segment, mapped
  onto the host's clock, starts no earlier than its dispatch's enqueue began.
  This file imports neither JAX nor the JAX package:
  ``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling.py -m cuda``.
"""
import collections
import time

import pytest
import torch

from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping.phase_graph import PhaseProgram
from loner_tpu_torch.runtime import profiling
from portbench import harness, layers, portcfg
from portbench.drivers.train_window import Session
from portbench.trace import Trace
from test_torch_dispatch import FakeEvent, HostGraph

torch.set_num_threads(1)

SMALL = {"traffic": {"points_per_slot": 512, "sky_pad": 16},
         "config": {"optimizer": {"n_lidar_samples": 16, "n_samples_per_ray": 32}}}
CONFIGS = ("flagship", "reference")  # (k, d) = (3, 1) and (10, 2)


@pytest.fixture(autouse=True)
def fresh_tracing(monkeypatch):
    """Tracing off, no spans, and the traced counters from zero (the readers
    compare a trace with what was counted while tracing)."""
    monkeypatch.setattr(profiling, "_traced", dict.fromkeys(profiling.COUNTERS, 0))
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


# -- spans ---------------------------------------------------------------------------
def test_spans_nest_with_parents_traces_and_self_time():
    profiling.enable()
    with profiling.span("outer", keyframe=3):
        with profiling.span("inner"):
            time.sleep(0.002)
        with profiling.span("inner"):
            pass
        profiling.record("measured", 10, 25)
    with profiling.span("other"):
        pass
    got = {s.name: s for s in profiling.spans()}
    outer, other = got["outer"], got["other"]
    inner = profiling.spans("inner")
    assert outer.ids == {"keyframe": 3} and outer.parent_id == 0
    assert all(s.parent_id == outer.span_id and s.trace_id == outer.span_id for s in inner)
    assert got["measured"].parent_id == outer.span_id and got["measured"].self_ns == 15
    assert other.trace_id == other.span_id != outer.trace_id
    children = sum(s.end_ns - s.start_ns for s in inner) + 15
    assert outer.self_ns == outer.end_ns - outer.start_ns - children
    assert profiling.totals()["inner"][0] == 2


def test_the_store_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "STORE", 4)
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=4))
    before = profiling.counters()["spans_dropped"]
    for i in range(10):
        profiling.record("s", i, i + 1, always=True, i=i)
    assert [s.ids["i"] for s in profiling.spans()] == [6, 7, 8, 9]
    assert profiling.counters()["spans_dropped"] - before == 6
    assert profiling.totals()["s"] == (10, 10 / 1e9)


def test_tracing_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)
    assert not profiling.tracing()
    site = profiling.span("dispatch.enqueue", i0=0, k=3)
    assert site is profiling.span("phase")  # one shared no-op context
    with site:
        profiling.record("tracker.icp", 0, 1)
    traced = profiling.counters(traced=True)["dispatches"]
    profiling.count("dispatches")
    assert profiling.spans() == [] and profiling.counters(traced=True)["dispatches"] == traced
    with profiling.span("graph.capture", always=True):
        pass
    assert [s.name for s in profiling.spans()] == ["graph.capture"]


def test_an_active_profiler_turns_spans_on_as_loner_ranges():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        with profiling.span("probe"):
            torch.ones(3).add_(1)
    assert not profiling.tracing()
    assert "loner/probe" in {e.name for e in prof.events()}
    assert [s.name for s in profiling.spans()] == ["probe"]


# -- the phase program on the CPU ---------------------------------------------------------
def _session(name: str, graphs: bool, frozen: bool = False, seed: int = 2 ** 31 + 5):
    config = harness.load_json(harness.PKG / "configs" / f"{name}.json")
    traffic = harness.load_json(harness.PKG / "traffic" / "train-w8.json")
    harness.merge(config, SMALL["config"])
    harness.merge(traffic, SMALL["traffic"])
    s = Session(config, traffic, "cpu")
    s.seat(seed)
    if graphs or frozen:
        cfg, field_cfg, phase = portcfg.build(config)
        phase = topt.PhaseSettings(num_iterations=phase.num_iterations, freeze_poses=frozen)
        s.prog = PhaseProgram(cfg, field_cfg, phase, s.w, s.dev, graphs=graphs,
                              graph_class=HostGraph, window=s.local)
    return s


@pytest.mark.parametrize("frozen", [False, True], ids=["poses", "frozen_poses"])
@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "host_graph"])
@pytest.mark.parametrize("name", CONFIGS)
def test_every_iteration_marks_every_layer_in_order(name, graphs, frozen):
    s = _session(name, graphs, frozen)
    n = 5
    profiling.enable()
    s.phase_call(0, n)
    phase = profiling.spans("phase")[-1]
    device = [sp for sp in profiling.spans() if sp.thread == "device"]
    assert len(device) == n * len(profiling.SEGMENTS)
    for it in range(n):
        segs = [sp for sp in device if sp.ids["iteration"] == it]
        assert [sp.name for sp in segs] == [f"device.{x}" for x in profiling.SEGMENTS]
        assert [sp.ids["layer"] for sp in segs] == list(profiling.LAYERS)
        assert all(sp.parent_id == phase.span_id for sp in segs)
        # The segments tile the iteration: each begins where the last ended.
        assert all(a.end_ns == b.start_ns for a, b in zip(segs, segs[1:]))
        assert all(sp.end_ns >= sp.start_ns for sp in segs)
        assert phase.start_ns <= segs[0].start_ns and segs[-1].end_ns <= phase.end_ns
    rows = s.prog.marks.ring[:n].tolist()
    assert all(row == sorted(row) and min(row) > 0 for row in rows)
    names = {sp.name for sp in profiling.spans()}
    assert {"phase.seat", "dispatch.enqueue", "phase.copy_out", "phase.read_marks"} <= names


@pytest.mark.parametrize("name", CONFIGS)
def test_counters_follow_the_dispatch_schedule(name):
    s = _session(name, graphs=True)
    cfg = s.prog.cfg
    k, n = cfg.steps_per_dispatch, 23
    before = profiling.counters()
    s.phase_call(0, n)
    after = profiling.counters()
    delta = {key: after[key] - before[key] for key in profiling.COUNTERS}
    occ = 0
    if cfg.samples_strategy == "OGM":
        occ = sum(1 for i in range(n) if i % cfg.occ_update_every == 0)
    assert (k, cfg.max_inflight_dispatches) == {"flagship": (3, 1), "reference": (10, 2)}[name]
    assert delta["phases"] == 1 and delta["dispatches"] == n // k + n % k
    assert delta["replays.draw"] == n
    assert (delta["replays.step"], delta["replays.step_occ"]) == (n - occ, occ)
    assert delta["captures"] == s.prog.captures == (3 if occ else 2)
    assert len(profiling.spans("graph.capture")) == s.prog.captures  # set-up: always recorded
    assert any(key.startswith("launches.fourier_mlp.") for key in after)


class QueriedEvent(FakeEvent):
    def query(self) -> bool:
        return self.n % 2 == 0  # every other dispatch has ended when waited on


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("traced", [False, True], ids=["off", "tracing"])
def test_dispatch_waits_are_counted_and_queried_only_while_tracing(depth, traced):
    FakeEvent.log = []
    n_iters, k = 14, 3  # four dispatches of 3, then two single steps
    if traced:
        profiling.enable()
    before = profiling.counters()
    topt.run_dispatches(n_iters, k, depth, lambda i0, kk: None, QueriedEvent)
    after = profiling.counters()
    waits = [e[1] for e in FakeEvent.log if e[0] == "wait"]
    assert waits == list(range(4 - depth))
    assert after["dispatches"] - before["dispatches"] == 6
    assert after["dispatch_waits"] - before["dispatch_waits"] == len(waits)
    ready = sum(1 for n in waits if n % 2 == 0) if traced else 0
    assert after["dispatch_waits_ready"] - before["dispatch_waits_ready"] == ready
    assert len(profiling.spans("dispatch.wait")) == (len(waits) if traced else 0)


# -- the readers ----------------------------------------------------------------------------
MARK = "void loner_mark_kernel<{}>(unsigned long long*, long long const*, int, int, int)"
# Per iteration, from its base time b (us): the draws, then each segment's one
# kernel between marks of 1 us. Segment lengths in the order of SEGMENTS.
SEGMENT_US = (2, 10, 30, 10, 2, 20, 1, 40, 1, 10, 50, 6, 20)


def _synthetic_trace(iterations: int = 2):
    kernels = []
    for j in range(iterations):
        t = 1000.0 * j
        kernels.append(("draw_kernel", t, t + 10))
        t += 10
        for i, length in enumerate(SEGMENT_US):
            kernels.append((MARK.format(i), t, t + 1))
            kernels.append((f"work_{i}", t + 1, t + 1 + length))
            t += 1 + length
        kernels.append((MARK.format(len(SEGMENT_US)), t, t + 1))  # end: t + 1 = b + 226
    kernels.append((MARK.format(profiling.ANCHOR), 1226.0, 1227.0))
    kernels.append(("later", 1400.0, 1410.0))
    host = [("loner/phase", -50.0, 1300.0), ("loner/phase.seat", 250.0, 280.0),
            ("loner/dispatch.wait", 300.0, 500.0), ("loner/mesh.wait", 350.0, 450.0),
            ("loner/dispatch.enqueue", 900.0, 1010.0), ("aten::copy_", 260.0, 270.0)]
    return Trace(kernels, host, 1.5e-3)


def _ctx(trace, iterations: int = 2, chips: int = 1):
    return {"trace": trace, "traced_iterations": iterations, "chips": chips, "config": {},
            "traffic": {}}


def _read(name, ctx):
    return harness.load_metric(name).read(ctx)


@pytest.mark.parametrize("name,want_us", [
    ("sampler_ms_per_iter", 10 + 2 + 1 + 1 + 6), ("sigma_field_ms_per_iter", 30 + 50),
    ("composite_loss_ms_per_iter", 10 + 10), ("optimizer_step_ms_per_iter", 2 + 20),
    ("camera_branch_ms_per_iter", 20 + 40)])
def test_layer_readers_on_a_synthetic_trace(name, want_us, monkeypatch):
    monkeypatch.setitem(profiling._traced, "replays.step", 1)
    monkeypatch.setitem(profiling._traced, "replays.step_occ", 1)
    assert _read(name, _ctx(_synthetic_trace())) == pytest.approx(want_us / 1e3, abs=1e-12)
    monkeypatch.setitem(profiling._traced, "replays.step", 2)  # 3 replays, 2 marked
    assert _read(name, _ctx(_synthetic_trace())) is None
    assert _read(name, _ctx(Trace([("work", 0.0, 1.0)], [], 1e-3))) is None


def test_the_partition_sums_to_the_busy_time():
    parts = layers.partition(_synthetic_trace())
    assert parts["iterations"] == 2
    for seg, lead, busy in zip(parts["segments"], parts["between"], parts["busy"]):
        # The marks' own 1 us each are the only busy time left out.
        assert sum(seg) + lead == pytest.approx(busy - len(profiling.MARKS) * 1e-6, abs=1e-12)
    assert parts["between"][1] == pytest.approx(10e-6)  # the second iteration's draws


@pytest.mark.parametrize("name,want_us", [
    # The gaps 226-1000 and 1227-1400: dispatch.wait 300-500 (a mesh.wait inside),
    # dispatch.enqueue 900-1000; the phase and its seat the rest up to 1300, and
    # the edge before the first device operation, -50-0.
    ("dispatch_idle_ms_per_iter", 200 + 100),
    ("phase_seam_idle_ms_per_iter", 50 + 24 + 30 + 20 + 400 + 73),
    ("dispatch_idle_ms_per_iter.mesh4", 300), ("phase_seam_idle_ms_per_iter.mesh4", 597)])
def test_idle_readers_on_a_synthetic_trace(name, want_us, capsys):
    assert _read(name, _ctx(_synthetic_trace())) == pytest.approx(want_us / 2e3, abs=1e-12)
    err = capsys.readouterr().err
    assert "no span 0.0500" in err and "dispatch waits already done" in err
    assert _read(name, _ctx(Trace([("k", 0.0, 1.0), ("k", 5.0, 6.0)], [], 1e-5))) is None


def test_graph_capture_seconds_sum_the_capture_spans():
    assert _read("graph_capture_s", {}) is None
    profiling.record("graph.capture", 0, 1_500_000_000, always=True)
    profiling.record("graph.capture", 0, 500_000_000, always=True)
    assert _read("graph_capture_s", {}) == 2.0


# -- on the card ------------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layer marks' kernel runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_marked_layers_sum_to_each_iteration_on_the_card(name, cuda_device):
    from portbench.trace import traced

    config = harness.load_json(harness.PKG / "configs" / f"{name}.json")
    traffic = harness.load_json(harness.PKG / "traffic" / "train-w8.json")
    s = Session(config, traffic, cuda_device)
    s.seat(2 ** 31 + 11)
    s.warm_up()
    s.phase_call(0)
    n = int(s.phase.num_iterations)
    before = profiling.counters(traced=True)
    tr = traced(lambda: s.phase_call(n), cuda_device)
    after = profiling.counters(traced=True)
    parts = layers.partition(tr)
    replays = sum(after[k] - before[k] for k in ("replays.step", "replays.step_occ"))
    assert parts is not None and parts["iterations"] == replays == n
    for it, (seg, lead, busy) in enumerate(zip(parts["segments"], parts["between"],
                                               parts["busy"])):
        # Lead: the draws (and, before the first, nothing).
        assert abs(sum(seg) + lead - busy) <= 0.05 * busy, (it, seg, lead, busy)
    phase = profiling.spans("phase")[-1]
    enqueues = [sp for sp in profiling.spans("dispatch.enqueue")
                if sp.trace_id == phase.trace_id]
    for sp in profiling.spans():
        if sp.thread != "device" or sp.trace_id != phase.trace_id:
            continue
        it = sp.ids["iteration"]
        enqueue = next(e for e in enqueues if e.ids["i0"] <= it < e.ids["i0"] + e.ids["k"])
        assert sp.start_ns >= enqueue.start_ns, (sp, enqueue)
    ctx = {"trace": tr, "traced_iterations": n, "chips": 1, "config": config,
           "traffic": traffic}
    for metric in ("sampler_ms_per_iter", "sigma_field_ms_per_iter",
                   "composite_loss_ms_per_iter", "optimizer_step_ms_per_iter",
                   "dispatch_idle_ms_per_iter", "phase_seam_idle_ms_per_iter"):
        assert _read(metric, ctx) is not None, metric
