"""The benchmark's camera cell (``camera-train-w8``) and the camera branch's layer
marks, on the CPU at tiny widths, and on a card (marked ``cuda``).

- The cell through ``harness.run_cell`` at W = 2, 16 LiDAR and 8 camera rays a
  slot, 32 samples and 4 iterations is ``correct`` against
  ``reference/plain_camera.py`` on two seeds; each planted camera fault in the
  reference (the camera loss left out, the SH view encoding left out) makes it
  not ``correct``.
- The plain camera reference loads nothing of the port, JAX or the JAX package.
- ``camera_step_mfu``'s operations at ``configs/camera.json`` against a hand count.
- A camera phase, eager and through a graph type that runs on the CPU, writes
  every layer mark in order in every iteration, and its camera counters count
  the camera rays and points of each iteration; a LiDAR-only phase counts none.
- On a card, at the cell's size: no device operation of the camera branch lies
  outside the camera segments, and the LiDAR layers sum to the flagship's within
  5%. ``python3 -m pytest --noconftest -p no:cacheprovider
  tests/test_torch_camera_cell.py -m cuda`` (this file imports neither JAX nor
  the JAX package).
"""
import ast
import collections
import json
import os
import subprocess
import sys

import pytest
import torch

from loner_tpu_torch.mapping.phase_graph import PhaseProgram
from loner_tpu_torch.runtime import profiling
from portbench import costs, costs_camera, harness, layers, portcfg
from portbench.drivers.train_window import Session
from portbench.drivers.train_window_camera import CameraSession
from test_torch_dispatch import HostGraph

CELL = "camera-train-w8"
TINY = {"traffic": {"window": 2, "points_per_slot": 512, "sky_pad": 16},
        "config": {"optimizer": {"n_lidar_samples": 16, "n_camera_samples": 8,
                                 "n_samples_per_ray": 32},
                   "phase": {"num_iterations": 4}}}
SEEDS = (2 ** 31 + 23, 3_000_000_017)


@pytest.fixture(autouse=True)
def fresh_tracing(monkeypatch):
    monkeypatch.setattr(profiling, "_traced", dict.fromkeys(profiling.COUNTERS, 0))
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


# A run in a process of its own: this suite's process holds JAX, and a run that
# finds a module of JAX loaded prints no result. ``fault`` plants one of
# ``control_camera.planted``'s faults in the reference.
RUN = """
import json, sys
from portbench import control_camera, harness
from portbench.drivers.train_window_camera import CameraSession
seed, fault, tiny = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
if fault:
    original = CameraSession.reference_steps

    def planted(self, *args, **kwargs):
        with control_camera.planted(fault, self):
            return original(self, *args, **kwargs)

    CameraSession.reference_steps = planted
harness.run_cell("camera-train-w8", seed, 0.01, False, device="cpu", overrides=tiny,
                 err=lambda s: None)
"""


def run(seed: int, fault: str = "") -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, str(seed), fault, json.dumps(TINY)],
                         cwd=str(harness.ROOT), capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# -- the cell ------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_the_cell_is_correct_against_the_plain_camera_reference(seed):
    result = run(seed)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["compared"]) == {"loss_gap", "grad_gap", "change_gap",
                                       "median_change_gap", "camera_loss_gap"}
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["camera_loss_dropped", "sh_dropped"])
def test_a_planted_camera_fault_is_not_correct(fault):
    assert run(SEEDS[0], fault)["correct"] is False


def test_the_intensity_leaves_are_compared():
    config, traffic = _files()
    s = CameraSession(config, traffic, "cpu")
    s.seat(SEEDS[1])
    program = s.program_steps(harness.subseed(SEEDS[1], 1), 2)
    intensity = {k for k in program["end"] if k.startswith("intensity.")}
    assert intensity == {"intensity.w0", "intensity.w1", "intensity.w2"}
    assert intensity <= set(program["grads"]) and intensity <= set(program["start"])
    assert all(float(program["grads"][k].abs().sum()) > 0 for k in intensity)
    assert len(program["camera_losses"]) == 2


def test_the_plain_camera_reference_loads_nothing_of_the_port_or_jax():
    path = harness.PKG / "reference" / "plain_camera.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not {n.split(".")[0] for n in names} & {"loner_tpu_torch", "loner_tpu", "jax"}
    code = ("import json, sys\nfrom portbench.reference import plain_camera\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'loner_tpu_torch', 'loner_tpu', 'jax', 'jaxlib', 'flax'})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# -- the yardstick -------------------------------------------------------------------------
def test_camera_step_mfu_counts_the_camera_branch():
    config = harness.load_json(harness.PKG / "configs" / "camera.json")
    traffic = harness.load_json(harness.PKG / "traffic" / "train-w8-camera.json")
    n_c = 8 * 128 * 512  # camera points an iteration
    assert costs_camera.intensity_dims(config["field"]) == [99 + 16, 128, 128, 3]
    assert costs_camera.intensity_macs(config["field"]) == 31_488
    sigma = 6 * n_c * (99 * 256 + 256 * 256 + 256)  # the camera loss reaches the sigma field
    head = 6 * n_c * 31_488
    encodes = 2 * 6 * 48 * n_c  # forward only: the poses are detached
    proposal = (2 * 6400 + 6 * 16) * 8 * 128 * 33  # forward at the control points
    lidar = 1_160_453_160_960  # the flagship's iteration (portbench/tests/test_bench_costs.py)
    assert costs.flops_per_iteration(config, traffic) == lidar
    total = lidar + sigma + head + encodes + proposal
    assert costs_camera.flops_per_iteration(config, traffic) == total == 1_546_932_682_752
    ctx = {"config": config, "traffic": traffic, "chips": 1, "iteration_s": 0.02}
    assert harness.load_metric("camera_step_mfu").read(ctx) == pytest.approx(
        100 * total / (0.02 * 989e12))
    flagship = harness.load_json(harness.PKG / "configs" / "flagship.json")
    assert harness.load_metric("camera_step_mfu").read(dict(ctx, config=flagship)) is None


def test_the_camera_reader_reads_nothing_without_the_layer(monkeypatch):
    ctx = {"trace": object(), "traced_iterations": 1}
    monkeypatch.setattr(profiling, "LAYERS", tuple(x for x in profiling.LAYERS
                                                   if x != profiling.CAMERA_BRANCH))
    assert harness.load_metric("camera_branch_ms_per_iter").read(ctx) is None
    assert harness.load_metric("camera_branch_ms_per_iter").read({}) is None


# -- the marks and counters on the CPU ---------------------------------------------------------
def _files():
    config = harness.load_json(harness.PKG / "configs" / "camera.json")
    traffic = harness.load_json(harness.PKG / "traffic" / "train-w8-camera.json")
    harness.merge(config, TINY["config"])
    harness.merge(traffic, TINY["traffic"])
    return config, traffic


def _camera_session(graphs: bool, seed: int = SEEDS[0]) -> CameraSession:
    config, traffic = _files()
    s = CameraSession(config, traffic, "cpu")
    s.seat(seed)
    if graphs:
        cfg, field_cfg, phase = portcfg.build(config)
        s.prog = PhaseProgram(cfg, field_cfg, phase, s.w, s.dev, graphs=True,
                              graph_class=HostGraph, window=s.local, camera=s.camera)
    return s


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "host_graph"])
def test_every_camera_iteration_marks_every_layer_in_order(graphs):
    s = _camera_session(graphs)
    n = 5
    if graphs:
        s.warm_up()
    before = profiling.counters()
    profiling.enable()
    s.phase_call(0, n)
    after = profiling.counters()
    phase = profiling.spans("phase")[-1]
    device = [sp for sp in profiling.spans() if sp.thread == "device"]
    assert len(device) == n * len(profiling.SEGMENTS)
    for it in range(n):
        segs = [sp for sp in device if sp.ids["iteration"] == it]
        assert [sp.name for sp in segs] == [f"device.{x}" for x in profiling.SEGMENTS]
        assert [sp.ids["layer"] for sp in segs] == list(profiling.LAYERS)
        assert all(sp.parent_id == phase.span_id for sp in segs)
        assert all(a.end_ns == b.start_ns for a, b in zip(segs, segs[1:]))
        camera = [sp for sp in segs if sp.ids["layer"] == profiling.CAMERA_BRANCH]
        assert [sp.name for sp in camera] == ["device.camera", "device.camera.bwd"]
        assert all(sp.end_ns > sp.start_ns for sp in camera)
    rows = s.prog.marks.ring[:n].tolist()
    assert all(row == sorted(row) and min(row) > 0 for row in rows)
    rays = 2 * 8
    assert after["camera.rays"] - before["camera.rays"] == n * rays
    assert after["camera.points"] - before["camera.points"] == n * rays * 32


def test_a_lidar_only_phase_counts_no_camera_rays():
    config = harness.load_json(harness.PKG / "configs" / "flagship.json")
    traffic = harness.load_json(harness.PKG / "traffic" / "train-w8.json")
    harness.merge(config, {"optimizer": {"n_lidar_samples": 16, "n_samples_per_ray": 32}})
    harness.merge(traffic, {"window": 2, "points_per_slot": 512, "sky_pad": 16})
    s = Session(config, traffic, "cpu")
    s.seat(SEEDS[0])
    before = profiling.counters()
    profiling.enable()
    s.phase_call(0, 3)
    after = profiling.counters()
    assert after["camera.rays"] == before["camera.rays"]
    assert after["camera.points"] == before["camera.points"]
    assert after["phases"] == before["phases"] + 1
    # The camera marks fire back to back: four marks, its segments in order.
    rows = s.prog.marks.ring[:3].tolist()
    assert all(row == sorted(row) and min(row) > 0 for row in rows)


def test_the_camera_copy_is_a_phase_seam_span():
    s = _camera_session(False)
    other = s.camera.__class__(*(getattr(s.camera, f).clone()
                                 for f in ("cam_dirs", "intensities", "has_image",
                                           "lidar_to_camera")))
    profiling.enable()
    s.prog(*s.state, *s.common, 0, s.gen, num_iterations=1, camera=other)
    copy = profiling.spans("phase.camera_copy")
    assert len(copy) == 1 and layers.is_phase_seam(copy[0].name)
    seat = profiling.spans("phase.seat")[-1]
    assert copy[0].parent_id == seat.span_id


# -- on the card ---------------------------------------------------------------------------------
@pytest.mark.cuda
def test_the_camera_branch_stays_in_its_segments_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layer marks' kernel runs only there")
    from portbench.trace import traced

    dev = torch.device("cuda", 0)
    parts = {}
    for name, make in (
            ("flagship", lambda c, t: Session(c, t, dev)),
            ("camera", lambda c, t: CameraSession(c, t, dev))):
        traffic_name = "train-w8-camera" if name == "camera" else "train-w8"
        config = harness.load_json(harness.PKG / "configs" / f"{name}.json")
        traffic = harness.load_json(harness.PKG / "traffic" / f"{traffic_name}.json")
        s = make(config, traffic)
        s.seat(2 ** 31 + 29)
        s.warm_up()
        s.phase_call(0)
        n = int(s.phase.num_iterations)
        tr = traced(lambda: s.phase_call(n), dev)
        parts[name] = (layers.partition(tr), tr, n)
        s.free()
    (flag, flag_tr, n_f), (cam, cam_tr, n_c) = parts["flagship"], parts["camera"]
    # The profiler's trace may lose an operation now and then, and with a mark
    # its iteration: the counts below are means over the iterations found whole.
    assert flag["iterations"] >= 0.9 * n_f and cam["iterations"] >= 0.9 * n_c, (
        flag["iterations"], n_f, cam["iterations"], n_c)
    camera_segments = [i for i, layer in enumerate(profiling.LAYERS)
                       if layer == profiling.CAMERA_BRANCH]
    lidar = [x for x in profiling.LAYERS if x != profiling.CAMERA_BRANCH]

    def kind(name: str) -> str:
        # A graph's copy node runs as the copy engine's "Memcpy DtoD" or as the
        # driver's copy kernels ("memcpy128", "memcpy32_post"), by where the pool
        # put its buffers: one kind of operation.
        return "memcpy" if "memcpy" in name.lower() else name[:90]

    def ops_per_segment(tr):
        """The kinds of the device operations (other than marks) in each
        segment, counted over the traced iterations, and the iterations."""
        its = layers.iterations(tr, len(profiling.MARKS))
        out = [collections.Counter() for _ in profiling.SEGMENTS]
        for marks in its:
            for i in range(len(profiling.SEGMENTS)):
                out[i].update(kind(k) for k, s, _ in tr.kernels
                              if marks[i][1] <= s < marks[i + 1][0] and layers.MARK.search(k) is None)
        return out, len(its)

    (flag_ops, n_flag), (cam_ops, n_cam) = ops_per_segment(flag_tr), ops_per_segment(cam_tr)
    # The flagship runs nothing in the camera segments.
    assert all(not flag_ops[i] for i in camera_segments), [flag_ops[i] for i in camera_segments]
    # Outside them the camera cell launches, an iteration, what the flagship does,
    # but in the LiDAR field's backward: there each sigma leaf's two gradients are
    # added (one elementwise add a leaf), and the sum is taken as the leaf's
    # gradient where the flagship's may be copied. Adam steps the intensity head in
    # the optimizer step.
    sigma_leaves = 6
    apart = {}
    for i, name in enumerate(profiling.SEGMENTS):
        if i in camera_segments or name == "optimizer":
            continue
        want = {k: v / n_flag for k, v in flag_ops[i].items()}
        got = {k: v / n_cam for k, v in cam_ops[i].items()}
        extra = {k: got.get(k, 0) - want.get(k, 0) for k in set(got) | set(want)
                 if got.get(k, 0) != want.get(k, 0)}
        if name == "field.bwd":
            sound = (all("elementwise" in k or k == "memcpy" for k in extra)
                     and sum(v for v in extra.values() if v > 0) <= sigma_leaves
                     and -sum(v for v in extra.values() if v < 0) <= sigma_leaves)
        else:
            sound = not extra
        if not sound:
            apart[name] = extra
    assert not apart, apart
    flag_ms = sum(flag["layers"][x] for x in set(lidar)) / flag["iterations"]
    cam_ms = sum(cam["layers"][x] for x in set(lidar)) / cam["iterations"]
    assert abs(cam_ms - flag_ms) <= 0.05 * flag_ms, (cam_ms, flag_ms)
    assert cam["layers"][profiling.CAMERA_BRANCH] / cam["iterations"] > 0.4 * flag_ms
