"""Whole runs of each cell on the CPU at tiny sizes: a sound run is correct; a
run with the timed path broken underneath is not; a run without a card prints
no result."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.drivers import train_mesh
from portbench.drivers.train_window import Session
from portbench.reference import compare
from portbench.tests.conftest import SMALL

SPEC = harness.load_spec()
ONE_CHIP = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]
MESH = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]
SEED = 2 ** 31 + 777  # past 32 signed bits: seeds of a run may be


def run(cell: str, seed: int = SEED) -> dict:
    lines = []
    return harness.run_cell(cell, seed, 0.01, False, device="cpu", overrides=SMALL,
                            out=lambda s: None, err=lines.append)


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", ONE_CHIP[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=str(harness.ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == set(harness.end_to_end_names(SPEC, cell))
    assert list(result)[-1] == "compared"


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from loner_tpu_torch.mapping import optimizer

    original = optimizer.sample_and_build_rays

    def half(*args, **kwargs):
        rays, depths, valid = original(*args, **kwargs)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return rays, depths, valid

    monkeypatch.setattr(optimizer, "sample_and_build_rays", half)


def _altered(monkeypatch):
    from loner_tpu_torch.models import field

    original = field.query_field
    monkeypatch.setattr(field, "query_field", lambda *a, **k: original(*a, **k) + 0.01)


def _pose_step_dropped(monkeypatch):
    """Adam builds every moment, the twists' too, but the pose step is never
    applied: the twists come back as they went in."""
    original = torch.optim.Adam.step

    def step(self, closure=None):
        twists = [p for g in self.param_groups for p in g["params"]
                  if p.dim() == 2 and p.shape[-1] == 6]
        before = [p.detach().clone() for p in twists]
        out = original(self, closure)
        with torch.no_grad():
            for p, b in zip(twists, before):
                p.copy_(b)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", step)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch, "answer_altered": _altered,
          "pose_step_dropped": _pose_step_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert run(cell)["correct"] is False


def follow_without_exchange(mesh, config, traffic):
    """A follower whose mesh leaves the exchange out (every all-reduce a no-op)."""
    from loner_tpu_torch.parallel.mesh import Mesh

    Mesh.all_reduce_ = lambda self, t: t
    train_mesh.follow(mesh, config, traffic)


@pytest.mark.parametrize("cell", MESH)
def test_a_mesh_run_is_correct_and_not_without_its_exchange(cell, monkeypatch):
    assert run(cell)["correct"] is True
    from loner_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(Mesh, "all_reduce_", lambda self, t: t)
    monkeypatch.setattr(train_mesh, "FOLLOW", follow_without_exchange)
    assert run(cell)["correct"] is False


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_control_fails_a_number(cell):
    """The reference one precision step below the configuration's, in the
    program's place, fails at least one of the cell's limits."""
    entry = harness.find(SPEC["workloads"], cell, "workload")
    config = harness.load_json(harness.PKG / "configs" / f"{entry['config']}.json")
    traffic = harness.load_json(harness.PKG / "traffic" / f"{entry['traffic']}.json")
    harness.merge(config, SMALL["config"])
    harness.merge(traffic, SMALL["traffic"])
    limits = harness.load_json(harness.PKG / "limits" / f"{cell}.json")["limits"]
    s = Session(config, traffic, "cpu")
    s.seat(SEED)
    reference = s.reference_steps(5, 3)
    control = s.reference_steps(5, 3, lower=True)
    numbers = dict(compare.readings(control, reference))
    assert any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_the_control_fails_at_the_cells_size(cell, cuda_card, tmp_path):
    """On the card, at the cell's own size, on three seeds: the program passes
    every limit and the control fails one."""
    from portbench import control

    out = tmp_path / "readings.json"
    control.main(["--workload", cell, "--first", str(SEED), "--seeds", "3", "--controls", "3",
                  "--faults", "", "--out", str(out)])
    limits = harness.load_json(harness.PKG / "limits" / f"{cell}.json")["limits"]
    for record in json.loads(out.read_text()):
        assert all(record["program"][k] <= v for k, v in limits.items()), record["program"]
        assert any(record["control"][k] > v for k, v in limits.items()), record["control"]


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """Only ``BENCHMARK.json`` and ``portbench/``: the port is missing, so a run
    fails and prints nothing on standard output."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("from portbench.harness import run_cell; from portbench.tests_small import SMALL; "
            f"run_cell({ONE_CHIP[0]!r}, 1, 0.01, False, device='cpu', overrides=SMALL)")
    (tmp_path / "portbench" / "tests_small.py").write_text(f"SMALL = {SMALL!r}\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "loner_tpu_torch" in out.stderr
