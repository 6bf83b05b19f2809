"""Run one cell of ``BENCHMARK.json`` once and print its result line.

The cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its generator (``drivers/<driver>.py``),
which builds the port's objects, warms them up (set-up), measures for
``--seconds`` and checks what the timed path produced against the plain
reference (``reference/``) under the cell's limits (``limits/<cell>.json``).
With ``--trace 1`` the harness then reads each per-layer metric of the cell with
its reader, ``metrics/<metric>.py`` or, for ``<quantity>.<qualifier>`` without
a file of its own, ``metrics/<quantity>.py`` (``read(ctx) -> float or None``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``) and, last, ``compared``: each number compared with its limit. The
same numbers are the last lines of standard error. No result is printed, and
the exit code is not 0, when the card or the cards the cell asks for are
missing, or when a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names that no run may load: JAX and the JAX package. Compared
# whole: the port, ``loner_tpu_torch``, begins with ``loner_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "loner_tpu")


class Refused(RuntimeError):
    """A run that may print no result (no card, too few cards)."""


@dataclass
class Run:
    """What a driver gets: the cell's entries and files, the run's arguments."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # perf_counter() when the process started its work


@dataclass
class Outcome:
    """What a driver returns. ``metrics``: its end-to-end readings by name;
    ``compared``: (name, value, limit) of the check; ``layer``: what the
    per-layer readers read (``trace`` among it with ``--trace 1``)."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    compared: List[Tuple[str, float, float]]
    layer: Dict[str, Any] = field(default_factory=dict)
    chips: int = 1


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for the ``stream``-th generator of a run of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{int(stream)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def end_to_end_names(spec: dict, cell: str) -> List[str]:
    return [m["name"] for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_names(spec: dict, cell: str) -> List[str]:
    reported = set(end_to_end_names(spec, cell))
    return [m["name"] for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def metric_file(name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py`` where there is
    one, else its quantity's, ``metrics/<quantity>.py``, for a metric
    ``<quantity>.<qualifier>`` (one quantity split by the end-to-end metric it
    moves, as ``step_mfu.mesh4``)."""
    own = PKG / "metrics" / f"{name}.py"
    return own if own.is_file() else PKG / "metrics" / f"{name.split('.')[0]}.py"


def load_metric(name: str):
    """The reader module of a per-layer metric (see ``metric_file``)."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def forbidden_modules() -> List[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def check_cards(chips: int) -> str:
    """The card's name; raises ``Refused`` without ``chips`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA card: this benchmark measures the port on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    return torch.cuda.get_device_name(0)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi not read: {err}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: Optional[str] = None,
             overrides: Optional[Dict[str, dict]] = None,
             t_start: Optional[float] = None, out: Callable[[str], None] = print,
             err: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> dict:
    """Run ``workload`` once; returns the result object (also printed by
    ``out``). ``device`` None asks for the cards the cell names (``Refused``
    without them); the tests pass ``"cpu"`` and shrink the cell with
    ``overrides`` (``{"config": {...}, "traffic": {...}}``, merged key by key)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec()
    cell = find(spec["workloads"], workload, "workload")
    config = load_json(PKG / "configs" / f"{cell['config']}.json")
    traffic = load_json(PKG / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(PKG / "limits" / f"{workload}.json")["limits"]
    for key, target in (("config", config), ("traffic", traffic)):
        merge(target, (overrides or {}).get(key, {}))
    kind = None
    if device is None:
        kind = check_cards(int(cell["chips"]))
        device = "cuda:0"
        err(f"card: {card_line()}")
    run = Run(cell, config, traffic, limits, int(seed), float(seconds), bool(trace), device,
              t_start)
    outcome = load_driver(traffic).drive(run)

    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    result_device: Dict[str, Any] = {
        "platform": "gpu" if kind is not None else "cpu", "kind": kind or "cpu",
        "count": outcome.chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    breakdown = None
    if not trace:
        # A metric "<quantity>.<qualifier>" (the same quantity in cells that need
        # a bound of their own) takes the driver's reading of the quantity.
        for name in end_to_end_names(spec, workload):
            value = outcome.metrics.get(name, outcome.metrics.get(name.split(".")[0]))
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        ctx = dict(outcome.layer, config=config, traffic=traffic, chips=outcome.chips)
        for name in per_layer_names(spec, workload):
            value = load_metric(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        tr = outcome.layer.get("trace")
        if tr is not None:
            result_device["busy_s"] = outcome.layer.get("busy_s", tr.busy_s)
            result_device["window_s"] = tr.window_s
            breakdown = tr.breakdown()

    compared = {name: {"value": value, "limit": limit} for name, value, limit in outcome.compared}
    correct = bool(outcome.compared) and all(
        math.isfinite(value) and value <= limit for _, value, limit in outcome.compared)
    result: Dict[str, Any] = {"correct": correct, "attempted": outcome.attempted,
                              "failed": outcome.failed, "metrics": metrics,
                              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    found = forbidden_modules()
    if found:
        raise Refused("modules of JAX or the JAX package were loaded: " + ", ".join(found))
    tr = outcome.layer.get("trace")
    if tr is not None:
        n = outcome.layer.get("traced_iterations") or 1
        err("device ms an iteration: " + json.dumps(
            [[name, 1e3 * sec / n] for name, sec in tr.top(40, chars=400)]))
    for key in ("setup_marks_s", "window_quarters_rays_per_s", "losses", "leaves",
                "not_compared"):
        if key in outcome.layer:
            err(f"{key}: {json.dumps(outcome.layer[key])}")
    for name, value, limit in outcome.compared:
        err(f"compared {name} {value!r} limit {limit!r}")
    out(json.dumps(result))
    return result


def merge(target: dict, changes: dict) -> None:
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(target.get(key), dict):
            merge(target[key], value)
        else:
            target[key] = value


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except Refused as why:
        print(f"refused: {why}", file=sys.stderr)
        return 2
    return 0
