"""Readings that set a training cell's limits, on the card, in one process.

    python -m portbench.control --workload <cell> --first <seed> --seeds 12
        [--controls 3] [--faults half_batch,sigma_offset] [--out <file.json>]

For each of ``--seeds`` seeds from ``--first`` on, at the cell's own sizes: the
port's first steps through the timed call against the plain reference (the
lower readings); on the first ``--controls`` seeds also the control, the
reference computed one precision step below the configuration's
(``reference/plain.py``, ``lower=True``), and each planted fault, the reference
with the fault in the program's place:

* ``half_batch``: half of each iteration's rays left out (marked invalid), the
  means taken over the rest;
* ``sigma_offset``: the field's answer altered where it is produced, raw sigma
  plus ``SIGMA_OFFSET`` at every point.

(A step that returns its state unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition, with no run.) A mesh cell's program runs on
its ranks (``drivers/train_mesh.py``); ``--drop-exchange`` plants the mesh's
fault in the program itself: every rank leaves the all-reduce out. Prints one
JSON line a seed and, with ``--out``, writes them all. The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import harness
from portbench.drivers import train_mesh
from portbench.drivers.train_window import Session, synchronize
from portbench.reference import compare, plain

SIGMA_OFFSET = 0.01


@contextlib.contextmanager
def planted(fault: str):
    """The reference with ``fault`` in place."""
    if fault == "half_batch":
        original = plain.build_rays

        def build(*args, **kwargs):
            rays, depths, valid = original(*args, **kwargs)
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
            return rays, depths, valid

        plain.build_rays = build
        try:
            yield
        finally:
            plain.build_rays = original
    elif fault == "sigma_offset":
        original = plain.sigma_field
        plain.sigma_field = lambda *a, **k: original(*a, **k) + SIGMA_OFFSET
        try:
            yield
        finally:
            plain.sigma_field = original
    else:
        raise ValueError(f"unknown fault {fault!r}")


def drop_exchange() -> None:
    from loner_tpu_torch.parallel.mesh import Mesh

    Mesh.all_reduce_ = lambda self, t: t


def follow_without_exchange(mesh, config: dict, traffic: dict) -> None:
    drop_exchange()
    train_mesh.follow(mesh, config, traffic)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--first", type=int, required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", default="half_batch,sigma_offset")
    parser.add_argument("--out", default=None)
    parser.add_argument("--drop-exchange", action="store_true",
                        help="a mesh cell: every rank leaves the all-reduce out")
    args = parser.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    harness.check_cards(int(cell["chips"]))
    print(f"card: {harness.card_line()}", flush=True)
    config = harness.load_json(harness.PKG / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.PKG / "traffic" / f"{cell['traffic']}.json")
    n = int(traffic["check_steps"])
    faults = [f for f in args.faults.split(",") if f]
    mesh = None
    if traffic["driver"] == "train_mesh":
        from loner_tpu_torch.parallel.mesh import launch, make_mesh

        follower = train_mesh.follow
        if args.drop_exchange:
            drop_exchange()
            follower = follow_without_exchange
        mesh = launch(make_mesh(int(traffic["mesh_devices"]), "cuda:0"), follower,
                      (config, traffic))
        s = train_mesh.Commanded(Session(config, traffic, mesh.device, mesh=mesh), mesh)
    else:
        s = Session(config, traffic, "cuda:0")
    records = []
    for i in range(args.seeds):
        seed = args.first + i
        t0 = time.perf_counter()
        s.seat(seed)
        if i == 0:
            s.warm_up()
        draw_seed = harness.subseed(seed, 1)
        program = s.program_steps(draw_seed, n)
        synchronize(s.dev)
        reference = s.reference_steps(draw_seed, n)
        rec = {"seed": seed, "program": dict(compare.readings(program, reference)),
               "leaves": compare.leaf_readings(program, reference),
               "losses": {"program": program["losses"], "reference": reference["losses"]}}
        if i < args.controls:
            control = s.reference_steps(draw_seed, n, lower=True)
            rec["control"] = dict(compare.readings(control, reference))
            rec["control_leaves"] = compare.leaf_readings(control, reference)
            rec["control_losses"] = control["losses"]
            for fault in faults:
                with planted(fault):
                    faulty = s.reference_steps(draw_seed, n)
                rec[fault] = dict(compare.readings(faulty, reference))
                rec[f"{fault}_leaves"] = compare.leaf_readings(faulty, reference)
        rec["seconds"] = time.perf_counter() - t0
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if mesh is not None:
        mesh.close()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(records, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
