"""Readings that set the camera cell's limits, on the card, in one process.

    python -m portbench.control_camera --workload camera-train-w8 --first <seed>
        --seeds 6 [--controls 6] [--faults half_batch,sigma_offset,camera_loss_dropped,sh_dropped]
        [--out <file.json>]

``control.py``'s readings for a cell of the ``train_window_camera`` driver: for
each seed, at the cell's own sizes, the port's first steps through the timed
call against ``reference/plain_camera.py`` (the lower readings, with
``camera_loss_gap``), and on the first ``--controls`` seeds the control (the
reference one precision step below the configuration's) and each planted fault,
the reference with the fault in the program's place: ``control.py``'s
``half_batch`` and ``sigma_offset``, and

* ``camera_loss_dropped``: the camera loss left out of the loss
  (``cameraloss_lambda`` 0; the camera MSE is still recorded);
* ``sh_dropped``: the intensity head's SH view encoding left out (zeros).

Prints one JSON line a seed and, with ``--out``, writes them all. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time

import torch

from portbench import control, harness
from portbench.drivers.train_window import synchronize
from portbench.drivers.train_window_camera import CameraSession, camera_loss_gap
from portbench.reference import compare, plain_camera

FAULTS = ("half_batch", "sigma_offset", "camera_loss_dropped", "sh_dropped")


@contextlib.contextmanager
def planted(fault: str, session: CameraSession):
    """The session's reference with ``fault`` in place."""
    if fault == "camera_loss_dropped":
        config = session.config
        session.config = copy.deepcopy(config)
        session.config["optimizer"]["cameraloss_lambda"] = 0.0
        try:
            yield
        finally:
            session.config = config
    elif fault == "sh_dropped":
        original = plain_camera.sh_encode
        plain_camera.sh_encode = lambda d, degree: torch.zeros(
            d.shape[:-1] + (degree * degree,), dtype=d.dtype, device=d.device)
        try:
            yield
        finally:
            plain_camera.sh_encode = original
    else:
        with control.planted(fault):
            yield


def readings(program: dict, reference: dict) -> dict:
    out = dict(compare.readings(program, reference))
    out["camera_loss_gap"] = camera_loss_gap(program["camera_losses"], reference["camera_losses"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="camera-train-w8")
    parser.add_argument("--first", type=int, required=True)
    parser.add_argument("--seeds", type=int, default=6)
    parser.add_argument("--controls", type=int, default=6)
    parser.add_argument("--faults", default=",".join(FAULTS))
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    harness.check_cards(int(cell["chips"]))
    print(f"card: {harness.card_line()}", flush=True)
    config = harness.load_json(harness.PKG / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.PKG / "traffic" / f"{cell['traffic']}.json")
    n = int(traffic["check_steps"])
    faults = [f for f in args.faults.split(",") if f]
    s = CameraSession(config, traffic, "cuda:0")
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
        rec = {"seed": seed, "program": readings(program, reference),
               "leaves": compare.leaf_readings(program, reference),
               "losses": {"program": program["losses"], "reference": reference["losses"],
                          "camera_program": program["camera_losses"],
                          "camera_reference": reference["camera_losses"]}}
        if i < args.controls:
            control_run = s.reference_steps(draw_seed, n, lower=True)
            rec["control"] = readings(control_run, reference)
            rec["control_leaves"] = compare.leaf_readings(control_run, reference)
            for fault in faults:
                with planted(fault, s):
                    faulty = s.reference_steps(draw_seed, n)
                rec[fault] = readings(faulty, reference)
                rec[f"{fault}_leaves"] = compare.leaf_readings(faulty, reference)
        rec["seconds"] = time.perf_counter() - t0
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(records, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
