"""The numbers that decide a training cell's ``correct``.

Both sides give, for the same start and the same draws: the mapping loss of
each of the first steps, each leaf's first gradient (the program's worked out
from Adam's first moment after one step: ``exp_avg / (1 - beta1)``) and each
leaf's value after the steps. Each number is a gap of norms taken by the worst
leaf, never the norm of a difference, against the reference's norm of that leaf
or of the median leaf, whichever is larger:

* ``loss_gap``: the largest |program - reference| / |reference| over the steps;
* ``grad_gap``: over the leaves, | |g_p| - |g_r| | / max(|g_r|, median |g_r|);
* ``change_gap``: the same of each leaf's change over the steps, leaving out the
  leaves whose reference gradient is under a thousandth of the median leaf's
  (Adam moves those by round-off alone);
* ``median_change_gap``: the median leaf's of those change gaps. Adam moves
  every element by about its rate whatever the size of its gradient, so an
  element whose gradient is near zero, and whose sign the two sides' summation
  orders flip, ends two steps apart: a small leaf (the 48 pose-twist values)
  can read a worst gap of ~1e-3 on a sound run, where the median leaf stays
  near 1e-5. The two catch different faults: one leaf left unmoved (the pose
  step dropped) reads its full change by the worst leaf and hardly moves the
  median; a small error in every leaf moves the median first.

A cell's ``limits/<cell>.json`` says which of them it compares.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

QUIET = 1e-3  # a leaf whose gradient is under this share of the median leaf's


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def readings(program: dict, reference: dict) -> List[Tuple[str, float]]:
    """``program`` and ``reference``: {"losses": [...], "grads": {leaf: tensor},
    "start": {leaf: tensor}, "end": {leaf: tensor}}; the leaves of ``start`` and
    ``end`` also include those trained without a gradient leaf of Adam (the OGM
    grid)."""
    lp, lr = program["losses"], reference["losses"]
    if len(lp) != len(lr):
        raise ValueError(f"{len(lp)} program losses, {len(lr)} reference losses")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))

    # The OGM grid's gradient (the reference's, from its SGD step) serves only the
    # rule that leaves quiet leaves out; Adam's leaves are compared.
    g_all = {k: norm(v) for k, v in reference["grads"].items()}
    g_ref = {k: g_all[k] for k in program["grads"] if k != "grid"}
    g_prog = {k: norm(program["grads"][k]) for k in g_ref}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)

    moved = [k for k in reference["end"] if g_all.get(k, g_med) >= QUIET * g_med]
    c_ref = {k: norm(reference["end"][k] - reference["start"][k]) for k in moved}
    c_prog = {k: norm(program["end"][k] - program["start"][k]) for k in moved}
    c_med = statistics.median(c_ref.values())
    change = [abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved]
    return [("loss_gap", loss_gap), ("grad_gap", grad_gap), ("change_gap", max(change)),
            ("median_change_gap", statistics.median(change))]


def leaf_readings(program: dict, reference: dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gradient and change norms on both sides (for the records)."""
    out = {}
    for k in reference["end"]:
        out[k] = {
            "grad_ref": norm(reference["grads"][k]) if k in reference["grads"] else None,
            "grad_prog": norm(program["grads"][k]) if k in program["grads"] else None,
            "change_ref": norm(reference["end"][k] - reference["start"][k]),
            "change_prog": norm(program["end"][k] - program["start"][k]),
        }
    return out
