"""The ``train_window`` phase on a mesh (traffic ``train_mesh``): one NCCL rank a
card, the window's slots sharded over ``mesh_devices`` ranks, one gradient
all-reduce inside the captured iteration (``parallel/mesh.py``).

This process is rank 0: it launches the other ranks (``parallel/mesh.py::
launch``), each a ``Session`` of its own on its card that draws the same window
and start from the seed, and commands them before each of its own calls
(``Commanded``), so every rank runs the same programs in the same order. The
window, the trace and the check are ``train_window.measure``'s, on rank 0:
its returned state is the whole window's (the ranks' summed gradients), and
the plain reference computes the whole window on rank 0's card once the mesh
has stopped. ``memory_peak_bytes`` is the fullest rank's; ``busy_s`` the
ranks' mean over the traced phases, each rank's trace its own.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from portbench.drivers.train_window import Session, measure
from portbench.harness import Outcome, Run


def _gather(mesh, value):
    out = [None] * mesh.spec.size
    dist.all_gather_object(out, value, group=mesh.control)
    return out


def follow(mesh, config: dict, traffic: dict) -> None:
    """A follower rank: rank 0's commands until its stop."""
    s = Session(config, traffic, mesh.device, mesh=mesh)
    while True:
        message = mesh.receive()
        name = message["cmd"]
        if name == "stop":
            return
        result = getattr(s, name)(*message["args"])
        if name == "traced_phases":
            _gather(mesh, result.busy_s)
        elif name == "peak":
            _gather(mesh, result)


FOLLOW = follow  # the followers' entry (a module-level function: it is pickled by name)


class Commanded:
    """Rank 0's ``Session`` under a running mesh: each call of the session is
    sent to the followers first; ``free`` stops the mesh."""

    LOCAL = ("reference_steps",)

    def __init__(self, session: Session, mesh) -> None:
        self.session, self.mesh = session, mesh

    def __getattr__(self, name):
        attr = getattr(self.session, name)
        if not callable(attr) or name in self.LOCAL:
            return attr

        def call(*args):
            if name == "free":
                self.mesh.close()
                return attr()
            self.mesh.send({"cmd": name, "args": args})
            result = attr(*args)
            if name == "traced_phases":
                busy = _gather(self.mesh, result.busy_s)
                self.session.busy_mean_s = sum(busy) / len(busy)
            elif name == "peak":
                result = max(_gather(self.mesh, result))
            return result

        return call


def drive(run: Run) -> Outcome:
    from loner_tpu_torch.parallel.mesh import launch, make_mesh

    n = int(run.traffic["mesh_devices"])
    spec = make_mesh(n, run.device)
    mesh = launch(spec, FOLLOW, (run.config, run.traffic))
    try:
        marks = {"imports_and_mesh": time.perf_counter() - run.t_start}
        session = Commanded(Session(run.config, run.traffic, mesh.device, mesh=mesh), mesh)
        return measure(run, session, marks, chips=n)
    except BaseException:
        mesh.abandon()
        raise
