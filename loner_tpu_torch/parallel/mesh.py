"""Multi-device mapping over ``torch.distributed``: the keyframe-slot mesh and its
ray axis.

Counterpart of ``loner_tpu/parallel/mesh.py``. The JAX package places the window
buffers on a device mesh and lets GSPMD split the iteration: ``make_mesh(n)``
shards the keyframe-window slots over n devices, ``make_mesh_2d(n_kf, n_ray)``
also shards each slot's point buffer over a ``ray`` axis, and the gradients of
the replicated state are all-reduced. Here each rank is one process on one
device, and the program says where the collectives go:

- **Processes.** Rank 0 is the process that builds the ``Optimizer`` (the SLAM
  run's mapper); ``launch`` spawns ranks 1..N-1 (the ``spawn`` start method:
  CUDA cannot fork), each running an ``Optimizer`` replica on its own device that
  mirrors rank 0's commands (``Optimizer.serve``). Ranks join one process group
  at ``tcp://127.0.0.1:<free port>``: NCCL when every rank has its own card, gloo
  on the CPU or when ranks share a card (NCCL refuses two ranks on one card).
  Commands go over a gloo group of their own, with a long timeout (a follower
  waits there between keyframes); tensors over the device group.
- **Shards.** Rank r is (kf, ray) = divmod(r, n_ray). It owns window slots
  ``[kf W / n_kf, (kf + 1) W / n_kf)`` and, on the ray axis, points
  ``[ray P / n_ray, (ray + 1) P / n_ray)`` of those slots' buffers
  (``shard_window_buffers``); counts, sky directions and slot validity are per
  slot and whole. Parameters, the OGM grid or proposal, twists and pose masks
  are replicated: rank 0 broadcasts them (``replicate``) at construction and at
  ``restore``.
- **One iteration** (``WindowShard``): every rank draws the whole window's
  draws from the same seeded generator and takes its rows, so each ray sees the
  numbers it sees on one device. Ray indices are global; on the ray axis each
  rank gathers the indices it holds, zeroes the rest, and a sum over its ray
  group assembles the sampled points (GSPMD's cross-shard gather), which the
  group then splits for the compute. Every mean the loss takes over the window
  divides by the window's count, all-reduced once an iteration, so each rank's
  loss is its share of the one-device loss and the summed gradients are the
  one-device gradients. One flat all-reduce carries every gradient (and, in an
  OGM-step iteration, the grid's) with the loss record; every rank then takes
  the same masked Adam step.

On the card every collective of the iteration is captured in its CUDA graph; the
process group is warmed up by an eager collective at join and by the eager
warm-up iterations before any capture, and every rank captures the same programs
in the same order. A follower that exits makes rank 0 raise, naming it, at its
next command (``check_followers``) or while it waits for its device
(``Mesh.wait``: a collective replayed in a graph has no watchdog); gloo's eager
collectives raise at once, NCCL's after the group's timeout. Nothing drops to
one device on its own.

The teardown (``Mesh.leave``) is the same on every rank, after rank 0's stop:
release the graphs that captured the mesh's collectives (NCCL keeps a
communicator until each such graph is destroyed, and a rank that destroys its
group with one alive waits for ever), synchronize, a barrier on the control
group, then leave the device groups and the control group. Every wait in it is
bounded and raises naming the rank; only a mesh with a rank known gone or stuck
is aborted (``Mesh.abandon``).
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import multiprocessing
import os
import socket
import sys
import threading
import time
import traceback
import weakref
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from loner_tpu_torch.mapping.rays import CameraWindowBuffers, WindowBuffers
from loner_tpu_torch.runtime import profiling

DATA_AXIS = "data"
RAY_AXIS = "ray"
CONTROL_TIMEOUT = timedelta(days=1)
# A collective waits this long for the other ranks (the rendezvous, too); a
# capture or a kernel build on one rank is the longest wait in a healthy run.
COLLECTIVE_TIMEOUT = timedelta(seconds=300)
JOIN_SECONDS = 30.0  # a follower that is killed is waited for no longer
# Each wait of the teardown (``Mesh.leave``): the barrier, leaving the groups,
# rank 0's wait for the followers to exit. A healthy teardown takes about a
# second (PERF.md).
TEARDOWN_SECONDS = 60.0
POLL_SECONDS = 2e-4  # rank 0's poll of its device while it watches the followers

# Draws with one row per window slot; the rest have one row per ray.
SLOT_DRAWS = ("ray_u", "sky_u", "cam_u")
LIDAR_DRAWS = ("jitter", "noise", "pdf_u")
CAMERA_DRAWS = ("cam_jitter", "cam_pdf_u")


@dataclass(frozen=True)
class MeshSpec:
    """A mesh before it runs: its axes, each rank's device and the backend."""

    n_kf: int
    n_ray: int
    devices: Tuple[str, ...]
    backend: str
    two_axes: bool = False

    @property
    def size(self) -> int:
        return self.n_kf * self.n_ray

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (DATA_AXIS, RAY_AXIS) if self.two_axes else (DATA_AXIS,)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n_kf, self.n_ray) if self.two_axes else (self.n_kf,)


def _rank_devices(n: int, device, devices: Optional[Sequence]) -> Tuple[str, ...]:
    if devices is not None:
        out = tuple(str(torch.device(d)) for d in devices)
        if len(out) != n:
            raise ValueError(f"{len(out)} devices for a mesh of {n} ranks")
        return out
    device = torch.device(device)
    if device.type == "cpu":
        return ("cpu",) * n
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {device}")
    base, count = device.index or 0, torch.cuda.device_count()
    if base + n > count:
        raise ValueError(f"a mesh of {n} ranks from {device} needs cards {base}..{base + n - 1}; "
                         f"this machine has {count}")
    return tuple(f"cuda:{base + r}" for r in range(n))


def _spec(n_kf: int, n_ray: int, two_axes: bool, device, devices) -> MeshSpec:
    if n_kf < 1 or n_ray < 1:
        raise ValueError(f"mesh axes must be positive, got ({n_kf}, {n_ray})")
    devs = _rank_devices(n_kf * n_ray, device, devices)
    # NCCL refuses two ranks on one card; gloo carries the CPU and shared cards.
    on_own_cards = all(d.startswith("cuda") for d in devs) and len(set(devs)) == len(devs)
    return MeshSpec(n_kf, n_ray, devs, "nccl" if on_own_cards else "gloo", two_axes)


def make_mesh(n_devices: int, device="cuda", devices: Optional[Sequence] = None) -> MeshSpec:
    """A 1-D mesh of ``n_devices`` ranks over the keyframe-window slots: rank r
    on ``device``'s index + r (the CPU: every rank), or on ``devices[r]``; NCCL
    when each rank has a card of its own, else gloo."""
    return _spec(int(n_devices), 1, False, device, devices)


def make_mesh_2d(n_kf: int, n_ray: int, device="cuda",
                 devices: Optional[Sequence] = None) -> MeshSpec:
    """A (kf x ray) mesh: slots over ``n_kf`` ranks, each slot's point buffer
    over ``n_ray``."""
    return _spec(int(n_kf), int(n_ray), True, device, devices)


def mesh_from_setting(value, device) -> Optional[MeshSpec]:
    """``system.mesh_devices``: 0 or absent is one device; an int N > 1 the 1-D
    mesh; ``[kf, ray]`` the 2-axis mesh (one rank in all: one device)."""
    if isinstance(value, (list, tuple)):
        if len(value) != 2:
            raise ValueError(f"mesh_devices as a list is [kf, ray], got {value!r}")
        n_kf, n_ray = int(value[0]), int(value[1])
        return make_mesh_2d(n_kf, n_ray, device) if n_kf * n_ray > 1 else None
    n = int(value or 0)
    return make_mesh(n, device) if n > 1 else None


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Mesh:
    """One rank's view of a running mesh: its device, shards and groups.

    Groups, joined by every rank in one order: the world (gloo; the rendezvous
    only), ``control`` (gloo, rank 0's commands, a long timeout), ``group``
    (the device group: NCCL on cards of their own, else gloo; every tensor
    collective) and, on a ray axis, this rank's ``ray_group`` (the device
    backend)."""

    def __init__(self, spec: MeshSpec, rank: int, processes: Sequence = (),
                 reports: Sequence = (), timeout: timedelta = COLLECTIVE_TIMEOUT) -> None:
        self.spec = spec
        self.rank = rank
        self.device = torch.device(spec.devices[rank])
        self.kf_index, self.ray_index = divmod(rank, spec.n_ray)
        self.timeout = timeout
        self._processes = list(processes)
        self._reports = list(reports)  # rank 0: each follower's end of its report pipe
        self._closed = False
        self.broken: Optional[str] = None  # rank 0: why the mesh cannot go on, once known
        # CUDA graphs that captured this mesh's collectives (``hold``).
        self._captured: "weakref.WeakSet" = weakref.WeakSet()
        self.teardown: dict = {}  # rank 0 after ``close``: each rank's teardown seconds
        self.control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        self.group = dist.new_group(backend=spec.backend, timeout=timeout)
        self._device_groups = [self.group]
        self.ray_group = None
        if spec.n_ray > 1:
            for a in range(spec.n_kf):  # every rank creates every group, in one order
                group = dist.new_group([a * spec.n_ray + b for b in range(spec.n_ray)],
                                       backend=spec.backend, timeout=timeout)
                self._device_groups.append(group)
                if a == self.kf_index:
                    self.ray_group = group
        # Eager collectives on every group: the communicators exist before any
        # capture.
        probe = torch.ones(1, device=self.device)
        dist.all_reduce(probe, group=self.group)
        if self.ray_group is not None:
            dist.all_reduce(probe, group=self.ray_group)
        if int(probe.item()) != spec.size * spec.n_ray:
            raise RuntimeError(f"mesh probe summed to {probe.item()}")

    # -- shards ------------------------------------------------------------------
    def slots(self, window_size: int) -> Tuple[int, int]:
        if window_size % self.spec.n_kf:
            raise ValueError(f"window size {window_size} does not divide over "
                             f"{self.spec.n_kf} keyframe ranks")
        k = window_size // self.spec.n_kf
        return self.kf_index * k, (self.kf_index + 1) * k

    def points(self, point_pad: int) -> Tuple[int, int]:
        if point_pad % self.spec.n_ray:
            raise ValueError(f"point pad {point_pad} does not divide over {self.spec.n_ray} "
                             "ray ranks")
        k = point_pad // self.spec.n_ray
        return self.ray_index * k, (self.ray_index + 1) * k

    def ray_chunk(self, n: int) -> Tuple[int, int]:
        """This rank's share of ``n`` rays of its keyframe group."""
        if n % self.spec.n_ray:
            raise ValueError(f"{n} rays of a keyframe group do not divide over "
                             f"{self.spec.n_ray} ray ranks")
        k = n // self.spec.n_ray
        return self.ray_index * k, (self.ray_index + 1) * k

    # -- collectives -------------------------------------------------------------
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over every rank, in place (at one rank too: the program is the same)."""
        dist.all_reduce(t, group=self.group)
        return t

    def ray_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over this rank's ray group, in place."""
        if self.ray_group is not None:
            dist.all_reduce(t, group=self.ray_group)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0, group=self.group)
        return t

    def hold(self, graph) -> None:
        """``graph`` (a ``CountedGraph``) captured this mesh's collectives. NCCL
        keeps a communicator until every graph holding its collectives is
        destroyed, so the teardown releases the graphs still alive first."""
        self._captured.add(graph)

    # -- waits -------------------------------------------------------------------
    def wait(self, event: Optional["torch.cuda.Event"] = None) -> None:
        """Wait for ``event`` (default: all work queued so far on the current
        stream). Rank 0 of a launched mesh polls it, checking its followers: a
        follower that exits makes it raise, naming the rank, where a plain wait
        would sit on its collectives for ever (a collective replayed in a graph has
        no watchdog); so does ``timeout`` passing. Other ranks wait plainly.
        Rank 0's poll is the span ``mesh.wait``; each query of the event adds one
        to the counter ``mesh_polls`` (``runtime/profiling.py``)."""
        if self.device.type != "cuda":
            return
        if event is None:
            event = torch.cuda.Event()
            event.record()
        if not self._processes:
            event.synchronize()
            return
        deadline = time.monotonic() + self.timeout.total_seconds()
        with profiling.span("mesh.wait"):
            while True:
                profiling.count("mesh_polls")
                if event.query():
                    return
                self.check_followers()
                if time.monotonic() > deadline:
                    self.broken = (f"rank 0's work on {self.device} did not end within "
                                   f"{self.timeout.total_seconds():.0f} s (followers alive: "
                                   f"ranks {[r for r, _ in self._alive()]})")
                    raise TimeoutError(self.broken)
                time.sleep(POLL_SECONDS)

    def event(self) -> "_MeshEvent":
        """A CUDA event whose ``synchronize`` is ``wait``."""
        return _MeshEvent(self)

    # -- commands ----------------------------------------------------------------
    def _alive(self) -> List[Tuple[int, Any]]:
        return [(r, p) for r, p in enumerate(self._processes, start=1) if p.exitcode is None]

    def check_followers(self) -> None:
        for r, p in enumerate(self._processes, start=1):
            if p.exitcode is not None:
                self.broken = f"mesh follower rank {r} exited with code {p.exitcode}"
                raise RuntimeError(self.broken)

    def send(self, message: dict) -> None:
        """Rank 0: a command to every follower."""
        self.check_followers()
        dist.broadcast_object_list([message], src=0, group=self.control)

    def receive(self) -> dict:
        """A follower: rank 0's next command."""
        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    # -- teardown ----------------------------------------------------------------
    def leave(self) -> dict:
        """Every rank's teardown, after the stop, in one order: release the CUDA
        graphs holding the mesh's collectives, synchronize the device, meet every
        rank at a barrier on the control group (every rank is idle), then leave
        the device groups, then the control group and the world. Each wait is
        bounded (``_teardown_bound``) and raises: the barrier names the ranks
        that did not arrive. Before that bound each rank dumps the stacks of its
        threads on its standard error, rank r after TEARDOWN_SECONDS + r seconds
        (the dump's "Timeout" header names the rank by its seconds), and a
        follower then exits with code 1. Returns the seconds of each step."""
        faulthandler.dump_traceback_later(TEARDOWN_SECONDS + self.rank, exit=self.rank > 0)
        bound = self._teardown_bound()
        try:
            times, t0 = {}, time.perf_counter()
            for graph in list(self._captured):
                graph.release()
            self._captured = weakref.WeakSet()
            times["release"] = time.perf_counter() - t0
            self.wait()
            times["synchronize"] = time.perf_counter() - t0 - times["release"]
            t1 = time.perf_counter()
            dist.monitored_barrier(group=self.control, wait_all_ranks=True,
                                   timeout=timedelta(seconds=bound))
            times["barrier"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            _bounded(lambda: leave_group(True, self._device_groups + [self.control]),
                     f"rank {self.rank} leaving its {self.spec.backend} groups", bound)
            times["leave"] = time.perf_counter() - t1
            times["total"] = time.perf_counter() - t0
            return times
        finally:
            faulthandler.cancel_dump_traceback_later()

    def _teardown_bound(self) -> float:
        """Seconds each wait of the teardown may take: past every rank's dump."""
        return TEARDOWN_SECONDS + self.spec.size

    def close(self) -> None:
        """Rank 0: stop the followers and run the teardown with them (``leave``),
        then wait for each to exit with code 0 and its report: ``teardown`` holds
        every rank's seconds (idempotent). A follower that exits early, misses
        the barrier, or does not exit in time after it, makes ``close`` raise,
        naming its rank, once every follower is stopped and the group aborted
        (``abandon``). A mesh already ``broken`` (rank 0 raised for it) is
        abandoned."""
        if self._closed:
            return
        if self.broken is not None:
            self.abandon()
            return
        self._closed = True
        t0 = time.perf_counter()
        try:
            self.send({"cmd": "stop"})
            self.teardown[0] = self.leave()
            deadline = time.monotonic() + self._teardown_bound()
            for r, (p, report) in enumerate(zip(self._processes, self._reports), start=1):
                p.join(timeout=max(deadline - time.monotonic(), 0.0))
                if p.exitcode != 0:
                    raise RuntimeError(
                        f"mesh follower rank {r} did not end its teardown: "
                        + ("still running" if p.exitcode is None else f"exit code {p.exitcode}")
                        + f" {self._teardown_bound():.0f} s after the barrier (its stacks are "
                        "on the standard error)")
                self.teardown[r] = report.recv() if report.poll() else None
            self.teardown["close"] = time.perf_counter() - t0
            print(f"Mesh teardown, {self.spec.size} ranks over {self.spec.backend}: "
                  + json.dumps(self.teardown), flush=True)
        except BaseException:
            self.abandon()
            raise

    def abandon(self) -> None:
        """A mesh with a rank that is gone or stuck: release the graphs, kill the
        followers still running, abort the device groups (NCCL's collective
        teardown would wait for the missing ranks)."""
        self._closed = True
        for graph in list(self._captured):
            graph.release()
        self._captured = weakref.WeakSet()
        for _, p in self._alive():
            p.kill()
        for p in self._processes:
            p.join(timeout=JOIN_SECONDS)
        leave_group(clean=False)


class _MeshEvent:
    """A CUDA event waited on through ``Mesh.wait``."""

    def __init__(self, mesh: Mesh) -> None:
        self._mesh = mesh
        self._event = torch.cuda.Event()

    def record(self) -> None:
        self._event.record()

    def query(self) -> bool:
        return self._event.query()

    def synchronize(self) -> None:
        self._mesh.wait(self._event)


def _bounded(fn: Callable[[], None], what: str, seconds: float) -> None:
    """``fn()`` in a thread of its own; raises if it has not ended after ``seconds``."""
    error: List[BaseException] = []

    def run() -> None:
        try:
            fn()
        except BaseException as e:  # re-raised by the caller's thread
            error.append(e)

    thread = threading.Thread(target=run, name=what, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        raise TimeoutError(f"{what} did not end within {seconds:.0f} s")
    if error:
        raise error[0]


def leave_group(clean: bool = True, groups: Sequence = ()) -> None:
    """Leave the process groups: ``groups`` in order, then whatever is left
    with the world. ``clean=False`` (a rank is gone) aborts every group where
    this torch can: NCCL's teardown would wait for the missing rank."""
    if not dist.is_initialized():
        return
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if not clean and abort is not None:
        abort()
        return
    for group in groups:
        dist.destroy_process_group(group)
    dist.destroy_process_group()


def join(spec: MeshSpec, rank: int, port: int, processes: Sequence = (), reports: Sequence = (),
         timeout: timedelta = COLLECTIVE_TIMEOUT) -> Mesh:
    """Join the mesh's process groups as ``rank`` (every rank calls this);
    ``timeout``: how long a collective (the rendezvous, too) waits for the
    other ranks."""
    device = torch.device(spec.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=spec.size, timeout=timeout)
    try:
        return Mesh(spec, rank, processes, reports, timeout)
    except BaseException:
        leave_group(clean=False)
        raise


def _follower(spec: MeshSpec, rank: int, port: int, main: Callable, args: tuple,
              timeout: timedelta, report) -> None:
    mesh = join(spec, rank, port, timeout=timeout)
    try:
        main(mesh, *args)
    except BaseException:
        leave_group(clean=False)
        raise
    try:
        report.send(mesh.leave())
    except BaseException:  # a teardown that failed: rank 0 reads the exit code
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # a thread may still sit in NCCL's teardown
    report.close()


def launch(spec: MeshSpec, main: Callable, args: tuple = (),
           timeout: timedelta = COLLECTIVE_TIMEOUT) -> Mesh:
    """Rank 0: spawn ranks 1..N-1, each running ``main(mesh, *args)`` until it
    returns (after rank 0's stop: ``Mesh.receive``) and then the teardown, and
    join the groups. ``main`` and ``args`` must pickle (a module-level
    function). ``timeout``: ``join``'s."""
    main_file = getattr(sys.modules["__main__"], "__file__", None)
    if main_file is not None and not os.path.isfile(main_file):
        # A spawned rank runs the parent's __main__ again from its file; without
        # one it dies before joining, and rank 0 would wait out the rendezvous.
        raise RuntimeError(f"the mesh's ranks re-import __main__, whose file {main_file!r} "
                           "does not exist: run the program from a file or with -c")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    pipes = [ctx.Pipe(duplex=False) for _ in range(1, spec.size)]
    processes = [ctx.Process(target=_follower, args=(spec, r, port, main, args, timeout, send),
                             daemon=True, name=f"mesh-rank-{r}")
                 for r, (_, send) in zip(range(1, spec.size), pipes)]
    for p in processes:
        p.start()
    for _, send in pipes:
        send.close()  # the followers hold the sending ends
    try:
        return join(spec, 0, port, processes, [recv for recv, _ in pipes], timeout)
    except BaseException:
        for p in processes:
            p.kill()
            p.join(timeout=JOIN_SECONDS)
        raise


# -- window buffers and replicated state ---------------------------------------
WINDOW_FIELDS = ("dirs", "depths", "counts", "sky_dirs", "sky_counts", "slot_valid")


def shard_window_buffers(buffers: WindowBuffers, mesh: Mesh) -> WindowBuffers:
    """This rank's slot rows and, on the ray axis, its points of them."""
    s0, s1 = mesh.slots(buffers.dirs.shape[0])
    p0, p1 = mesh.points(buffers.dirs.shape[1])
    return WindowBuffers(buffers.dirs[s0:s1, p0:p1].contiguous(),
                         buffers.depths[s0:s1, p0:p1].contiguous(),
                         buffers.counts[s0:s1].clone(), buffers.sky_dirs[s0:s1].clone(),
                         buffers.sky_counts[s0:s1].clone(), buffers.slot_valid[s0:s1].clone())


def broadcast_window(mesh: Mesh, buffers: Optional[WindowBuffers], w: int, p: int,
                     ps: int) -> WindowBuffers:
    """Rank 0's whole window to every rank in one broadcast (rank 0 passes its
    buffers, the others None); counts and flags travel as f32 (exact below 2^24)."""
    sizes = (w * p * 3, w * p, w, w * ps * 3, w, w)
    if mesh.rank == 0:
        flat = torch.cat([getattr(buffers, n).reshape(-1).to(torch.float32)
                          for n in WINDOW_FIELDS])
    else:
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=mesh.device)
    mesh.broadcast_(flat)
    if mesh.rank == 0:
        return buffers
    dirs, depths, counts, sky_dirs, sky_counts, valid = flat.split(sizes)
    return WindowBuffers(dirs.view(w, p, 3), depths.view(w, p), counts.to(torch.int32),
                         sky_dirs.view(w, ps, 3), sky_counts.to(torch.int32), valid.bool())


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` (f32, the same shapes on every rank) into
    every rank's, in place, in one broadcast."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    mesh.broadcast_(flat)
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


class WindowShard:
    """What one rank computes of a window's iteration (see the module
    docstring). ``n_lidar`` + ``n_sky`` rays a slot, ``n_camera`` pixels a slot
    in a camera phase."""

    def __init__(self, mesh: Mesh, window_size: int, n_lidar: int, n_sky: int,
                 n_camera: int = 0) -> None:
        self.mesh = mesh
        self.s0, self.s1 = mesh.slots(window_size)
        w_local = self.s1 - self.s0
        per_slot = n_lidar + n_sky
        c0, c1 = mesh.ray_chunk(w_local * per_slot)
        self.rays = slice(c0, c1)  # of the keyframe group's rays
        self.lidar_rows = slice(self.s0 * per_slot + c0, self.s0 * per_slot + c1)
        self.n_rays = window_size * per_slot
        self.share = (c1 - c0) / self.n_rays
        self.cam_rays = self.camera_rows = None
        if n_camera:
            k0, k1 = mesh.ray_chunk(w_local * n_camera)
            self.cam_rays = slice(k0, k1)
            self.camera_rows = slice(self.s0 * n_camera + k0, self.s0 * n_camera + k1)

    def draws(self, draws):
        """This rank's rows of the window's draws (views)."""
        rows = {}
        for name in SLOT_DRAWS + LIDAR_DRAWS + CAMERA_DRAWS:
            t = getattr(draws, name)
            if t is None:
                continue
            if name in SLOT_DRAWS:
                rows[name] = t[self.s0:self.s1]
            elif name in LIDAR_DRAWS:
                rows[name] = t[self.lidar_rows]
            else:
                rows[name] = t[self.camera_rows]
        return dataclasses.replace(draws, **rows)

    def slot_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.s0:self.s1]

    def camera(self, cam: CameraWindowBuffers) -> CameraWindowBuffers:
        return CameraWindowBuffers(cam.cam_dirs, cam.intensities[self.s0:self.s1],
                                   cam.has_image[self.s0:self.s1], cam.lidar_to_camera)

    def gather(self, buffers: WindowBuffers, idx: torch.Tensor):
        """The points at global indices ``idx`` (W_local, n): gathered where this
        rank holds them, zero elsewhere, summed over the ray group."""
        w, n = idx.shape
        if self.mesh.spec.n_ray == 1:
            return (torch.gather(buffers.dirs, 1, idx[..., None].expand(w, n, 3)),
                    torch.gather(buffers.depths, 1, idx))
        p_local = buffers.depths.shape[1]
        local = idx - self.mesh.ray_index * p_local
        held = (local >= 0) & (local < p_local)
        local = local.clamp(0, p_local - 1)
        packed = torch.cat([torch.gather(buffers.dirs, 1, local[..., None].expand(w, n, 3)),
                            torch.gather(buffers.depths, 1, local)[..., None]], dim=-1)
        packed = torch.where(held[..., None], packed, torch.zeros_like(packed))
        self.mesh.ray_sum_(packed)
        return packed[..., :3], packed[..., 3]

    def window_counts(self, opaque: torch.Tensor, valid: torch.Tensor,
                      cam_valid: Optional[torch.Tensor]) -> dict:
        """The window's opaque, valid and camera-valid ray counts (one all-reduce)
        and its ray count: the denominators of the loss's means."""
        zero = torch.zeros((), dtype=torch.float32, device=valid.device)
        counts = torch.stack([opaque.sum().float(), valid.sum().float(),
                              cam_valid.sum().float() if cam_valid is not None else zero])
        self.mesh.all_reduce_(counts)
        return {"opaque": counts[0], "valid": counts[1], "camera": counts[2],
                "rays": float(self.n_rays), "share": self.share}
