"""One mapping phase as a program: its static state, one iteration captured as a
CUDA graph, and the dispatches that replay it.

Counterpart of the JAX package's phase programs (``make_phase_runner``'s
``step`` and ``multi_step`` in ``loner_tpu/mapping/optimizer.py``): where JAX
fuses k = ``steps_per_dispatch`` iterations into one dispatched program with
``lax.scan``, a ``PhaseProgram`` on a CUDA device captures one iteration as a
``torch.cuda.CUDAGraph`` and a dispatch replays it k times; the remainder of a
phase runs as single replays, and at most ``max_inflight_dispatches``
dispatches are in flight (``optimizer.run_dispatches``).

The program owns the static state of one (phase flags, window class W, point
pad) runner: the leaf tensors of the sigma MLP, the hash table, the twists,
the proposal parameters and, in a phase that trains it, the intensity head; Adam's moments and step (``capturable=True`` on the
card); the pose mask, world scale and shift; the window buffers; the draw
tensors; the iteration index and global step as device scalars; and the
per-iteration loss, ``depth_eps`` and camera-loss record; in a camera phase the
camera buffers (``CameraWindowBuffers``: pixel directions, the window's images
(W, H W, C), their mask and the extrinsic), refreshed per window by copy like
the window buffers. A phase copies the incoming
parameters in, resets Adam in place (the JAX package's fresh ``tx.init`` per
phase) and returns copies, never the static tensors.

One iteration is captured in two variants, with and without the OGM grid's SGD
step; the host picks one per replay, since it knows the global step
(``(step0 + i) % occ_update_every == 0``, the JAX package's ``lax.cond``). The
draws come from their own small graph, captured with the optimizer's generator
registered (``CUDAGraph.register_generator_state``), so each replay advances
its Philox offset as an eager draw would: graphs and the eager loop take the
same draws from the same seed. Before capture, a few iterations run on a side
stream (PyTorch's whole-network capture recipe): they initialise Adam's state
and every lazily built table outside the graph. A capture or replay failure
raises; nothing falls back to the eager loop.

With graphs off (the CPU, or ``graphs=False`` on the card) the same iteration
runs eagerly on the same static state; on the card both ways take the same
operations, so a deterministic configuration gives the same bits either way.

A program built with ``extras_mode`` ``"ray"`` or ``"full"`` also copies the
iteration's per-ray debug record (``RAY_EXTRAS``; ``FULL_EXTRAS`` adds the
samples) into static device tensors, inside the captured iteration. After each
replay the host enqueues, on the same stream and before the next replay, a
non-blocking copy of the record into slot i of k of a pinned host set; a
dispatch records an event after its copies, and its set is read, stacked
(k, B, ...), and handed to ``extras_log`` once that event has completed. With
up to d = ``max_inflight_dispatches`` dispatches in flight, d + 1 sets suffice.
The record is a copy of values the iteration computes anyway: it changes no
parameter, twist or loss.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict, List, Optional, Sequence

import torch

from loner_tpu_torch.common.cuda_graphs import CountedGraph
from loner_tpu_torch.mapping import optimizer as _opt
from loner_tpu_torch.mapping.rays import CameraWindowBuffers, WindowBuffers
from loner_tpu_torch.models.losses import get_logits_grad
from loner_tpu_torch.models.occupancy_grid import occ_grid_grad

HISTORY = 256  # per-iteration records kept on the device between two reads
WARMUP_ITERS = 2  # eager iterations of each variant before its capture

# The per-iteration debug record by extras mode, under the JAX package's names
# (``make_phase_runner``'s ``extras``), and the ``aux`` entry each one copies.
RAY_EXTRAS = ("rays", "depths_cube", "std", "js", "valid")
FULL_EXTRAS = RAY_EXTRAS + ("points", "w_pred", "w_gt", "z_m", "per_ray_eps")
EXTRAS = {"none": (), "ray": RAY_EXTRAS, "full": FULL_EXTRAS}
AUX_NAMES = {"js": "js_score"}


def copy_window(dst: WindowBuffers, src: WindowBuffers) -> None:
    for name in ("dirs", "depths", "counts", "sky_dirs", "sky_counts", "slot_valid"):
        getattr(dst, name).copy_(getattr(src, name))


def clone_window(src: WindowBuffers) -> WindowBuffers:
    return WindowBuffers(*(getattr(src, name).clone() for name in (
        "dirs", "depths", "counts", "sky_dirs", "sky_counts", "slot_valid")))


CAMERA_FIELDS = ("cam_dirs", "intensities", "has_image", "lidar_to_camera")


def copy_camera(dst: CameraWindowBuffers, src: CameraWindowBuffers) -> None:
    for name in CAMERA_FIELDS:
        getattr(dst, name).copy_(getattr(src, name))


def clone_camera(src: CameraWindowBuffers) -> CameraWindowBuffers:
    return CameraWindowBuffers(*(getattr(src, name).clone() for name in CAMERA_FIELDS))


class PhaseProgram:
    """The runner of one phase (see the module docstring). Call it as the JAX
    package's ``run_phase``: ``(field_params, occ_state, twists, buffers,
    pose_mask, world_scale, world_shift, global_step0, generator,
    num_iterations=None, draws=None, camera=None) -> (field_params, occ_state,
    twists, losses, depth_eps)``; a camera phase's camera losses are then in
    ``last_camera_losses``.

    ``window``: static window buffers the program reads (shared by the
    Optimizer's runners of one window class); without it the program keeps its
    own, and a call copies ``buffers`` in unless they are that object. ``pool``:
    the graph memory pool its graphs share. ``graph_class``: the graph type
    (``CountedGraph``; the tests pass one that runs on the CPU). ``has_camera``
    and ``camera``: camera geometry exists, and the static camera buffers
    (shared like ``window``).

    ``mesh``: a running mesh (``parallel/mesh.py::Mesh``): the program computes
    this rank's part of each iteration (``WindowShard``) and all-reduces the
    window's counts and, in one flat buffer, the gradients and the loss record
    before the gradient masks and the Adam step. It takes the whole window's
    buffers and shards them, unless ``window`` is given (then already this
    rank's shard). Every rank must run the same programs in the same order."""

    def __init__(self, cfg, field_cfg, phase, window_size: int, device: torch.device,
                 graphs: bool, extras_mode: str = "none",
                 window: Optional[WindowBuffers] = None, pool=None, graph_class=None,
                 has_camera: bool = True, camera: Optional[CameraWindowBuffers] = None,
                 mesh=None) -> None:
        if extras_mode not in EXTRAS:
            raise ValueError(f"unknown extras_mode {extras_mode!r}: one of {tuple(EXTRAS)}")
        if mesh is not None and extras_mode != "none":
            raise ValueError("the per-iteration debug record is not kept under a mesh")
        self.cfg = cfg
        self._extras_names = EXTRAS[extras_mode]
        self.extras: Dict[str, torch.Tensor] = {}  # the record's static device tensors
        self._host_sets: List[Dict[str, torch.Tensor]] = []  # pinned, d + 1 sets of k slots
        self.field_cfg = _opt.training_field_cfg(cfg, field_cfg)
        self.w = window_size
        self.device = torch.device(device)
        self.graphs = graphs
        self.k = _opt.fused_steps(cfg, extras_mode)
        self.depth = max(int(cfg.max_inflight_dispatches), 0)
        self._cuda = self.device.type == "cuda"
        self._use_prop = cfg.samples_strategy == "PROPOSAL"
        self._use_occ = cfg.samples_strategy == "OGM"
        self._optimize_poses = not phase.freeze_poses
        self._optimize_sigma = not phase.freeze_sigma_mlp
        self._optimize_rgb = not phase.freeze_rgb_mlp
        self.use_camera = self._optimize_rgb and cfg.n_camera_samples > 0 and has_camera
        self._camera = camera
        self.last_camera_losses: Optional[torch.Tensor] = None
        self._shard = None
        if mesh is not None:
            from loner_tpu_torch.parallel.mesh import WindowShard

            self._shard = WindowShard(mesh, window_size, cfg.n_lidar_samples,
                                      _opt.sky_rays_per_slot(cfg),
                                      cfg.n_camera_samples if self.use_camera else 0)
        self._window = window
        # One pool for the program's graphs unless the caller shares one.
        self.pool = pool if pool is not None or not (graphs and self._cuda) else (
            torch.cuda.graph_pool_handle())
        self._graph_class = graph_class or CountedGraph
        self._phase_iterations = phase.num_iterations
        self._built = False
        self._steps: Dict[bool, Any] = {}  # OGM step or not -> captured iteration
        self._draw_graph = None
        self._draw_generator: Optional[torch.Generator] = None
        self.captures = 0

    @property
    def captured(self) -> bool:
        return bool(self._steps)

    # -- static state ----------------------------------------------------------
    def _build(self, field_params, occ_state, twists, buffers: WindowBuffers,
               camera: Optional[CameraWindowBuffers]) -> None:
        cfg, dev = self.cfg, self.device

        def leaf(t: torch.Tensor) -> torch.Tensor:
            return t.detach().clone().requires_grad_(True)

        # The sigma group: the MLP and, for the hash field, its table.
        self.sigma = {"mlp": {k: leaf(v) for k, v in field_params["sigma"]["mlp"].items()}}
        if "table" in field_params["sigma"]:
            self.sigma["table"] = leaf(field_params["sigma"]["table"])
        self.sigma_params = list(self.sigma["mlp"].values()) + (
            [self.sigma["table"]] if "table" in self.sigma else [])
        self.tw = leaf(twists)
        # Adam groups: (params, base rate, decays with lr_gamma).
        groups = [(self.sigma_params, cfg.lr_sigma, True), ([self.tw], cfg.lr_pose, True)]
        self.occ = None
        if self._use_prop:
            # ``bmat`` is a fixed projection, never trained: it stays out of Adam.
            self.occ = {k: v.detach().clone() if k == "bmat" else leaf(v)
                        for k, v in occ_state.items()}
            groups.append(([v for k, v in self.occ.items() if k != "bmat"], cfg.prop_lr, False))
        elif occ_state is not None:
            self.occ = occ_state.detach().clone()
        # The intensity head, trained in its own group at lr_rgb when unfrozen.
        self.intensity: Dict[str, Any] = {}
        if self._optimize_rgb:
            src = field_params["intensity"]
            self.intensity = {"mlp": {k: leaf(v) for k, v in src["mlp"].items()}}
            if "table" in src:
                self.intensity["table"] = leaf(src["table"])
            groups.append((list(self.intensity["mlp"].values()) + (
                [self.intensity["table"]] if "table" in self.intensity else []), cfg.lr_rgb, True))
        if self.use_camera and self._camera is None:
            if camera is None:
                raise ValueError("a phase with camera samples needs camera buffers")
            self._camera = clone_camera(camera)
        # lr_gamma != 1 decays the sigma, pose and intensity rates per step (the
        # proposal's stays): the rates are device scalars the iteration multiplies.
        decay = cfg.lr_gamma != 1.0
        self.params: List[torch.Tensor] = [p for g in groups for p in g[0]]
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": torch.tensor(lr, device=dev) if decay and d else lr}
             for ps, lr, d in groups], betas=(0.9, 0.999), eps=1e-8, capturable=self._cuda)
        self._decayed = [(g, lr) for g, (_, lr, d) in zip(self.adam.param_groups, groups)
                         if decay and d]
        self.mask = torch.zeros((self.w,), dtype=self.tw.dtype, device=dev)
        self.scale = torch.zeros((), dtype=torch.float32, device=dev)
        self.shift = torch.zeros((3,), dtype=torch.float32, device=dev)
        if self._window is None:
            self._window = clone_window(self._local(buffers))
        self.it = torch.zeros((), dtype=torch.float32, device=dev)  # iteration in the phase
        self.gstep = torch.zeros((), dtype=torch.float32, device=dev)  # global step
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.history = torch.zeros((3, max(HISTORY, self.k)), dtype=torch.float32, device=dev)
        self.draws = None  # the draw graph's static tensors, made at capture
        self._built = True

    def _seat(self, field_params, occ_state, twists, buffers, pose_mask, world_scale,
              world_shift, step0: int, camera: Optional[CameraWindowBuffers] = None) -> None:
        """Phase start: the incoming state into the static tensors, a fresh Adam."""
        with torch.no_grad():
            for k, v in field_params["sigma"]["mlp"].items():
                self.sigma["mlp"][k].copy_(v)
            if "table" in self.sigma:
                self.sigma["table"].copy_(field_params["sigma"]["table"])
            if self.intensity:
                for k, v in field_params["intensity"]["mlp"].items():
                    self.intensity["mlp"][k].copy_(v)
                if "table" in self.intensity:
                    self.intensity["table"].copy_(field_params["intensity"]["table"])
            if self.use_camera and camera is not None and camera is not self._camera:
                copy_camera(self._camera, camera)
            self.tw.copy_(twists)
            if self._use_prop:
                for k, v in occ_state.items():
                    self.occ[k].copy_(v)
            elif self.occ is not None:
                self.occ.copy_(occ_state)
            self.mask.copy_(pose_mask)
            for dst, src in ((self.scale, world_scale), (self.shift, world_shift)):
                if isinstance(src, torch.Tensor):
                    dst.copy_(src)
                else:
                    dst.copy_(torch.as_tensor(src, dtype=torch.float32))
            if buffers is not self._window:
                copy_window(self._window, self._local(buffers))
            self.it.zero_()
            self.gstep.fill_(float(step0))
            self.slot.zero_()
            for state in self.adam.state.values():
                for v in state.values():
                    v.zero_()
            for g, lr in self._decayed:
                g["lr"].fill_(lr)

    def _local(self, buffers: WindowBuffers) -> WindowBuffers:
        if self._shard is None:
            return buffers
        from loner_tpu_torch.parallel.mesh import shard_window_buffers

        return shard_window_buffers(buffers, self._shard.mesh)

    # -- one iteration ----------------------------------------------------------
    def _iteration(self, d, occ_step: bool) -> None:
        """Forward, backward, gradient masks, the Adam step, the OGM step when
        ``occ_step``, and the iteration's record; every result lands in the
        static tensors, so the same code is the captured graph."""
        cfg = self.cfg
        for p in self.params:
            p.grad = None
        # Frozen poses build the rays from detached twists, so nothing below
        # the rays (the hash encode's dpos among it) is differentiated for them.
        # A phase with a frozen intensity head reads none.
        total, aux = _opt.iteration_loss(
            cfg, self.field_cfg, self.sigma, self.occ,
            self.tw if self._optimize_poses else self.tw.detach(), self.intensity, self._window,
            self.scale, self.shift, d, self.it, self.gstep,
            camera=self._camera if self.use_camera else None, shard=self._shard)
        total.backward()
        # Freezing is a gradient mask: every parameter gets a gradient (zero
        # where frozen), so Adam's moments move as the JAX package's do.
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # The mapping loss is recorded, not the total with the proposal and
        # camera terms; the camera loss beside it (0 without a camera branch).
        cam = aux.get("camera_loss")
        record = torch.stack([aux["loss"].detach(), aux["depth_eps"].detach().float(),
                              cam.detach() if cam is not None else torch.zeros_like(aux["loss"])])
        # The OGM step's gradient, at the forward's sample points (the JAX
        # package steps the grid after Adam, from the same values).
        grid_grad = None
        if occ_step:
            logits_grad = get_logits_grad(aux["z_m"].detach(), aux["depths_gt_m"][:, None].detach())
            grid_grad = occ_grid_grad(self.occ, aux["points"], logits_grad * aux["valid"][:, None])
        if self._shard is not None:
            # The window's gradients, the grid's in an OGM step, and the record:
            # one all-reduce of this rank's shares.
            grads = [p.grad for p in self.params] + ([grid_grad] if occ_step else [])
            flat = torch.cat([g.reshape(-1) for g in grads] + [record])
            self._shard.mesh.all_reduce_(flat)
            for g, v in zip(grads, flat.split([g.numel() for g in grads] + [3])):
                g.copy_(v.view_as(g))
            record = flat[-3:]
        self.tw.grad.mul_(self.mask[:, None])
        if not self._optimize_sigma:
            for p in self.sigma_params:
                p.grad.zero_()
        self.adam.step()
        with torch.no_grad():
            for g, _ in self._decayed:
                g["lr"].mul_(cfg.lr_gamma)
            if occ_step:
                self.occ.copy_(self.occ - cfg.occ_lr * grid_grad)
            self.history.index_copy_(1, self.slot.view(1), record.view(3, 1))
            self.slot.add_(1)
            self.it.add_(1.0)
            self.gstep.add_(1.0)
            for name in self._extras_names:
                value = aux[AUX_NAMES.get(name, name)].detach()
                if name not in self.extras:  # in a warm-up iteration, before any capture
                    self.extras[name] = torch.empty_like(value)
                self.extras[name].copy_(value)

    # -- the debug record's copy-out --------------------------------------------
    def _host_set(self, index: int) -> Dict[str, torch.Tensor]:
        while len(self._host_sets) <= index:
            pin = self._cuda
            self._host_sets.append({
                name: torch.empty((self.k,) + tuple(v.shape), dtype=v.dtype, pin_memory=pin)
                for name, v in self.extras.items()})
        return self._host_sets[index]

    # -- capture -----------------------------------------------------------------
    def capture(self, field_params, occ_state, twists, buffers, pose_mask, world_scale,
                world_shift, generator: Optional[torch.Generator],
                camera: Optional[CameraWindowBuffers] = None) -> None:
        """Seat the statics from this state (their values do not matter), run
        the warm-up iterations, capture both iteration variants and, with a
        generator, the draw graph. Draws nothing from ``generator``."""
        if not self._built:
            self._build(field_params, occ_state, twists, buffers, camera)
        self._seat(field_params, occ_state, twists, buffers, pose_mask, world_scale,
                   world_shift, 0, camera)
        scratch = torch.Generator(device=self.device).manual_seed(0)
        self.draws = _opt.draw_step(scratch, self.cfg, self.w, self.device,
                                    camera=self.use_camera)
        variants = (False, True) if self._use_occ else (False,)
        side = torch.cuda.Stream(self.device) if self._cuda else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            for occ_step in variants:
                for _ in range(WARMUP_ITERS):
                    self._iteration(self.draws, occ_step)
        if side is not None:
            torch.cuda.current_stream(self.device).wait_stream(side)
        for occ_step in variants:
            graph = self._graph_class()
            graph.capture(lambda v=occ_step: self._iteration(self.draws, v), pool=self.pool)
            self._steps[occ_step] = graph
            self.captures += 1
        if generator is not None:
            self._capture_draws(generator)

    def _capture_draws(self, generator: torch.Generator) -> None:
        graph = self._graph_class()
        graph.capture(lambda: _opt.fill_draws(self.draws, generator), pool=self.pool,
                      generators=(generator,))
        self._draw_graph, self._draw_generator = graph, generator
        self.captures += 1

    def warm_up(self, field_params, occ_state, twists, buffers, pose_mask, world_scale,
                world_shift, generator: torch.Generator,
                camera: Optional[CameraWindowBuffers] = None) -> torch.Tensor:
        """Make the program ready before the first keyframe without drawing from
        ``generator``: with graphs, capture it; without, run one iteration on a
        scratch generator. Returns a tensor to wait on."""
        if self.graphs:
            if not self.captured:
                self.capture(field_params, occ_state, twists, buffers, pose_mask, world_scale,
                             world_shift, generator, camera)
            return self.history[0, :1]
        scratch = torch.Generator(device=self.device).manual_seed(17)
        return self(field_params, occ_state, twists, buffers, pose_mask, world_scale,
                    world_shift, 0, scratch, num_iterations=1, camera=camera)[3]

    # -- a phase -----------------------------------------------------------------
    def __call__(self, field_params: Dict[str, Any], occ_state, twists: torch.Tensor,
                 buffers: WindowBuffers, pose_mask: torch.Tensor, world_scale,
                 world_shift: torch.Tensor, global_step0: int,
                 generator: Optional[torch.Generator], num_iterations: Optional[int] = None,
                 draws: Optional[Sequence] = None,
                 camera: Optional[CameraWindowBuffers] = None, extras_log=None):
        n_iters = self._phase_iterations if num_iterations is None else num_iterations
        if draws is None and generator is None:
            raise ValueError("run_phase needs a generator or the draws")
        if draws is not None and len(draws) < n_iters:
            raise ValueError(f"{len(draws)} draws for {n_iters} iterations")
        if self.graphs and not self.captured:
            self.capture(field_params, occ_state, twists, buffers, pose_mask, world_scale,
                         world_shift, generator if draws is None else None, camera)
        elif not self._built:
            self._build(field_params, occ_state, twists, buffers, camera)
        step0 = int(global_step0)
        self._seat(field_params, occ_state, twists, buffers, pose_mask, world_scale,
                   world_shift, step0, camera)
        if self.graphs and draws is None and self._draw_generator is not generator:
            self._capture_draws(generator)

        records: List[torch.Tensor] = []
        filled = 0
        # The debug record: (host set, iterations, event) of each dispatch not yet
        # read, oldest first; the sets are taken in turn.
        record_extras = extras_log is not None and bool(self._extras_names)
        n_sets = max(self.depth, 1) + 1
        pending: collections.deque = collections.deque()
        n_dispatched = 0

        def collect() -> None:
            index, k, event = pending.popleft()
            if event is not None:
                event.synchronize()
            host = self._host_sets[index]
            extras_log.append({name: host[name][:k].numpy().copy() for name in host})

        def iterate(i: int) -> None:
            occ_step = self._use_occ and (step0 + i) % self.cfg.occ_update_every == 0
            if not self.graphs:
                d = draws[i] if draws is not None else _opt.draw_step(
                    generator, self.cfg, self.w, self.device, camera=self.use_camera)
                self._iteration(d, occ_step)
                return
            if draws is None:
                self._draw_graph.replay()
            else:
                for name in _opt.DRAW_FIELDS:
                    if getattr(self.draws, name) is not None:
                        getattr(self.draws, name).copy_(getattr(draws[i], name))
            self._steps[occ_step].replay()

        def dispatch(i0: int, k: int) -> None:
            nonlocal filled, n_dispatched
            if filled + k > self.history.shape[1]:
                records.append(self.history[:, :filled].clone())
                self.slot.zero_()
                filled = 0
            index = n_dispatched % n_sets
            if record_extras and len(pending) == n_sets:
                collect()  # the oldest dispatch holds this set
            for j in range(k):
                iterate(i0 + j)
                if record_extras:
                    host = self._host_set(index)
                    for name, value in self.extras.items():
                        host[name][j].copy_(value, non_blocking=True)
            if record_extras:
                event = None
                if self._cuda:
                    event = torch.cuda.Event()
                    event.record()
                pending.append((index, k, event))
            n_dispatched += 1
            filled += k

        _opt.run_dispatches(n_iters, self.k, self.depth, dispatch,
                            torch.cuda.Event if self._cuda else None)
        while pending:
            collect()
        records.append(self.history[:, :filled])
        log = torch.cat(records, dim=1)

        new_sigma = {"mlp": {k: v.detach().clone() for k, v in self.sigma["mlp"].items()}}
        if "table" in self.sigma:
            new_sigma["table"] = self.sigma["table"].detach().clone()
        new_intensity = field_params["intensity"]
        if self.intensity:
            new_intensity = {"mlp": {k: v.detach().clone()
                                     for k, v in self.intensity["mlp"].items()}}
            if "table" in self.intensity:
                new_intensity["table"] = self.intensity["table"].detach().clone()
        new_field = {"sigma": new_sigma, "intensity": new_intensity}
        self.last_camera_losses = log[2].clone() if self.use_camera else None
        if self._use_prop:
            occ = {k: v.detach().clone() for k, v in self.occ.items()}
        else:
            occ = None if self.occ is None else self.occ.clone()
        return new_field, occ, self.tw.detach().clone(), log[0].clone(), log[1].clone()
