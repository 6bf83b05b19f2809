"""The mapper's joint phase on a window drawn from the seed (traffic ``train_window``).

Set-up draws, on the card and from ``--seed``, the window (``window`` slots of
``points_per_slot`` unit directions with ranges uniform in ``depth_range_m``),
the slots' pose twists (normal, ``twist_std``) and the map's start (He-uniform
MLP weights, zero biases, the hash table uniform in +-1e-4, the proposal MLP or
a zero occupancy grid), builds the port's phase program
(``mapping/optimizer.py::make_phase_runner``) over the window, captures its
CUDA graphs (``warm_up``) and drives it through its first steps: a phase of one
iteration, whose Adam moments give the first gradient, and from the same draws
a phase of ``check_steps``. The window then runs phase after phase of the
configuration's joint phase (``num_iterations`` each, every one from the drawn
start, as a keyframe's phase starts from the map, with new draws) through the
same call, until ``--seconds`` have passed, and ends in
``torch.cuda.synchronize()``. ``train_rays_per_s`` is the LiDAR rays of every
iteration of the window over its seconds.

With ``--trace 1`` another ``traced_phases`` phases run under the profiler for
the per-layer readers. Once the window has closed and the program is freed, the
plain reference (``reference/plain.py``) takes the same start and draws
through ``check_steps`` steps, and ``reference/compare.py`` gives the numbers
that ``limits/<cell>.json`` bounds.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict

import torch

from portbench import costs, portcfg
from portbench.harness import Outcome, Run, subseed
from portbench.reference import compare, plain

BETA1 = 0.9  # Adam's first decay in the port's phase programs
WINDOW_FIELDS = ("dirs", "depths", "counts", "sky_dirs", "sky_counts", "slot_valid")


def he_uniform(gen: torch.Generator, dims, dev) -> list:
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = math.sqrt(6.0 / d_in)
        out.append(torch.rand((d_in, d_out), generator=gen, device=dev) * (2.0 * bound) - bound)
    return out


def draw_window(traffic: dict, gen: torch.Generator, dev) -> Dict[str, torch.Tensor]:
    w, p = traffic["window"], traffic["points_per_slot"]
    dirs = torch.randn((w, p, 3), generator=gen, device=dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    lo, hi = traffic["depth_range_m"]
    depths = torch.rand((w, p), generator=gen, device=dev) * (hi - lo) + lo
    return {"dirs": dirs, "depths": depths,
            "counts": torch.full((w,), p, dtype=torch.int32, device=dev),
            "sky_dirs": torch.zeros((w, traffic["sky_pad"], 3), device=dev),
            "sky_counts": torch.zeros((w,), dtype=torch.int32, device=dev),
            "slot_valid": torch.ones((w,), dtype=torch.bool, device=dev)}


def draw_start(config: dict, traffic: dict, gen: torch.Generator, dev) -> Dict[str, Any]:
    """The map's and the poses' start, in the reference's layout."""
    fcfg, opt = config["field"], config["optimizer"]
    mlp = fcfg["sigma_mlp"]
    dims = [costs.sigma_in_dim(fcfg)] + [mlp["n_neurons"]] * mlp["n_hidden_layers"] + [mlp["output_dim"]]
    sigma = {f"w{i}": w for i, w in enumerate(he_uniform(gen, dims, dev))}
    if fcfg["sigma_mlp_bias"]:
        sigma.update({f"b{i}": torch.zeros(d, device=dev) for i, d in enumerate(dims[1:])})
    if fcfg["encoding_sigma"] != "fourier":
        hcfg = fcfg["pos_encoding_sigma"]
        sigma["table"] = torch.rand((costs.hash_table_entries(hcfg), hcfg["n_features_per_level"]),
                                    generator=gen, device=dev) * 2e-4 - 1e-4
    start: Dict[str, Any] = {"sigma": sigma}
    start["twists"] = torch.randn((traffic["window"], 6), generator=gen, device=dev) * traffic["twist_std"]
    if opt["samples_strategy"] == "PROPOSAL":
        pc = opt["proposal"]
        pdims = [2 * pc["n_freqs"] + 3] + [pc["n_neurons"]] * pc["n_hidden_layers"] + [1]
        start["proposal"] = {"bmat": plain.fourier_bmat(config, pc["seed"], pc["n_freqs"],
                                                        pc["scale"]).to(dev),
                             **{f"w{i}": w for i, w in enumerate(he_uniform(gen, pdims, dev))}}
    elif opt["samples_strategy"] == "OGM":
        v = opt["occ_voxel_size"]
        start["grid"] = torch.zeros((v, v, v), device=dev)
    return start


def port_state(start: Dict[str, Any]):
    """(field_params, occ_state, twists) in the port's layout."""
    sigma = {"mlp": {k: v for k, v in start["sigma"].items() if k != "table"}}
    if "table" in start["sigma"]:
        sigma["table"] = start["sigma"]["table"]
    occ = start.get("proposal", start.get("grid"))
    return {"sigma": sigma, "intensity": {}}, occ, start["twists"]


def program_leaves(prog) -> Dict[str, torch.Tensor]:
    """The phase program's trained leaves under the reference's names."""
    out = {f"sigma.{k}": v for k, v in prog.sigma["mlp"].items()}
    if "table" in prog.sigma:
        out["sigma.table"] = prog.sigma["table"]
    out["twists"] = prog.tw
    if isinstance(prog.occ, dict):
        out.update({f"proposal.{k}": v for k, v in prog.occ.items() if k != "bmat"})
    return out


def returned_leaves(field, occ, twists) -> Dict[str, torch.Tensor]:
    out = {f"sigma.{k}": v for k, v in field["sigma"]["mlp"].items()}
    if "table" in field["sigma"]:
        out["sigma.table"] = field["sigma"]["table"]
    out["twists"] = twists
    if isinstance(occ, dict):
        out.update({f"proposal.{k}": v for k, v in occ.items() if k != "bmat"})
    elif occ is not None:
        out["grid"] = occ
    return out


def flat_start(start: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {f"sigma.{k}": v for k, v in start["sigma"].items()}
    out["twists"] = start["twists"]
    out.update({f"proposal.{k}": v for k, v in start.get("proposal", {}).items() if k != "bmat"})
    if "grid" in start:
        out["grid"] = start["grid"]
    return out


def first_gradient(adam, leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's gradient as Adam got it in a phase's first step, from its first
    moment (``exp_avg = (1 - beta1) g``); zeros where Adam holds no moment (it
    took no step)."""
    state = adam.state.get(leaf, {})
    if "exp_avg" not in state:
        return torch.zeros_like(leaf)
    return (state["exp_avg"] / (1.0 - BETA1)).clone()


def synchronize(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class Session:
    """The port's phase program over one static window, built and captured once;
    ``seat(seed)`` draws a window and a start into it. Under a ``mesh``
    (``parallel/mesh.py::Mesh``) the program holds this rank's shard of the
    window (``local``) and computes its part of every iteration; every rank
    draws the whole window and the start from the seed alike."""

    def __init__(self, config: dict, traffic: dict, device, mesh=None) -> None:
        from loner_tpu_torch.mapping.optimizer import make_phase_runner
        from loner_tpu_torch.mapping.rays import WindowBuffers

        self.config, self.traffic = config, traffic
        self.dev = dev = torch.device(device)
        self.cfg, field_cfg, self.phase = portcfg.build(config)
        w, p, ps = traffic["window"], traffic["points_per_slot"], traffic["sky_pad"]
        self.w = w
        self.window = {"dirs": torch.zeros((w, p, 3), device=dev),
                       "depths": torch.zeros((w, p), device=dev),
                       "counts": torch.zeros((w,), dtype=torch.int32, device=dev),
                       "sky_dirs": torch.zeros((w, ps, 3), device=dev),
                       "sky_counts": torch.zeros((w,), dtype=torch.int32, device=dev),
                       "slot_valid": torch.zeros((w,), dtype=torch.bool, device=dev)}
        self.buffers = WindowBuffers(*(self.window[k] for k in WINDOW_FIELDS))
        self.mesh = mesh
        self.local = self.buffers
        if mesh is not None:
            from loner_tpu_torch.parallel.mesh import shard_window_buffers

            self.local = shard_window_buffers(self.buffers, mesh)
        self.prog = make_phase_runner(self.cfg, field_cfg, self.phase, w, p, ps, dev,
                                      window=self.local, mesh=mesh)
        self.common = (self.local, torch.ones(w, device=dev),
                       torch.tensor(float(traffic["world_scale_m"]), device=dev),
                       torch.zeros(3, device=dev))
        self.gen = torch.Generator(device=dev)
        self.start: Dict[str, Any] = {}

    def seat(self, seed: int) -> None:
        """The window and the start of ``seed``, drawn on the device."""
        gen = torch.Generator(device=self.dev).manual_seed(subseed(seed, 0))
        with torch.no_grad():
            for k, v in draw_window(self.traffic, gen, self.dev).items():
                self.window[k].copy_(v)
            if self.mesh is not None:
                from loner_tpu_torch.parallel.mesh import shard_window_buffers

                shard = shard_window_buffers(self.buffers, self.mesh)
                for k in WINDOW_FIELDS:
                    getattr(self.local, k).copy_(getattr(shard, k))
        self.start = draw_start(self.config, self.traffic, gen, self.dev)
        self.state = port_state(self.start)

    def warm_up(self) -> None:
        self.prog.warm_up(*self.state, *self.common, self.gen)

    def phase_call(self, step0: int, num_iterations=None):
        return self.prog(*self.state, *self.common, step0, self.gen,
                         num_iterations=num_iterations)

    def program_steps(self, draw_seed: int, n_steps: int) -> dict:
        """The check's first steps through the window's own call: a phase of one
        iteration (its Adam moments give the first gradients), then, from the
        same draws, a phase of ``n_steps``."""
        self.gen.manual_seed(draw_seed)
        self.phase_call(0, 1)
        grads = {k: first_gradient(self.prog.adam, v) for k, v in program_leaves(self.prog).items()}
        self.gen.manual_seed(draw_seed)
        field, occ, twists, losses, _ = self.phase_call(0, n_steps)
        return {"losses": [float(x) for x in losses.tolist()], "grads": grads,
                "start": flat_start(self.start), "end": returned_leaves(field, occ, twists)}

    def reference_steps(self, draw_seed: int, n_steps: int, lower: bool = False) -> dict:
        """The plain reference from the same start and draws (``lower``: the
        control's precision)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        trainer = plain.PlainTrainer(self.config, self.window, self.start,
                                     float(self.traffic["world_scale_m"]), lower=lower, step0=0)
        gen = torch.Generator(device=self.dev).manual_seed(draw_seed)
        losses = [trainer.step(plain.draw(gen, self.config["optimizer"], self.w, self.dev))
                  for _ in range(n_steps)]
        return {"losses": losses, "grads": trainer.first_grads, "start": flat_start(self.start),
                "end": trainer.state()}

    def traced_phases(self, count: int, first_phase: int):
        """``count`` phases from phase ``first_phase`` on under the profiler."""
        from portbench.trace import traced

        n = int(self.phase.num_iterations)

        def work() -> None:
            for i in range(count):
                self.phase_call((first_phase + i) * n)

        return traced(work, self.dev)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0

    def free(self) -> None:
        """Drop the program (its graphs and pool) before the reference runs."""
        self.prog = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def quarters(ends, rays_per_phase: int):
    """The window's rate in each quarter of its phases (whether a run's rate
    drifts inside the window or stays apart from another run's all through)."""
    n = len(ends)
    cuts = [round(n * q / 4) for q in range(5)]
    out = []
    for a, b in zip(cuts, cuts[1:]):
        if b > a:
            t_a = ends[a - 1] if a > 0 else 0.0
            out.append((b - a) * rays_per_phase / (ends[b - 1] - t_a))
    return out


def drive(run: Run) -> Outcome:
    if int(run.traffic.get("mesh_devices", 1)) > 1:
        raise ValueError("a mesh window is the train_mesh driver's")
    marks = {"imports": time.perf_counter() - run.t_start}
    return measure(run, Session(run.config, run.traffic, run.device), marks)


def measure(run: Run, s, marks: Dict[str, float], chips: int = 1) -> Outcome:
    """Set-up, the check's first steps, the window, the trace and the check, on
    a ``Session`` (or a mesh's rank 0 commanding its followers)."""
    tr = run.traffic
    s.seat(run.seed)
    synchronize(s.dev)
    marks["window_and_program"] = time.perf_counter() - run.t_start
    s.warm_up()
    synchronize(s.dev)
    marks["captures"] = time.perf_counter() - run.t_start
    draw_seed = subseed(run.seed, 1)
    n_check = int(tr["check_steps"])
    program = s.program_steps(draw_seed, n_check)
    synchronize(s.dev)
    marks["first_steps"] = time.perf_counter() - run.t_start

    # The window: whole phases until --seconds have passed.
    n_per_phase = int(s.phase.num_iterations)
    setup_s = time.perf_counter() - run.t_start
    t0 = time.perf_counter()
    ends = []  # each phase's return on the host clock (a phase ends in a copy to the host)
    while True:
        s.phase_call(len(ends) * n_per_phase)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= run.seconds:
            break
    synchronize(s.dev)
    window_s = time.perf_counter() - t0
    n_phases = len(ends)
    iterations = n_phases * n_per_phase
    rays_per_phase = n_per_phase * s.w * s.cfg.n_lidar_samples
    metrics = {"train_rays_per_s": n_phases * rays_per_phase / window_s, "setup_s": setup_s}
    layer: Dict[str, Any] = {"setup_marks_s": marks,
                             "window_quarters_rays_per_s": quarters(ends, rays_per_phase),
                             "iterations": iterations, "iteration_s": window_s / iterations,
                             "points_per_iteration":
                             s.w * s.cfg.n_lidar_samples * s.cfg.n_samples_per_ray}
    if run.trace:
        layer["trace"] = s.traced_phases(int(tr["traced_phases"]), n_phases)
        layer["traced_iterations"] = int(tr["traced_phases"]) * n_per_phase
        layer["busy_s"] = getattr(s, "busy_mean_s", layer["trace"].busy_s)
    peak = s.peak()

    s.free()
    reference = s.reference_steps(draw_seed, n_check)
    numbers = compare.readings(program, reference)
    compared = [(name, value, float(run.limits[name])) for name, value in numbers
                if name in run.limits]
    layer["not_compared"] = {name: value for name, value in numbers if name not in run.limits}
    layer["leaves"] = compare.leaf_readings(program, reference)
    layer["losses"] = {"program": program["losses"], "reference": reference["losses"]}
    return Outcome(metrics=metrics, attempted=iterations, failed=0, memory_peak_bytes=int(peak),
                   compared=compared, layer=layer, chips=chips)
