"""Windowed joint pose+map optimization: the mapping hot loop and its host loop.

Counterpart of ``loner_tpu/mapping/optimizer.py``. ``make_phase_runner``: one
iteration samples rays from the device-resident keyframe buffers, builds them
through the pose twists, draws samples with the proposal (or uniform) sampler,
evaluates the Fourier sigma field, composites, takes the JS dynamic-margin loss
plus the proposal's linear loss, and makes one masked multi-LR Adam step over
the sigma, proposal and twist parameters. ``Optimizer``: the host-side loop that
runs a keyframe window through the iteration schedule and writes the
optimised poses back.

Freeze flags are gradient masks, and each phase builds a fresh Adam, as in the
JAX package. The loop is plain Python; ``steps_per_dispatch`` and
``max_inflight_dispatches`` have no effect.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from loner_tpu_torch import convert
from loner_tpu_torch.mapping.loss import LossConfig, compute_lidar_loss
from loner_tpu_torch.mapping.rays import (
    DeviceScanPool, WindowBuffers, build_window_buffers, sample_and_build_rays,
)
from loner_tpu_torch.models.field import FieldConfig, init_field_params
from loner_tpu_torch.models.losses import get_logits_grad
from loner_tpu_torch.models.proposal import (
    ProposalConfig, init_proposal_params, proposal_logits,
)
from loner_tpu_torch.models.rendering import ProposalRaySampler, UniformRaySampler


@dataclass(frozen=True)
class PhaseSettings:
    """One entry of an iteration schedule (cfg/defaults.yaml)."""

    num_iterations: int = 1
    freeze_poses: bool = False
    latest_kf_only: bool = False
    freeze_sigma_mlp: bool = False
    freeze_rgb_mlp: bool = True

    @staticmethod
    def from_dict(d: dict) -> "PhaseSettings":
        return PhaseSettings(
            num_iterations=int(d.get("num_iterations", 1)),
            freeze_poses=bool(d.get("freeze_poses", False)),
            latest_kf_only=bool(d.get("latest_kf_only", False)),
            freeze_sigma_mlp=bool(d.get("freeze_sigma_mlp", False)),
            freeze_rgb_mlp=bool(d.get("freeze_rgb_mlp", True)),
        )


@dataclass(frozen=True)
class OptimizerConfig:
    """Hyper-parameters of the mapping optimization: the JAX package's fields
    that the port's PROPOSAL / UNIFORM, LiDAR-only iteration reads."""

    n_lidar_samples: int = 512
    n_sky_samples: int = 64
    n_samples_per_ray: int = 512
    perturb: float = 1.0
    raw_noise_std: float = 1.0
    lr_sigma: float = 0.01
    lr_pose: float = 0.001
    lr_gamma: float = 1.0
    samples_strategy: str = "OGM"
    rays_strategy: str = "RANDOM"  # or MASK, FIXED
    prop_lr: float = 1e-3
    prop_n_ctrl: int = 0  # 0 = half the sample count
    prop_train_subsample: int = 4
    proposal: ProposalConfig = dc_field(default_factory=ProposalConfig)
    ray_range: Tuple[float, float] = (1.0, 10.0)
    # Keyframe slots of the full window class (the KF#1 bootstrap runs at 1).
    window_size: int = 8
    enable_sky: bool = False
    # Accepted for the JAX package's configs; the port's loop is plain Python.
    steps_per_dispatch: int = 10
    loss: LossConfig = LossConfig()

    @staticmethod
    def from_settings(opt_settings: dict, model_cfg: dict) -> "OptimizerConfig":
        """From reference-format settings dicts (mapper.optimizer and the model
        config); attribute-style settings objects work too, being dicts."""
        render = model_cfg["model"]["render"]
        occ = dict(model_cfg["model"]["occ_model"])
        train = dict(model_cfg["train"])
        rays_strategy = str(opt_settings["rays_selection"]["strategy"])
        if rays_strategy not in ("RANDOM", "MASK", "FIXED"):
            raise RuntimeError(f"Can't find rays_selection strategy: {rays_strategy}")
        return OptimizerConfig(
            n_lidar_samples=int(opt_settings["num_samples"]["lidar"]),
            n_sky_samples=int(opt_settings["num_samples"]["sky"]),
            n_samples_per_ray=int(render["N_samples_train"]),
            perturb=float(render["perturb"]),
            raw_noise_std=float(render["raw_noise_std"]),
            lr_sigma=float(train["lrate_sigma_mlp"]),
            lr_pose=float(train["lrate_pose"]),
            lr_gamma=float(train["lrate_gamma"]),
            samples_strategy=str(opt_settings["samples_selection"]["strategy"]),
            rays_strategy=rays_strategy,
            prop_lr=float(occ.get("prop_lr", 1e-3)),
            prop_n_ctrl=int(occ.get("prop_n_ctrl", 0)),
            prop_train_subsample=int(occ.get("prop_train_subsample", 4)),
            proposal=ProposalConfig.from_settings(occ.get("proposal", {})),
            ray_range=tuple(float(x) for x in model_cfg["model"]["ray_range"]),
            steps_per_dispatch=int(train.get("steps_per_dispatch", 10)),
            loss=LossConfig.from_settings(model_cfg["loss"]),
        )


@dataclass
class StepDraws:
    """The random numbers of one iteration, in place of a generator.

    ray_u:  (W, n_lidar) uniforms that pick the ray indices
    jitter: (B, S) uniforms, the sampler's stratified jitter (perturb > 0)
    noise:  (B, S) standard normals, the sigma noise (raw_noise_std > 0)
    """

    ray_u: torch.Tensor
    jitter: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


def draw_step(generator: torch.Generator, cfg: "OptimizerConfig", window_size: int,
              device: torch.device) -> StepDraws:
    """One iteration's draws from ``generator`` on ``device``."""
    shape = (window_size * cfg.n_lidar_samples, cfg.n_samples_per_ray)
    return StepDraws(
        ray_u=torch.rand((window_size, cfg.n_lidar_samples), generator=generator, device=device),
        jitter=torch.rand(shape, generator=generator, device=device) if cfg.perturb > 0 else None,
        noise=torch.randn(shape, generator=generator, device=device)
        if cfg.raw_noise_std > 0 else None,
    )


def iteration_loss(cfg: "OptimizerConfig", field_cfg: FieldConfig, sigma: Dict[str, Any],
                   proposal: Optional[Dict[str, Any]], twists: torch.Tensor,
                   intensity: Dict[str, Any], buffers: WindowBuffers, world_scale,
                   world_shift: torch.Tensor, draws: StepDraws, it_idx: float = 0.0,
                   global_step: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One iteration's forward: rays, samples, field, compositing, the mapping
    loss and (PROPOSAL) the proposal's linear loss. Returns (total, aux);
    ``aux["loss"]`` is the mapping loss alone."""
    use_prop = cfg.samples_strategy == "PROPOSAL"
    sampler = ProposalRaySampler(n_ctrl=cfg.prop_n_ctrl or None) if use_prop else UniformRaySampler()
    rays, depths_cube, valid = sample_and_build_rays(
        buffers, twists, world_scale, world_shift, cfg.ray_range, cfg.n_lidar_samples, 0,
        u=draws.ray_u, fixed_indices=cfg.rays_strategy == "FIXED",
    )
    loss, aux = compute_lidar_loss(
        rays, depths_cube, valid, {"sigma": sigma, "intensity": intensity}, field_cfg, sampler,
        proposal if use_prop else None, cfg.loss, world_scale, cfg.n_samples_per_ray,
        cfg.perturb, cfg.raw_noise_std, it_idx, global_step, jitter=draws.jitter,
        noise=draws.noise,
    )
    if use_prop:
        # Proposal training: the linear loss mean(stop_grad(logits_grad) *
        # logits) over a strided subset of the sample points, normalised by the
        # valid rays; its gradient reaches only the proposal weights.
        sub = max(int(cfg.prop_train_subsample), 1)
        z_sub = aux["z_m"][:, ::sub].detach()
        logits_grad = get_logits_grad(z_sub, aux["depths_gt_m"][:, None].detach())
        logits_grad = logits_grad * aux["valid"][:, None]
        logits = proposal_logits(proposal, aux["points"][:, ::sub].detach())
        denom = torch.clamp(aux["valid"].sum().to(logits.dtype) * z_sub.shape[1], min=1.0)
        loss = loss + (logits_grad * logits).sum() / denom
    return loss, aux


def make_phase_runner(cfg: OptimizerConfig, field_cfg: FieldConfig, phase: PhaseSettings,
                      window_size: int, point_pad: int, sky_pad: int,
                      device: torch.device, extras_mode: str = "none"):
    """Build the runner of one optimization phase.

    ``run_phase(field_params, proposal_params, twists, buffers, pose_mask,
    world_scale, world_shift, global_step0, generator, num_iterations=None,
    draws=None)`` returns ``(field_params, proposal_params, twists, losses,
    depth_eps)``, the last two with one entry per iteration. ``draws`` is a
    sequence of ``StepDraws``, one per iteration; without it the draws come
    from ``generator`` on ``device``. ``point_pad`` and ``sky_pad`` are the
    buffers' padded sizes, kept for the JAX package's signature.
    """
    if cfg.samples_strategy == "OGM":
        raise NotImplementedError("the OGM occupancy-grid sampler is not ported yet")
    if cfg.samples_strategy not in ("PROPOSAL", "UNIFORM"):
        raise ValueError(f"unknown samples_strategy {cfg.samples_strategy!r}")
    if not phase.freeze_rgb_mlp:
        raise NotImplementedError("camera / intensity phases are not ported yet")
    if extras_mode != "none":
        raise NotImplementedError("per-iteration debug records are not ported yet")
    if cfg.enable_sky and cfg.n_sky_samples > 0:
        raise NotImplementedError("sky rays are not ported yet")
    if cfg.rays_strategy not in ("RANDOM", "MASK", "FIXED"):
        raise RuntimeError(f"Can't find rays_selection strategy: {cfg.rays_strategy}")

    use_prop = cfg.samples_strategy == "PROPOSAL"
    optimize_poses = not phase.freeze_poses
    optimize_sigma = not phase.freeze_sigma_mlp

    def run_phase(field_params: Dict[str, Any], proposal_params: Optional[Dict[str, Any]],
                  twists: torch.Tensor, buffers: WindowBuffers, pose_mask: torch.Tensor,
                  world_scale, world_shift: torch.Tensor, global_step0: int,
                  generator: Optional[torch.Generator], num_iterations: Optional[int] = None,
                  draws: Optional[Sequence[StepDraws]] = None):
        n_iters = phase.num_iterations if num_iterations is None else num_iterations
        if draws is None and generator is None:
            raise ValueError("run_phase needs a generator or the draws")
        if draws is not None and len(draws) < n_iters:
            raise ValueError(f"{len(draws)} draws for {n_iters} iterations")

        def leaf(t: torch.Tensor) -> torch.Tensor:
            return t.detach().clone().requires_grad_(True)

        sigma = {"mlp": {k: leaf(v) for k, v in field_params["sigma"]["mlp"].items()}}
        tw = leaf(twists)
        groups = [
            {"params": list(sigma["mlp"].values()), "lr": cfg.lr_sigma},
            {"params": [tw], "lr": cfg.lr_pose},
        ]
        proposal = None
        if use_prop:
            # ``bmat`` is a fixed projection, never trained: it stays out of Adam.
            proposal = {k: v.detach() if k == "bmat" else leaf(v)
                        for k, v in proposal_params.items()}
            groups.append({"params": [v for k, v in proposal.items() if k != "bmat"],
                           "lr": cfg.prop_lr})
        adam = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
        schedule = None
        if cfg.lr_gamma != 1.0:
            decay = lambda step: cfg.lr_gamma ** step  # noqa: E731
            lambdas = [decay, decay] + ([lambda step: 1.0] if use_prop else [])
            schedule = torch.optim.lr_scheduler.LambdaLR(adam, lambdas)
        params: List[torch.Tensor] = [p for g in groups for p in g["params"]]
        mask = pose_mask.to(tw.dtype)[:, None]
        step0 = int(global_step0)

        losses, eps_log = [], []
        for i in range(n_iters):
            d = draws[i] if draws is not None else draw_step(generator, cfg, window_size, device)
            for p in params:
                p.grad = None
            total, aux = iteration_loss(cfg, field_cfg, sigma, proposal, tw,
                                        field_params["intensity"], buffers, world_scale,
                                        world_shift, d, float(i), float(step0 + i))
            total.backward()
            # Freezing is a gradient mask: every parameter gets a gradient (zero
            # where frozen), so Adam's moments move as the JAX package's do.
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            tw.grad.mul_(mask)
            if not optimize_poses:
                tw.grad.zero_()
            if not optimize_sigma:
                for p in sigma["mlp"].values():
                    p.grad.zero_()
            adam.step()
            if schedule is not None:
                schedule.step()
            # The mapping loss is reported, not the total with the proposal term.
            losses.append(aux["loss"].detach())
            eps_log.append(aux["depth_eps"].detach())

        new_field = {
            "sigma": {"mlp": {k: v.detach() for k, v in sigma["mlp"].items()}},
            "intensity": field_params["intensity"],
        }
        new_prop = {k: v.detach() for k, v in proposal.items()} if use_prop else proposal_params
        stack = lambda xs: torch.stack(xs) if xs else torch.zeros((0,), device=device)  # noqa: E731
        return new_field, new_prop, tw.detach(), stack(losses), stack(eps_log)

    return run_phase


@dataclass
class MapState:
    """The optimiser's device state: field params, proposal params (None for
    the uniform sampler) and the iteration count over the whole run."""

    field_params: Dict[str, Any]
    occ_grid: Optional[Dict[str, Any]]
    global_step: int = 0


_DEBUG_DUMPS = ("log_losses", "write_ray_point_clouds", "store_ray", "draw_samples",
                "draw_rays_eps")


class Optimizer:
    """Host side: the keyframe schedule, the phase-runner cache and the map
    state on one torch device.

    Counterpart of ``loner_tpu/mapping/optimizer.py::Optimizer``: runs a
    keyframe window through its iteration schedule (``iterate_optimizer``) and
    writes the optimised poses back into the keyframes. The random draws come
    from a ``torch.Generator`` on the device, seeded with ``seed``."""

    def __init__(
        self,
        cfg: OptimizerConfig,
        field_cfg: FieldConfig,
        world_scale: float,
        world_shift: np.ndarray,
        keyframe_schedule: List[dict],
        device: torch.device,
        skip_pose_refinement: bool = True,
        use_gt_poses: bool = False,
        freeze_poses: bool = False,
        seed: int = 0,
        log_directory: Optional[str] = None,
        profile_optimizer: bool = False,
        **debug_dumps: bool,
    ) -> None:
        unknown = sorted(set(debug_dumps) - set(_DEBUG_DUMPS))
        if unknown:
            raise TypeError(f"unexpected arguments {unknown}")
        asked = sorted(k for k, v in debug_dumps.items() if v)
        if asked:
            raise NotImplementedError(f"debug dumps {asked} are not ported")
        self._cfg = cfg
        self._field_cfg = field_cfg
        self._device = torch.device(device)
        self._world_scale = torch.tensor(float(world_scale), device=self._device)
        self._world_shift = torch.from_numpy(np.asarray(world_shift, np.float32)).to(self._device)
        self._keyframe_schedule = keyframe_schedule
        self._skip_pose_refinement = skip_pose_refinement
        self._use_gt_poses = use_gt_poses
        self._freeze_poses = freeze_poses
        self._log_directory = log_directory
        self._profile_optimizer = profile_optimizer

        self._generator = torch.Generator(device=self._device).manual_seed(int(seed))
        self.state = MapState(*self._init_state(self._generator))
        self._keyframe_count = 0
        self._runner_cache: Dict[tuple, Any] = {}
        self._scan_pool = DeviceScanPool(self._device)
        self.last_losses: Optional[np.ndarray] = None
        self.last_depth_eps: Optional[np.ndarray] = None

    def _init_state(self, generator: torch.Generator):
        field_params = init_field_params(generator, self._field_cfg, self._device)
        occ = (init_proposal_params(generator, self._cfg.proposal, self._device)
               if self._cfg.samples_strategy == "PROPOSAL" else None)
        return field_params, occ

    def restore(self, field_params, occ_state, global_step: int, keyframe_count: int) -> None:
        """Seat the map state from numpy trees in the JAX package's layout (a
        checkpoint's ``network_state_dict`` and ``occ_model_state_dict``). Adam
        state is not restored: each schedule phase builds a fresh Adam."""
        self.state.field_params = convert.field_params_from_jax(field_params, self._device)
        if occ_state is not None:
            self.state.occ_grid = convert.proposal_params_from_jax(occ_state, self._device)
        self.state.global_step = int(global_step)
        self._keyframe_count = int(keyframe_count)

    # -- schedule ------------------------------------------------------------
    def _select_schedule(self) -> List[PhaseSettings]:
        """The iteration schedule for the current keyframe count."""
        cumulative = 0
        schedule = self._keyframe_schedule[-1]["iteration_schedule"]
        for item in self._keyframe_schedule:
            cumulative += item["num_keyframes"]
            if cumulative >= self._keyframe_count + 1 or item["num_keyframes"] == -1:
                schedule = item["iteration_schedule"]
                break
        phases = [PhaseSettings.from_dict(p) for p in schedule]
        if len(phases) > 1 and self._skip_pose_refinement:
            phases = phases[1:]
        return phases

    def _effective_phase(self, phase: PhaseSettings) -> PhaseSettings:
        freeze = phase.freeze_poses or self._freeze_poses or self._use_gt_poses
        return replace(phase, freeze_poses=freeze)

    def _get_runner(self, phase: PhaseSettings, w: int, p: int, ps: int):
        # num_iterations is an argument of the runner, not part of its key.
        cache_key = (replace(phase, num_iterations=0), w, p, ps)
        if cache_key not in self._runner_cache:
            self._runner_cache[cache_key] = make_phase_runner(
                self._cfg, self._field_cfg, phase, w, p, ps, self._device)
        return self._runner_cache[cache_key]

    def _window_classes_for_item(self, first_kf: int, last_kf: Optional[int]) -> set:
        """Window sizes a schedule item can run at: KF#k optimises a window of
        min(k, W) keyframes, so only the item covering KF#1 sees the
        1-keyframe (bootstrap) class; every later one runs the full width."""
        classes = set()
        if first_kf == 1:
            classes.add(1)
        if last_kf is None or last_kf >= 2:
            classes.add(self._cfg.window_size)
        return classes

    def warm_up(self, n_points: int) -> float:
        """Build the CUDA kernels (on a CUDA device) and run one iteration of
        every phase runner the keyframe schedule can reach, on dummy state:
        kernels, cuBLAS handles and the allocator are then ready before the
        first keyframe. Returns the seconds spent."""
        t0 = time.time()
        if self._device.type == "cuda" and self._field_cfg.sigma_kernel == "fused":
            from loner_tpu_torch.ops import fourier_mlp

            fourier_mlp._lib()
        rng = np.random.default_rng(0)
        d = rng.normal(size=(3, max(int(n_points), 1))).astype(np.float32)
        d /= np.linalg.norm(d, axis=0, keepdims=True) + 1e-9
        lo, hi = sorted(self._cfg.ray_range)
        depths = rng.uniform(lo + 0.1, hi - 0.1, d.shape[1]).astype(np.float32)

        needed: Dict[tuple, PhaseSettings] = {}
        first_kf = 1
        for item in self._keyframe_schedule:
            nk = int(item["num_keyframes"])
            last_kf = None if nk == -1 else first_kf + nk - 1
            classes = self._window_classes_for_item(first_kf, last_kf)
            first_kf = first_kf if last_kf is None else last_kf + 1
            phases = [PhaseSettings.from_dict(ph) for ph in item["iteration_schedule"]]
            if len(phases) > 1 and self._skip_pose_refinement:
                phases = phases[1:]
            for phase in phases:
                eff = self._effective_phase(phase)
                for w in classes:
                    needed[(replace(eff, num_iterations=0), w)] = eff

        dummy = torch.Generator(device=self._device).manual_seed(17)
        field_params, occ = self._init_state(dummy)
        losses = []
        for (_, w), eff in needed.items():
            buffers = build_window_buffers([d] * w, [depths] * w, [None] * w, w,
                                           device=self._device)
            runner = self._get_runner(eff, w, buffers.dirs.shape[1], buffers.sky_dirs.shape[1])
            out = runner(field_params, occ, torch.zeros((w, 6), device=self._device), buffers,
                         torch.ones((w,), device=self._device), self._world_scale,
                         self._world_shift, 0, dummy, num_iterations=1)
            losses.append(out[3])
        if losses:
            torch.cat(losses).cpu()  # waits for the device
        return time.time() - t0

    # -- main entry ------------------------------------------------------------
    def iterate_optimizer(self, window: list) -> float:
        """Run the iteration schedule on a window of keyframes
        (``mapping.keyframe.KeyFrame``) and write the optimised poses back into
        them. Returns the last iteration's mapping loss."""
        from loner_tpu_torch.runtime.profiling import optimizer_trace

        start_time = time.time()
        if len(window) == 1:
            window[0].is_anchored = True
        phases = self._select_schedule()
        num_its = sum(p.num_iterations for p in phases)

        m = len(window)
        # A 1-keyframe window (the KF#1 bootstrap) runs a W = 1 runner: the
        # full width would spend all but one slot on masked-out replicas.
        w = 1 if m == 1 else self._cfg.window_size
        buffers = self._scan_pool.build_window(window, w, self._cfg.rays_strategy == "MASK")
        p, ps = buffers.dirs.shape[1], buffers.sky_dirs.shape[1]

        twists = np.zeros((w, 6), np.float32)
        anchored = np.zeros((w,), np.float32)
        for i in range(w):
            j = min(i, m - 1)
            twists[i] = window[j].pose_twist(self._use_gt_poses)
            anchored[i] = 1.0 if (window[j].is_anchored or i >= m) else 0.0
        twists = torch.from_numpy(twists).to(self._device)

        all_losses, all_eps = [], []
        with optimizer_trace(self._log_directory, self._profile_optimizer, self._keyframe_count):
            for phase in phases:
                eff = self._effective_phase(phase)
                pose_mask = 1.0 - anchored
                if eff.latest_kf_only:
                    latest_only = np.zeros_like(pose_mask)
                    latest_only[m - 1] = 1.0
                    pose_mask = pose_mask * latest_only
                runner = self._get_runner(eff, w, p, ps)
                (self.state.field_params, self.state.occ_grid, twists, losses, eps) = runner(
                    self.state.field_params, self.state.occ_grid, twists, buffers,
                    torch.from_numpy(pose_mask).to(self._device), self._world_scale,
                    self._world_shift, self.state.global_step, self._generator,
                    num_iterations=eff.num_iterations,
                )
                self.state.global_step += eff.num_iterations
                all_losses.append(losses)
                all_eps.append(eps)

        # One copy to the host for the poses and the phase's loss logs.
        host = torch.cat([twists.reshape(-1)] + all_losses + all_eps).cpu().numpy()
        twists_np = host[: w * 6].reshape(w, 6)
        n_log = sum(int(x.numel()) for x in all_losses)
        self.last_losses = host[w * 6 : w * 6 + n_log]
        self.last_depth_eps = host[w * 6 + n_log :]
        if not np.isfinite(twists_np).all():
            raise RuntimeError("Fatal: Encountered invalid pose tensor.")
        if not np.isfinite(self.last_losses).all():
            raise RuntimeError("NaN Loss Encountered")

        if not self._use_gt_poses:
            for i, kf in enumerate(window):
                kf.set_pose_twist(twists_np[i])

        elapsed = time.time() - start_time
        if self._log_directory is not None:
            with open(f"{self._log_directory}/timing.csv", "a+") as f:
                f.write(f"{num_its},{elapsed}\n")
        self._keyframe_count += 1
        return float(self.last_losses[-1]) if self.last_losses.size else float("nan")
