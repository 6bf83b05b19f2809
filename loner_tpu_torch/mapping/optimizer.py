"""Windowed joint pose+map optimization: the mapping hot loop.

Counterpart of ``make_phase_runner`` in ``loner_tpu/mapping/optimizer.py``. One
iteration samples rays from the device-resident keyframe buffers, builds them
through the pose twists, draws samples with the proposal (or uniform) sampler,
evaluates the Fourier sigma field, composites, takes the JS dynamic-margin loss
plus the proposal's linear loss, and makes one masked multi-LR Adam step over
the sigma, proposal and twist parameters.

Freeze flags are gradient masks, and each phase builds a fresh Adam, as in the
JAX package. The loop is plain Python; ``steps_per_dispatch`` has no effect.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from loner_tpu_torch.mapping.loss import LossConfig, compute_lidar_loss
from loner_tpu_torch.mapping.rays import WindowBuffers, sample_and_build_rays
from loner_tpu_torch.models.field import FieldConfig
from loner_tpu_torch.models.losses import get_logits_grad
from loner_tpu_torch.models.proposal import ProposalConfig, proposal_logits
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
