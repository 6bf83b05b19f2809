"""Windowed joint pose+map optimization: the mapping hot loop and its host loop.

Counterpart of ``loner_tpu/mapping/optimizer.py``. ``make_phase_runner``: one
iteration samples rays from the device-resident keyframe buffers, builds them
through the pose twists, draws samples with the occupancy-grid (OGM), proposal
or uniform sampler, evaluates the sigma field (hash grid or Fourier), composites,
takes the JS dynamic-margin loss (plus the proposal's linear loss and, in a
phase that trains the intensity head, the camera loss over pixels drawn from
the window's images), and makes one masked multi-LR Adam step over the sigma
(MLP and hash table), proposal, twist and (unfrozen) intensity parameters;
every ``occ_update_every`` global steps the OGM grid then takes one SGD step. ``Optimizer``: the host-side loop that runs a keyframe
window through the iteration schedule and writes the optimised poses back.

Freeze flags are gradient masks, and each phase starts a fresh Adam, as in the
JAX package. A phase runs as the JAX package dispatches it (``run_dispatches``):
``n // k`` dispatches of k = ``steps_per_dispatch`` iterations, then the rest
one by one, with at most ``max_inflight_dispatches`` dispatches in flight. On a
CUDA device the runner (``mapping/phase_graph.py``) replays one captured CUDA
graph of the iteration k times a dispatch; on the CPU it runs the same
iterations eagerly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch import convert
from loner_tpu_torch.mapping.loss import (
    LossConfig, compute_camera_loss, compute_lidar_loss, opaque_rays,
)
from loner_tpu_torch.mapping.rays import (
    CameraWindowBuffers, DeviceScanPool, WindowBuffers, build_camera_window_buffers,
    build_window_buffers, pack_camera_images, sample_and_build_camera_rays, sample_and_build_rays,
)
from loner_tpu_torch.models.field import FieldConfig, init_field_params
from loner_tpu_torch.models.losses import get_logits_grad
from loner_tpu_torch.models.occupancy_grid import init_occ_grid
from loner_tpu_torch.models.proposal import (
    ProposalConfig, init_proposal_params, proposal_logits,
)
from loner_tpu_torch.models.rendering import (
    OccGridRaySampler, ProposalRaySampler, UniformRaySampler,
)

ENCODE_DTYPES = {"vjp_bf16": torch.bfloat16, "vjp_f32": torch.float32, "xla": torch.float32}


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
    that the port's iteration reads."""

    n_lidar_samples: int = 512
    n_sky_samples: int = 64
    n_samples_per_ray: int = 512
    perturb: float = 1.0
    raw_noise_std: float = 1.0
    lr_sigma: float = 0.01
    lr_pose: float = 0.001
    lr_gamma: float = 1.0
    samples_strategy: str = "OGM"  # OGM, PROPOSAL or UNIFORM
    rays_strategy: str = "RANDOM"  # or MASK, FIXED
    occ_voxel_size: int = 100
    occ_lr: float = 1e-4
    occ_update_every: int = 10
    prop_lr: float = 1e-3
    prop_n_ctrl: int = 0  # 0 = half the sample count
    prop_train_subsample: int = 4
    proposal: ProposalConfig = dc_field(default_factory=ProposalConfig)
    ray_range: Tuple[float, float] = (1.0, 10.0)
    # Keyframe slots of the full window class (the KF#1 bootstrap runs at 1).
    window_size: int = 8
    enable_sky: bool = False
    # The hash training encode: vjp_bf16 takes the kernel pair in bf16; vjp_f32
    # and xla (JAX's autodiff oracle of the same function) take it in f32.
    encode_impl: str = "vjp_bf16"
    # Iterations per dispatch: k replays of the captured iteration on the card
    # (the JAX package's lax.scan of k steps); the remainder of a phase runs as
    # single steps.
    steps_per_dispatch: int = 10
    # Dispatches in flight on the device queue (0: unbounded): before dispatch
    # n is enqueued, dispatch n - d has finished, so a tracker ICP queued beside
    # the mapper waits behind at most d dispatches.
    max_inflight_dispatches: int = 2
    # Camera pixels per window slot in an iteration of a phase that trains the
    # intensity head (freeze_rgb_mlp: False); 0 builds no camera branch.
    n_camera_samples: int = 0
    cameraloss_lambda: float = 1.0
    # Camera rays from detached poses (no pose gradient from the camera loss),
    # and the camera loss's gradient into the sigma field (False: it reaches it).
    detach_rgb_from_poses: bool = True
    detach_rgb_from_sigma: bool = False
    lr_rgb: float = 0.01
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
            occ_voxel_size=int(occ.get("voxel_size", 100)),
            occ_lr=float(occ.get("lr", 1e-4)),
            occ_update_every=int(occ.get("N_iters_acc", 10)),
            prop_lr=float(occ.get("prop_lr", 1e-3)),
            prop_n_ctrl=int(occ.get("prop_n_ctrl", 0)),
            prop_train_subsample=int(occ.get("prop_train_subsample", 4)),
            proposal=ProposalConfig.from_settings(occ.get("proposal", {})),
            ray_range=tuple(float(x) for x in model_cfg["model"]["ray_range"]),
            encode_impl=str(train.get("encode_impl", "vjp_bf16")),
            steps_per_dispatch=int(train.get("steps_per_dispatch", 10)),
            max_inflight_dispatches=int(train.get("max_inflight_dispatches", 2)),
            n_camera_samples=int(dict(opt_settings["num_samples"]).get("camera", 0)),
            cameraloss_lambda=float(dict(model_cfg["loss"]).get("cameraloss_lambda", 1.0)),
            detach_rgb_from_poses=bool(dict(opt_settings).get("detach_rgb_from_poses", True)),
            detach_rgb_from_sigma=bool(dict(opt_settings).get("detach_rgb_from_sigma", False)),
            lr_rgb=float(train.get("lrate_rgb", 0.01)),
            loss=LossConfig.from_settings(model_cfg["loss"]),
        )


@dataclass
class StepDraws:
    """The random numbers of one iteration, in place of a generator.

    ray_u:  (W, n_lidar) uniforms that pick the ray indices
    jitter: (B, S) uniforms, the sampler's stratified jitter (perturb > 0); (B, S/2)
            for the OGM sampler, whose stratified half it jitters
    noise:  (B, S) standard normals, the sigma noise (raw_noise_std > 0)
    pdf_u:  (B, S/2) uniforms of the OGM sampler's importance half
    sky_u:  (W, n_sky) uniforms that pick the sky directions (sky rays on)
    cam_u, cam_jitter, cam_pdf_u: the camera branch's pixel picks (W, n_camera)
            and its sampler's draws, shaped as jitter and pdf_u for B_cam =
            W * n_camera rays (a phase that trains the intensity head)

    B = W * (n_lidar + n_sky) rays.
    """

    ray_u: torch.Tensor
    jitter: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    pdf_u: Optional[torch.Tensor] = None
    sky_u: Optional[torch.Tensor] = None
    cam_u: Optional[torch.Tensor] = None
    cam_jitter: Optional[torch.Tensor] = None
    cam_pdf_u: Optional[torch.Tensor] = None


def sky_rays_per_slot(cfg: "OptimizerConfig") -> int:
    """Sky rays per window slot in an iteration: 0 unless sky rays are on."""
    return cfg.n_sky_samples if cfg.enable_sky else 0


def draw_step(generator: torch.Generator, cfg: "OptimizerConfig", window_size: int,
              device: torch.device, camera: bool = False) -> StepDraws:
    """One iteration's draws from ``generator`` on ``device``; with ``camera``,
    the camera branch's too."""
    n_sky = sky_rays_per_slot(cfg)
    b, s = window_size * (cfg.n_lidar_samples + n_sky), cfg.n_samples_per_ray
    ogm = cfg.samples_strategy == "OGM"
    draws = StepDraws(
        ray_u=torch.empty((window_size, cfg.n_lidar_samples), device=device),
        jitter=torch.empty((b, s // 2 if ogm else s), device=device) if cfg.perturb > 0 else None,
        noise=torch.empty((b, s), device=device) if cfg.raw_noise_std > 0 else None,
        pdf_u=torch.empty((b, s // 2), device=device) if ogm else None,
        sky_u=torch.empty((window_size, n_sky), device=device) if n_sky else None,
    )
    if camera:
        bc = window_size * cfg.n_camera_samples
        draws.cam_u = torch.empty((window_size, cfg.n_camera_samples), device=device)
        if cfg.perturb > 0:
            draws.cam_jitter = torch.empty((bc, s // 2 if ogm else s), device=device)
        if ogm:
            draws.cam_pdf_u = torch.empty((bc, s // 2), device=device)
    return fill_draws(draws, generator)


# The order of the draws. ``sky_u`` and the camera's come last, so a
# configuration without them draws the same numbers whether or not the port has
# them.
DRAW_FIELDS = ("ray_u", "jitter", "noise", "pdf_u", "sky_u", "cam_u", "cam_jitter", "cam_pdf_u")


def fill_draws(draws: StepDraws, generator: torch.Generator) -> StepDraws:
    """Draw into ``draws``' tensors in place, in a fixed order: what
    ``torch.rand`` and ``torch.randn`` give from the same generator state. The
    captured draw graph is this call."""
    for name in DRAW_FIELDS:
        t = getattr(draws, name)
        if t is None:
            continue
        if name == "noise":
            t.normal_(generator=generator)
        else:
            t.uniform_(generator=generator)
    return draws


def fused_steps(cfg: "OptimizerConfig", extras_mode: str = "none") -> int:
    """Iterations per dispatch (the JAX package's ``fused_steps``): 1 with the
    full per-iteration debug record, else ``steps_per_dispatch``."""
    if extras_mode == "full":
        return 1
    return max(int(cfg.steps_per_dispatch), 1)


def run_dispatches(n_iters: int, k: int, depth: int, dispatch: Callable[[int, int], None],
                   make_event: Optional[Callable[[], Any]] = None) -> None:
    """The JAX package's dispatch schedule of a phase: with k > 1, ``n_iters //
    k`` dispatches ``dispatch(i0, k)`` of k iterations from i0, then the rest as
    ``dispatch(i, 1)``. After each k-dispatch an event (``make_event()``) is
    recorded; before dispatch n is enqueued, the event of dispatch n - depth is
    waited on (depth 0, or no events: never)."""
    events: List[Any] = []
    i = 0
    if k > 1:
        while i + k <= n_iters:
            if depth and len(events) >= depth:
                events[len(events) - depth].synchronize()
            dispatch(i, k)
            if make_event is not None:
                event = make_event()
                event.record()
                events.append(event)
            i += k
    while i < n_iters:
        dispatch(i, 1)
        i += 1


def training_field_cfg(cfg: "OptimizerConfig", field_cfg: FieldConfig) -> FieldConfig:
    """The field config a training iteration runs: the hash encode in the
    compute dtype that ``cfg.encode_impl`` names."""
    if cfg.encode_impl not in ENCODE_DTYPES:
        raise RuntimeError(f"Unrecognized encode_impl '{cfg.encode_impl}' "
                           "(expected xla, vjp_bf16, or vjp_f32)")
    return replace(field_cfg, hash_encode_dtype=ENCODE_DTYPES[cfg.encode_impl])


def iteration_loss(cfg: "OptimizerConfig", field_cfg: FieldConfig, sigma: Dict[str, Any],
                   occ_state, twists: torch.Tensor, intensity: Dict[str, Any],
                   buffers: WindowBuffers, world_scale, world_shift: torch.Tensor,
                   draws: StepDraws, it_idx: float = 0.0, global_step: float = 0.0,
                   camera: Optional[CameraWindowBuffers] = None, shard=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One iteration's forward: rays, samples, field, compositing, the mapping
    loss, (PROPOSAL) the proposal's linear loss and, with ``camera`` buffers,
    ``cameraloss_lambda`` times the camera loss (``aux["camera_loss"]``).
    ``occ_state`` is the OGM grid or the proposal params. Returns (total, aux);
    ``aux["loss"]`` is the mapping loss alone.

    ``shard``: a mesh rank's part of the window (``parallel/mesh.py::
    WindowShard``); ``buffers`` then hold its shard, ``twists`` and ``draws`` the
    whole window's, and every loss term is this rank's share of the window's."""
    use_prop = cfg.samples_strategy == "PROPOSAL"
    if cfg.samples_strategy == "OGM":
        sampler = OccGridRaySampler()
    elif use_prop:
        sampler = ProposalRaySampler(n_ctrl=cfg.prop_n_ctrl or None)
    else:
        sampler = UniformRaySampler()
    tw, gather = twists, None
    if shard is not None:
        draws, tw, gather = shard.draws(draws), shard.slot_rows(twists), shard.gather
    rays, depths_cube, valid = sample_and_build_rays(
        buffers, tw, world_scale, world_shift, cfg.ray_range, cfg.n_lidar_samples,
        sky_rays_per_slot(cfg), u=draws.ray_u, fixed_indices=cfg.rays_strategy == "FIXED",
        sky_u=draws.sky_u, gather=gather,
    )
    window = cam = None
    if shard is not None:
        rays, depths_cube, valid = (t[shard.rays] for t in (rays, depths_cube, valid))
        if camera is not None:
            cam = _camera_rays(cfg, shard.camera(camera), tw, world_scale, world_shift,
                               buffers.slot_valid, draws.cam_u)
            cam = tuple(t[shard.cam_rays] for t in cam)
        window = shard.window_counts(opaque_rays(depths_cube, rays[:, 10], valid), valid,
                                     None if cam is None else cam[2])
    loss, aux = compute_lidar_loss(
        rays, depths_cube, valid, {"sigma": sigma, "intensity": intensity}, field_cfg, sampler,
        occ_state, cfg.loss, world_scale, cfg.n_samples_per_ray, cfg.perturb,
        cfg.raw_noise_std, it_idx, global_step, jitter=draws.jitter, noise=draws.noise,
        pdf_u=draws.pdf_u, window=window,
    )
    if use_prop:
        # Proposal training: the linear loss mean(stop_grad(logits_grad) *
        # logits) over a strided subset of the sample points, normalised by the
        # valid rays; its gradient reaches only the proposal weights.
        sub = max(int(cfg.prop_train_subsample), 1)
        z_sub = aux["z_m"][:, ::sub].detach()
        logits_grad = get_logits_grad(z_sub, aux["depths_gt_m"][:, None].detach())
        logits_grad = logits_grad * aux["valid"][:, None]
        logits = proposal_logits(occ_state, aux["points"][:, ::sub].detach())
        n_valid = aux["valid"].sum().to(logits.dtype) if window is None else window["valid"]
        denom = torch.clamp(n_valid * z_sub.shape[1], min=1.0)
        loss = loss + (logits_grad * logits).sum() / denom
    if camera is not None:
        if cam is None:
            cam = _camera_rays(cfg, camera, twists, world_scale, world_shift, buffers.slot_valid,
                               draws.cam_u)
        cam_rays, cam_intens, cam_valid = cam
        cam_mse, _ = compute_camera_loss(
            cam_rays, cam_intens, cam_valid, {"sigma": sigma, "intensity": intensity}, field_cfg,
            sampler, occ_state, cfg.n_samples_per_ray, cfg.perturb,
            detach_sigma=cfg.detach_rgb_from_sigma, jitter=draws.cam_jitter,
            pdf_u=draws.cam_pdf_u, count=None if window is None else window["camera"])
        aux["camera_loss"] = cam_mse
        loss = loss + cfg.cameraloss_lambda * cam_mse
    return loss, aux


def _camera_rays(cfg: "OptimizerConfig", camera: CameraWindowBuffers, twists: torch.Tensor,
                 world_scale, world_shift: torch.Tensor, slot_valid: torch.Tensor,
                 cam_u: torch.Tensor):
    return sample_and_build_camera_rays(
        camera, twists, world_scale, world_shift, cfg.ray_range, cfg.n_camera_samples,
        slot_valid, cam_u, detach_poses=cfg.detach_rgb_from_poses)


def make_phase_runner(cfg: OptimizerConfig, field_cfg: FieldConfig, phase: PhaseSettings,
                      window_size: int, point_pad: int, sky_pad: int,
                      device: torch.device, extras_mode: str = "none",
                      graphs: Optional[bool] = None, window: Optional[WindowBuffers] = None,
                      pool=None, has_camera: bool = True,
                      camera: Optional[CameraWindowBuffers] = None, mesh=None):
    """Build the runner of one optimization phase (a ``phase_graph.PhaseProgram``).

    ``run_phase(field_params, occ_state, twists, buffers, pose_mask, world_scale,
    world_shift, global_step0, generator, num_iterations=None, draws=None)``
    returns ``(field_params, occ_state, twists, losses, depth_eps)``, the last two
    with one entry per iteration. ``occ_state`` is the OGM grid, the proposal
    params or None (UNIFORM). ``draws`` is a sequence of ``StepDraws``, one per
    iteration; without it the draws come from ``generator`` on ``device``.
    ``point_pad`` and ``sky_pad`` are the buffers' padded sizes, kept for the JAX
    package's signature.

    ``graphs``: replay a captured CUDA graph of the iteration (the default on a
    CUDA device, unless a gloo mesh's collectives are in it; the CPU has none).
    ``graphs=False`` on the card runs the same iterations eagerly, for
    comparisons and profiles. ``window`` and ``pool``:
    static window buffers and a graph memory pool shared with other runners.

    A phase with ``freeze_rgb_mlp: False`` trains the intensity head (its own
    Adam group at ``lr_rgb``); with ``n_camera_samples`` > 0 and camera geometry
    (``has_camera``: the JAX package's flag; a run without a calibrated camera
    builds no camera branch) its iterations add the camera loss, and
    ``run_phase`` then takes ``camera=`` buffers (``CameraWindowBuffers``).
    ``camera``: static camera buffers shared with other runners.

    ``mesh``: a running mesh (``parallel/mesh.py::Mesh``) whose ranks each run
    this runner on the same arguments: each computes its shard of every
    iteration, and all return the one-device results (see ``PhaseProgram``).

    ``extras_mode``: ``"ray"`` records each iteration's rays, depths, JS
    scores, spreads and validity; ``"full"`` adds the sample points, predicted
    and target weights, sample depths and per-ray margins and runs one
    iteration a dispatch (the JAX package's modes). ``run_phase(...,
    extras_log=sink)`` then appends one dict of numpy arrays a dispatch, each
    stacked (k, B, ...), to ``sink``.
    """
    from loner_tpu_torch.mapping.phase_graph import PhaseProgram

    if cfg.samples_strategy not in ("OGM", "PROPOSAL", "UNIFORM"):
        raise ValueError(f"unknown samples_strategy {cfg.samples_strategy!r}")
    if cfg.rays_strategy not in ("RANDOM", "MASK", "FIXED"):
        raise RuntimeError(f"Can't find rays_selection strategy: {cfg.rays_strategy}")
    device = torch.device(device)
    # A gloo collective cannot be captured: a gloo mesh on cards runs eagerly.
    capturable = device.type == "cuda" and (mesh is None or mesh.spec.backend == "nccl")
    if graphs is None:
        graphs = capturable
    if graphs and not capturable:
        raise ValueError(f"CUDA graphs need a CUDA device and, under a mesh, NCCL; not {device}"
                         + ("" if mesh is None else f" with {mesh.spec.backend}"))
    return PhaseProgram(cfg, field_cfg, phase, window_size, device, graphs=graphs,
                        extras_mode=extras_mode, window=window, pool=pool,
                        has_camera=has_camera, camera=camera, mesh=mesh)


@dataclass
class MapState:
    """The optimiser's device state: field params, the sampler's state (the OGM
    logit grid, the proposal params, or None for the uniform sampler) and the
    iteration count over the whole run."""

    field_params: Dict[str, Any]
    occ_grid: Any
    global_step: int = 0


class Optimizer:
    """Host side: the keyframe schedule, the phase-runner cache and the map
    state on one torch device.

    Counterpart of ``loner_tpu/mapping/optimizer.py::Optimizer``: runs a
    keyframe window through its iteration schedule (``iterate_optimizer``) and
    writes the optimised poses back into the keyframes. The random draws come
    from a ``torch.Generator`` on the device, seeded with ``seed``.

    On a CUDA device every runner is a captured program (``phase_graph``): the
    runners share one graph memory pool (they replay one at a time on one
    stream, and keep no value in it between replays) and, per window class,
    one set of static window buffers, into which each keyframe's window is
    copied once. ``warm_up`` captures every program the schedule can reach; a
    program first met later (no warm-up, or a point pad grown by a larger scan)
    is captured then, counted in ``late_captures`` and logged.

    ``camera_rays``: (camera-frame pixel directions (H W, 3), LiDAR-to-camera
    (4, 4)), the geometry of the camera branch, or None on a LiDAR-only run
    (camera samples are then disabled, as in the JAX package). A window whose
    schedule trains the intensity head packs its keyframes' images into the
    window class's static camera buffers, once a keyframe.

    ``mesh``: a ``parallel/mesh.py::MeshSpec`` spreads the mapping over several
    devices, with this process as rank 0: the constructor spawns the other
    ranks, each an ``Optimizer`` replica that mirrors this one's ``warm_up``,
    ``iterate_optimizer`` and ``restore`` (``serve``), and broadcasts the initial
    state. Under a mesh the KF#1 bootstrap keeps the full window width (the JAX
    package's rule), only rank 0 logs, and ``close`` stops the other ranks. A
    follower is built with the running ``Mesh`` it joined."""

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
        camera_rays: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        log_losses: bool = False,
        write_ray_point_clouds: bool = False,
        store_ray: bool = False,
        draw_samples: bool = False,
        draw_rays_eps: bool = False,
        mesh=None,
    ) -> None:
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
        self._camera_rays = camera_rays
        # The debug dumps (written under log_directory): per-phase loss CSVs, one
        # sampled ray batch a keyframe, and the per-iteration ray record, whose
        # size sets the runners' extras mode as in the JAX package.
        self._log_losses = log_losses
        self._write_ray_point_clouds = write_ray_point_clouds
        self._store_ray = store_ray
        self._draw_samples = draw_samples
        self._draw_rays_eps = draw_rays_eps
        if draw_samples or draw_rays_eps:
            self._extras_mode = "full"
        elif store_ray:
            self._extras_mode = "ray"
        else:
            self._extras_mode = "none"
        if camera_rays is None and cfg.n_camera_samples > 0:
            print("Warning: num_samples.camera > 0 but no camera geometry (LiDAR-only run): "
                  "camera-sample supervision is disabled.")
        self._cameras: Dict[int, CameraWindowBuffers] = {}  # W -> static camera buffers

        self._generator = torch.Generator(device=self._device).manual_seed(int(seed))
        self.state = MapState(*self._init_state(self._generator))
        self._keyframe_count = 0
        self._runner_cache: Dict[tuple, Any] = {}
        self._windows: Dict[tuple, WindowBuffers] = {}  # (W, P, PS) -> static buffers
        self._scan_pool = DeviceScanPool(self._device)
        self.graph_pool = (torch.cuda.graph_pool_handle() if self._device.type == "cuda"
                           else None)
        self.late_captures = 0
        self.last_losses: Optional[np.ndarray] = None
        self.last_depth_eps: Optional[np.ndarray] = None
        self.last_camera_losses: Optional[np.ndarray] = None
        self.camera_loss_log: List[np.ndarray] = []  # each keyframe's camera losses

        self._mesh = None
        if mesh is not None:
            from loner_tpu_torch.parallel import mesh as mesh_mod

            if self._extras_mode != "none":
                raise ValueError("store_ray, draw_samples and draw_rays_eps are not kept under "
                                 "a mesh")
            if isinstance(mesh, mesh_mod.MeshSpec):
                self._check_mesh(mesh)
                replica = dict(
                    cfg=cfg, field_cfg=field_cfg, world_scale=float(world_scale),
                    world_shift=np.asarray(world_shift, np.float32),
                    keyframe_schedule=_plain(keyframe_schedule),
                    skip_pose_refinement=skip_pose_refinement, use_gt_poses=use_gt_poses,
                    freeze_poses=freeze_poses, seed=seed, camera_rays=camera_rays)
                mesh = mesh_mod.launch(mesh, serve_replica, (replica,))
            self._mesh = mesh
            self._replicate_state()

    @property
    def mesh(self):
        """The running mesh (``parallel/mesh.py::Mesh``), or None."""
        return self._mesh

    def _check_mesh(self, spec) -> None:
        """The shapes a mesh must divide, before any process starts."""
        device = self._device
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if torch.device(spec.devices[0]) != device:
            raise ValueError(f"rank 0 of the mesh is on {spec.devices[0]}, the optimizer on "
                             f"{self._device}")
        w = self._cfg.window_size
        if w % spec.n_kf:
            raise ValueError(f"window size {w} does not divide over {spec.n_kf} keyframe ranks")
        per_kf = w // spec.n_kf
        for what, n in (("rays", self._cfg.n_lidar_samples + sky_rays_per_slot(self._cfg)),
                        ("camera rays", self._cfg.n_camera_samples)):
            if (per_kf * n) % spec.n_ray:
                raise ValueError(f"{per_kf * n} {what} of a keyframe group do not divide over "
                                 f"{spec.n_ray} ray ranks")

    def _leader(self) -> bool:
        return self._mesh is not None and self._mesh.rank == 0

    def _state_tensors(self) -> List[torch.Tensor]:
        out = []
        for part in ("sigma", "intensity"):
            tree = self.state.field_params[part]
            out += [tree["mlp"][k] for k in sorted(tree["mlp"])]
            if "table" in tree:
                out.append(tree["table"])
        occ = self.state.occ_grid
        if isinstance(occ, dict):
            out += [occ[k] for k in sorted(occ)]
        elif occ is not None:
            out.append(occ)
        return out

    def _replicate_state(self) -> None:
        from loner_tpu_torch.parallel.mesh import replicate

        replicate(self._state_tensors(), self._mesh)

    def close(self) -> None:
        """Stop the mesh's other ranks and leave its group (rank 0; idempotent)."""
        if self._leader():
            self._mesh.close()

    def serve(self) -> None:
        """A follower rank: mirror rank 0's commands until it stops."""
        while True:
            msg = self._mesh.receive()
            cmd = msg["cmd"]
            if cmd == "stop":
                return
            if cmd == "warm_up":
                self.warm_up(msg["n_points"])
            elif cmd == "restore":
                self.state.global_step = msg["global_step"]
                self._keyframe_count = msg["keyframe_count"]
                self._replicate_state()
            elif cmd == "iterate":
                from loner_tpu_torch.parallel.mesh import broadcast_window

                w, (p, ps) = msg["w"], msg["pads"]
                if msg["global_step"] != self.state.global_step:
                    raise RuntimeError(f"rank {self._mesh.rank} at global step "
                                       f"{self.state.global_step}, rank 0 at {msg['global_step']}")
                self._run_window(broadcast_window(self._mesh, None, w, p, ps), msg["phases"],
                                 msg["twists"], msg["masks"], msg["images"])
                self._keyframe_count += 1
            else:
                raise ValueError(f"unknown mesh command {cmd!r}")

    def _init_state(self, generator: torch.Generator):
        field_params = init_field_params(generator, self._field_cfg, self._device)
        occ = None
        if self._cfg.samples_strategy == "PROPOSAL":
            occ = init_proposal_params(generator, self._cfg.proposal, self._device)
        elif self._cfg.samples_strategy == "OGM":
            occ = init_occ_grid(self._cfg.occ_voxel_size, self._device)
        return field_params, occ

    def restore(self, field_params, occ_state, global_step: int, keyframe_count: int) -> None:
        """Seat the map state from numpy trees in the JAX package's layout (a
        checkpoint's ``network_state_dict`` and ``occ_model_state_dict``: the OGM
        grid array or the proposal params). Adam state is not restored: each
        schedule phase builds a fresh Adam."""
        self.state.field_params = convert.field_params_from_jax(field_params, self._device)
        if occ_state is not None:
            self.state.occ_grid = convert.occ_state_from_jax(occ_state, self._device)
        self.state.global_step = int(global_step)
        self._keyframe_count = int(keyframe_count)
        if self._leader():
            self._mesh.send({"cmd": "restore", "global_step": self.state.global_step,
                             "keyframe_count": self._keyframe_count})
            self._replicate_state()

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
                self._cfg, self._field_cfg, phase, w, p, ps, self._device,
                extras_mode=self._extras_mode,
                window=self._windows[(w, p, ps)], pool=self.graph_pool,
                has_camera=self._camera_rays is not None, camera=self._cameras.get(w),
                mesh=self._mesh)
        return self._runner_cache[cache_key]

    def _uses_camera(self, phase: PhaseSettings) -> bool:
        return (not phase.freeze_rgb_mlp and self._cfg.n_camera_samples > 0
                and self._camera_rays is not None)

    def _static_camera(self, images: List[Optional[np.ndarray]], w: int) -> CameraWindowBuffers:
        """The window class's static camera buffers, holding ``images`` (one per
        slot, None without an image): one host-to-device copy of the pixels."""
        cam_dirs, l2c = self._camera_rays
        static = self._cameras.get(w)
        if static is None:
            static = self._cameras[w] = build_camera_window_buffers(
                images, cam_dirs, l2c, w, self._field_cfg.num_colors, self._device)
            return static
        intens, has = pack_camera_images(images, cam_dirs.shape[0], w, self._field_cfg.num_colors)
        host = torch.from_numpy(intens)
        if self._device.type == "cuda":
            host = host.pin_memory()
        static.intensities.copy_(host, non_blocking=True)
        static.has_image.copy_(torch.from_numpy(has))
        return static

    def _static_window(self, buffers: WindowBuffers) -> WindowBuffers:
        """The static buffers of this window class, holding ``buffers``' values
        (under a mesh: this rank's shard of them). A grown point pad retires the
        class's smaller buffers and their runners."""
        from loner_tpu_torch.mapping.phase_graph import clone_window, copy_window

        key = (buffers.dirs.shape[0], buffers.dirs.shape[1], buffers.sky_dirs.shape[1])
        if self._mesh is not None:
            from loner_tpu_torch.parallel.mesh import shard_window_buffers

            buffers = shard_window_buffers(buffers, self._mesh)
        static = self._windows.get(key)
        if static is None:
            stale = [k for k in self._windows if k[0] == key[0]]
            for k in stale:
                del self._windows[k]
            self._runner_cache = {k: v for k, v in self._runner_cache.items()
                                  if k[1:] not in stale}
            static = self._windows[key] = clone_window(buffers)
        elif static is not buffers:
            copy_window(static, buffers)
        return static

    @property
    def config(self) -> OptimizerConfig:
        return self._cfg

    @property
    def graph_captures(self) -> int:
        """Graphs captured by the runners alive now."""
        return sum(r.captures for r in self._runner_cache.values())

    def _window_classes_for_item(self, first_kf: int, last_kf: Optional[int]) -> set:
        """Window sizes a schedule item can run at: KF#k optimises a window of
        min(k, W) keyframes, so only the item covering KF#1 sees the
        1-keyframe (bootstrap) class; every later one runs the full width."""
        classes = set()
        if first_kf == 1 and self._mesh is None:
            classes.add(1)
        if last_kf is None or last_kf >= 2 or self._mesh is not None:
            classes.add(self._cfg.window_size)
        return classes

    def warm_up(self, n_points: int) -> float:
        """Build the CUDA kernels and capture the program of every phase runner
        the keyframe schedule can reach (on the CPU: run one iteration of each),
        on dummy state and at the point pad of ``n_points``-point scans, without
        drawing from the optimizer's generator. Returns the seconds spent."""
        t0 = time.time()
        if self._device.type == "cuda" and self._field_cfg.sigma_kernel == "fused":
            from loner_tpu_torch.ops import fourier_mlp, hash_grid

            fcfg = self._field_cfg
            if fcfg.encoding_sigma == "hash":
                hash_grid._lib()
            elif not fcfg.fused_fourier:
                pass  # the unfused Fourier head is plain PyTorch
            elif fcfg.compute_dtype == torch.float32:
                fourier_mlp._lib_f32()
            else:
                fourier_mlp._lib()
            if self._cfg.n_camera_samples > 0 and fcfg.encoding_intensity == "hash":
                hash_grid._lib()
        if self._leader():  # after the build: the other ranks load what it built
            self._mesh.send({"cmd": "warm_up", "n_points": int(n_points)})
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
        ready = []
        for (_, w), eff in needed.items():
            full = build_window_buffers([d] * w, [depths] * w, [None] * w, w, device=self._device)
            buffers = self._static_window(full)
            camera = self._static_camera([None] * w, w) if self._uses_camera(eff) else None
            runner = self._get_runner(eff, w, full.dirs.shape[1], full.sky_dirs.shape[1])
            ready.append(runner.warm_up(
                field_params, occ, torch.zeros((w, 6), device=self._device), buffers,
                torch.ones((w,), device=self._device), self._world_scale, self._world_shift,
                self._generator, camera=camera))
        if ready:
            torch.cat(ready).cpu()  # waits for the device
        return time.time() - t0

    def _dump_ray_cloud(self, buffers: WindowBuffers, twists: torch.Tensor, w: int,
                        u: Optional[torch.Tensor]) -> None:
        """The write_ray_point_clouds dump: one batch of LiDAR rays from the
        window at the optimised twists (random picks, no sky rays)."""
        from loner_tpu_torch.runtime.debug_artifacts import dump_ray_point_cloud

        if u is None:
            gen = torch.Generator(device=self._device).manual_seed(0)
            u = torch.rand((w, self._cfg.n_lidar_samples), generator=gen, device=self._device)
        with torch.no_grad():
            rays, depths_cube, valid = sample_and_build_rays(
                buffers, twists, self._world_scale, self._world_shift, self._cfg.ray_range,
                self._cfg.n_lidar_samples, 0, u=u.to(self._device))
        v = valid.cpu().numpy()
        dump_ray_point_cloud(rays.cpu().numpy()[v], depths_cube.cpu().numpy()[v],
                             self._log_directory, f"kf_{self._keyframe_count}")

    def _run_window(self, full: WindowBuffers, effective: List[PhaseSettings],
                    twists: np.ndarray, masks: List[np.ndarray],
                    images: Optional[List[Optional[np.ndarray]]], extras_log=None):
        """The phases of one window, from its buffers, twists, pose masks and
        camera images (None: no camera phase): every rank of a mesh runs this
        on the same arguments. Returns the twists and the per-phase loss,
        depth_eps and camera-loss records, on the device."""
        from loner_tpu_torch.runtime.profiling import optimizer_trace

        w = full.dirs.shape[0]
        # One copy of the window into its class's static buffers per keyframe.
        buffers = self._static_window(full)
        p, ps = full.dirs.shape[1], full.sky_dirs.shape[1]
        camera = None if images is None else self._static_camera(images, w)
        # The twists and every phase's pose mask go up in one copy, pinned and
        # asynchronous on a CUDA device.
        host = torch.from_numpy(np.concatenate([twists.reshape(-1)] + list(masks)))
        if self._device.type == "cuda":
            host = host.pin_memory()
        up = host.to(self._device, non_blocking=True)
        tw = up[: w * 6].view(w, 6)
        all_losses, all_eps, cam_losses = [], [], []
        with optimizer_trace(self._log_directory, self._profile_optimizer, self._keyframe_count):
            for n, eff in enumerate(effective):
                runner = self._get_runner(eff, w, p, ps)
                if runner.graphs and not runner.captured:
                    self.late_captures += 1
                    print(f"Mapper: capturing the {eff} program at W={w}, point pad {p} "
                          f"(late capture {self.late_captures})", flush=True)
                (self.state.field_params, self.state.occ_grid, tw, losses, eps) = runner(
                    self.state.field_params, self.state.occ_grid, tw, buffers,
                    up[w * 6 + n * w : w * 6 + (n + 1) * w], self._world_scale,
                    self._world_shift, self.state.global_step, self._generator,
                    num_iterations=eff.num_iterations,
                    camera=camera if self._uses_camera(eff) else None, extras_log=extras_log,
                )
                self.state.global_step += eff.num_iterations
                all_losses.append(losses)
                all_eps.append(eps)
                if runner.last_camera_losses is not None:
                    cam_losses.append(runner.last_camera_losses)
        return tw, all_losses, all_eps, cam_losses

    # -- main entry ------------------------------------------------------------
    def iterate_optimizer(self, window: list,
                          ray_cloud_u: Optional[torch.Tensor] = None) -> float:
        """Run the iteration schedule on a window of keyframes
        (``mapping.keyframe.KeyFrame``) and write the optimised poses back into
        them. Returns the last iteration's mapping loss.

        ``ray_cloud_u``: the (W, n_lidar) uniforms that pick the ray batch that
        ``write_ray_point_clouds`` dumps; by default drawn from a generator
        seeded 0 (the JAX package draws it from ``jax.random.key(0)``)."""
        start_time = time.time()
        if len(window) == 1:
            window[0].is_anchored = True
        phases = self._select_schedule()
        num_its = sum(p.num_iterations for p in phases)

        m = len(window)
        # A 1-keyframe window (the KF#1 bootstrap) runs a W = 1 runner: the
        # full width would spend all but one slot on masked-out replicas. Under
        # a mesh it keeps the full width, whose slots the ranks share.
        w = 1 if m == 1 and self._mesh is None else self._cfg.window_size
        full = self._scan_pool.build_window(window, w, self._cfg.rays_strategy == "MASK")
        effective = [self._effective_phase(phase) for phase in phases]
        images = None
        if any(self._uses_camera(eff) for eff in effective):
            # Empty slots hold the last keyframe's image, masked by slot validity.
            images = [window[min(i, m - 1)].get_image() for i in range(w)]
            images = [None if im is None else im.image for im in images]

        twists = np.zeros((w, 6), np.float32)
        anchored = np.zeros((w,), np.float32)
        for i in range(w):
            j = min(i, m - 1)
            twists[i] = window[j].pose_twist(self._use_gt_poses)
            anchored[i] = 1.0 if (window[j].is_anchored or i >= m) else 0.0
        masks = []
        for eff in effective:
            pose_mask = 1.0 - anchored
            if eff.latest_kf_only:
                latest_only = np.zeros_like(pose_mask)
                latest_only[m - 1] = 1.0
                pose_mask = pose_mask * latest_only
            masks.append(pose_mask)
        if self._leader():
            from loner_tpu_torch.parallel.mesh import broadcast_window

            self._mesh.send({"cmd": "iterate", "w": w,
                             "pads": (full.dirs.shape[1], full.sky_dirs.shape[1]),
                             "phases": effective, "twists": twists, "masks": masks,
                             "images": images, "global_step": self.state.global_step})
            broadcast_window(self._mesh, full, w, full.dirs.shape[1], full.sky_dirs.shape[1])

        extras_log = None
        if self._extras_mode != "none" and self._log_directory is not None:
            from loner_tpu_torch.runtime.debug_artifacts import IterationRayRecordDumper

            # Written as the dispatches' records arrive: draw_samples' clouds are
            # ~50 MB an iteration at the reference's sizes.
            extras_log = IterationRayRecordDumper(
                self._log_directory, self._keyframe_count,
                n_lidar=self._cfg.n_lidar_samples, n_sky=sky_rays_per_slot(self._cfg),
                window_slots=w, num_kfs=m, world_scale=float(self._world_scale),
                world_shift=self._world_shift.cpu().numpy(),
                eps_min=self._cfg.loss.min_depth_eps, js_alpha=self._cfg.loss.js_alpha,
                max_js_score=self._cfg.loss.max_js_score, store_ray=self._store_ray,
                draw_samples=self._draw_samples, draw_rays_eps=self._draw_rays_eps)
        twists, all_losses, all_eps, cam_losses = self._run_window(
            full, effective, twists, masks, images, extras_log)

        # One copy to the host for the poses and the phase's loss logs.
        host = torch.cat([twists.reshape(-1)] + all_losses + all_eps + cam_losses).cpu().numpy()
        twists_np = host[: w * 6].reshape(w, 6)
        n_log = sum(int(x.numel()) for x in all_losses)
        self.last_losses = host[w * 6 : w * 6 + n_log]
        self.last_depth_eps = host[w * 6 + n_log : w * 6 + 2 * n_log]
        self.last_camera_losses = host[w * 6 + 2 * n_log:] if cam_losses else None
        if cam_losses:
            self.camera_loss_log.append(self.last_camera_losses)
        if not np.isfinite(twists_np).all():
            raise RuntimeError("Fatal: Encountered invalid pose tensor.")
        if not np.isfinite(self.last_losses).all():
            raise RuntimeError("NaN Loss Encountered")
        if extras_log is not None:
            extras_log.finish()
        if self._log_losses and self._log_directory is not None:
            from loner_tpu_torch.runtime.debug_artifacts import log_losses

            start = 0
            for n, losses in enumerate(all_losses):
                stop = start + int(losses.numel())
                log_losses(self.last_losses[start:stop], self.last_depth_eps[start:stop],
                           self._log_directory, self._keyframe_count, n)
                start = stop
        if self._write_ray_point_clouds and self._log_directory is not None:
            self._dump_ray_cloud(full, twists, w, ray_cloud_u)

        if not self._use_gt_poses:
            for i, kf in enumerate(window):
                kf.set_pose_twist(twists_np[i])

        elapsed = time.time() - start_time
        if self._log_directory is not None:
            with open(f"{self._log_directory}/timing.csv", "a+") as f:
                f.write(f"{num_its},{elapsed}\n")
        self._keyframe_count += 1
        return float(self.last_losses[-1]) if self.last_losses.size else float("nan")


def _plain(x):
    """Settings trees as plain dicts and lists (they cross to other processes)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def serve_replica(mesh, replica: dict) -> None:
    """A mesh follower's life: an ``Optimizer`` replica on its rank's device,
    serving rank 0's commands."""
    Optimizer(device=mesh.device, mesh=mesh, **replica).serve()
