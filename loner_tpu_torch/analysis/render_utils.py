"""Shared utilities for the offline analysis tools: checkpoint loading and
chunked field rendering at test-time sample counts.

Counterpart of ``loner_tpu/analysis/render_utils.py``. An experiment directory
holds ``full_config.pkl`` (the settings tree as a plain dict) and
``checkpoints/<name>.tar`` (a pickled dict of numpy arrays); either package's
runs load here. Rendering runs on one torch device under
``torch.inference_mode()``.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch

from loner_tpu_torch import convert
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.common.settings import Settings
from loner_tpu_torch.common.world_cube import WorldCube
from loner_tpu_torch.mapping.rays import get_far_val
from loner_tpu_torch.models.field import FieldConfig
from loner_tpu_torch.models.rendering import pack_rays


def default_device() -> torch.device:
    """The CUDA card when there is one, else the CPU (where the kernels'
    plain versions run)."""
    return torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")


@dataclass
class LoadedModel:
    field_params: dict
    field_cfg: FieldConfig
    occ_grid: Optional[dict]  # proposal params, or None (uniform sampler)
    world_cube: WorldCube
    settings: Settings
    poses: list  # keyframe pose states
    global_step: int
    device: torch.device
    compositor: str  # model.render.compositor (analysis._render_impl)
    # samplers and render options, keyed by render options
    # (see analysis._render_impl.get_chunk_renderer)
    render_cache: dict = field(default_factory=dict, repr=False)


def load_experiment(log_dir: str, ckpt_name: str = "final.tar",
                    device: Union[torch.device, str, None] = None) -> LoadedModel:
    """Load full_config.pkl + a checkpoint from an experiment directory onto
    ``device`` (default: ``default_device()``)."""
    from loner_tpu_torch.analysis._render_impl import configured_compositor

    device = default_device() if device is None else torch.device(device)
    with open(os.path.join(log_dir, "full_config.pkl"), "rb") as f:
        settings = Settings(pickle.load(f))
    with open(os.path.join(log_dir, "checkpoints", ckpt_name), "rb") as f:
        ckpt = pickle.load(f)

    world_cube = WorldCube.from_dict(ckpt.get("world_cube") or settings["world_cube"])
    model_cfg = settings.mapper.optimizer.model_config
    field_cfg = FieldConfig.from_settings(
        model_cfg["model"]["nerf_config"], int(model_cfg["model"]["num_colors"])
    )
    occ = ckpt.get("occ_model_state_dict")
    if occ is not None:
        if not isinstance(occ, dict):
            raise NotImplementedError("the occupancy-grid (OGM) sampler is not ported")
        occ = convert.proposal_params_from_jax(occ, device)
    return LoadedModel(
        field_params=convert.field_params_from_jax(ckpt["network_state_dict"], device),
        field_cfg=field_cfg,
        occ_grid=occ,
        world_cube=world_cube,
        settings=settings,
        poses=ckpt.get("poses", []),
        global_step=int(ckpt.get("global_step", 0)),
        device=device,
        compositor=configured_compositor(settings),
    )


def kf_pose_matrices(model: LoadedModel, use_gt: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(K, 4, 4) keyframe poses + (K,) timestamps from the checkpoint."""
    key = "gt_lidar_pose" if use_gt else "lidar_pose"
    mats, ts = [], []
    for state in model.poses:
        mats.append(Pose.from_twist(state[key]).matrix)
        ts.append(state["timestamp"])
    return np.stack(mats), np.asarray(ts)


def render_depth_chunked(
    model: LoadedModel,
    origins_world: np.ndarray,  # (N, 3) meters
    dirs_world: np.ndarray,  # (N, 3) unit
    ray_range: Tuple[float, float],
    n_samples: int = 2048,
    chunk: int = 2048,
    ret_var: bool = True,
    use_occ: bool = True,
    with_intensity: bool = False,
    with_peak: bool = False,
) -> dict:
    """Render expected depth (meters) + variance along world-frame rays.

    Deterministic (no perturb, no noise), ``chunk`` rays per field call. The
    rays go to the device once; the outputs come back once, after the last
    chunk. ``with_peak`` adds per-ray peak-depth consistency in meters.
    ``with_intensity`` raises: the intensity head is not ported."""
    from loner_tpu_torch.analysis._render_impl import get_chunk_renderer

    if with_intensity:
        raise NotImplementedError("the intensity head is not ported: with_intensity=False")
    cube = model.world_cube
    dev = model.device
    render_chunk = get_chunk_renderer(model, n_samples, ret_var, use_occ, ret_peak=with_peak)
    occ = model.occ_grid if use_occ else None

    n = origins_world.shape[0]
    o_cube = torch.from_numpy(np.asarray(cube.to_cube(origins_world), np.float32)).to(dev)
    d_cube = torch.from_numpy(np.asarray(dirs_world, np.float32)).to(dev)
    keys = ["depth", "opacity"] + (["variance"] if ret_var else []) + (
        ["peak_depth_consistency"] if with_peak else [])
    parts = {k: [] for k in keys}
    with torch.inference_mode():
        for i in range(0, n, chunk):
            o, d = o_cube[i : i + chunk], d_cube[i : i + chunk]
            near = torch.full((o.shape[0],), ray_range[0] / cube.scale_factor,
                              dtype=torch.float32, device=dev)
            far = torch.clamp(get_far_val(o, d), max=ray_range[1] / cube.scale_factor)
            out = render_chunk(pack_rays(o, d, near, far), model.field_params, occ)
            for k in keys:
                parts[k].append(out[k])
        host = {k: torch.cat(v).cpu().numpy() for k, v in parts.items()}

    result = {"depth": host["depth"] * cube.scale_factor, "opacity": host["opacity"]}
    if with_peak:
        result["peak_depth_consistency"] = host["peak_depth_consistency"] * cube.scale_factor
    if ret_var:
        result["variance"] = host["variance"] * cube.scale_factor ** 2
    return result
