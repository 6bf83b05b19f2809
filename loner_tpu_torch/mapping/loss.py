"""The LONER mapping loss: depth MSE + line-of-sight loss (JS dynamic margin
or decayed-epsilon LOS) + opacity regularizer; and the camera loss, the masked
MSE of rendered pixel colours.

Counterpart of ``loner_tpu/mapping/loss.py``. Invalid rays are
weighted out, not filtered; the sampler's draws and the sigma noise are inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from loner_tpu_torch.models.losses import get_weights_gt, js_divergence_gaussian
from loner_tpu_torch.models.rendering import render_rays


@dataclass(frozen=True)
class LossConfig:
    loss_selection: str = "L1_JS"  # L1_JS, L2_JS, L1_LOS, L2_LOS
    min_js_score: float = 1.0
    max_js_score: float = 10.0
    js_alpha: float = 1.0
    los_lambda: float = 1000.0
    decay_los_lambda: bool = False
    min_los_lambda: float = 10.0
    los_lambda_decay_rate: float = 0.001
    los_lambda_decay_steps: float = 15000.0
    depth_eps: float = 3.0
    decay_depth_eps: bool = True
    min_depth_eps: float = 0.5
    depth_eps_decay_rate: float = 0.95
    depth_eps_decay_steps: float = 1.0
    depthloss_lambda: float = 0.005

    @staticmethod
    def from_settings(loss_cfg: dict) -> "LossConfig":
        js = loss_cfg.get("JS_loss", {})
        return LossConfig(
            loss_selection=loss_cfg.get("loss_selection", "L1_JS"),
            min_js_score=float(js.get("min_js_score", 1.0)),
            max_js_score=float(js.get("max_js_score", 10.0)),
            js_alpha=float(js.get("alpha", 1.0)),
            los_lambda=float(loss_cfg.get("los_lambda", 1000.0)),
            decay_los_lambda=bool(loss_cfg.get("decay_los_lambda", False)),
            min_los_lambda=float(loss_cfg.get("min_los_lambda", 10.0)),
            los_lambda_decay_rate=float(loss_cfg.get("los_lambda_decay_rate", 0.001)),
            los_lambda_decay_steps=float(loss_cfg.get("los_lambda_decay_steps", 15000.0)),
            depth_eps=float(loss_cfg.get("depth_eps", 3.0)),
            decay_depth_eps=bool(loss_cfg.get("decay_depth_eps", True)),
            min_depth_eps=float(loss_cfg.get("min_depth_eps", 0.5)),
            depth_eps_decay_rate=float(loss_cfg.get("depth_eps_decay_rate", 0.95)),
            depth_eps_decay_steps=float(loss_cfg.get("depth_eps_decay_steps", 1.0)),
            depthloss_lambda=float(loss_cfg.get("depthloss_lambda", 0.005)),
        )


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of ``x`` where ``mask``; with ``count`` (a mesh's window count of
    the mask's ones) this rank's share of the window's mean."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum() if count is None else count, min=1.0)


def opaque_rays(depths_cube: torch.Tensor, far: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rays the depth and opacity terms supervise: a return inside the cube."""
    return (depths_cube > 0) & (~(depths_cube > far)) & valid


def js_scores(z_m: torch.Tensor, w_pred: torch.Tensor, depths_gt_m: torch.Tensor,
              eps_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ray's JS score, from the rendered weights' mean and spread along the
    ray against a Gaussian of sigma ``eps_min / 3`` at the measured depth; and
    that spread. z_m, w_pred: (B, S); depths_gt_m: (B,)."""
    w_sum = w_pred.sum(dim=1)
    mean = (z_m * w_pred).sum(dim=1) / (w_sum + 1e-10)
    var = ((z_m - mean[:, None]) ** 2 * w_pred).sum(dim=1) / (w_sum + 1e-10) + 1e-10
    std = torch.sqrt(var)
    return js_divergence_gaussian(depths_gt_m, eps_min / 3.0, mean, std), std


def compute_camera_loss(rays, intensities, valid, field_params, field_cfg, sampler, occ_state,
                        n_samples: int, perturb: float, detach_sigma: bool = True,
                        jitter: Optional[torch.Tensor] = None,
                        pdf_u: Optional[torch.Tensor] = None,
                        count: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render the sampled pixel rays through the intensity head (no sigma noise)
    and take the masked MSE against the pixels. ``detach_sigma`` stops its
    gradients into the sigma parameters (the reference's
    ``detach_rgb_from_sigma``). ``count``: under a mesh, the window's valid
    camera rays (the MSE is then this rank's share). Returns (mse, rendered rgb
    (B, C))."""
    result = render_rays(rays, field_params, field_cfg, sampler, n_samples=n_samples,
                         perturb=perturb, raw_noise_std=0.0, occ_state=occ_state, jitter=jitter,
                         pdf_u=pdf_u, sigma_only=False, detach_sigma=detach_sigma)
    rgb = result["rgb"]
    err = (rgb - intensities) ** 2
    if count is not None:
        count = count * err.shape[1]
    return _masked_mean(err, valid[:, None].expand(err.shape), count), rgb


def compute_lidar_loss(rays, depths_cube, valid, field_params, field_cfg, sampler, occ_state,
                       cfg: LossConfig, world_scale, n_samples: int, perturb: float,
                       raw_noise_std: float, iteration_idx: float, global_step: float,
                       jitter: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       pdf_u: Optional[torch.Tensor] = None,
                       window: Optional[Dict[str, Any]] = None, marks=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render the batch and assemble the total loss. Returns (loss, aux).
    ``jitter`` and ``pdf_u`` are the sampler's draws, ``noise`` the sigma noise.
    ``iteration_idx`` and ``global_step`` are numbers or device scalars (a
    captured iteration reads them from the device). ``window``: under a mesh,
    the window's counts (``parallel/mesh.py::WindowShard.window_counts``); every
    mean then divides by them, and ``loss`` and ``aux["depth_eps"]`` are this
    rank's shares of the window's values. ``marks``: the iteration's layer marks
    (``models/rendering.py::render_rays``)."""
    far = rays[:, 10]
    depths_gt_m = depths_cube * world_scale  # meters
    opaque = opaque_rays(depths_cube, far, valid)
    n_opaque = None if window is None else window["opaque"]

    result = render_rays(
        rays, field_params, field_cfg, sampler, n_samples=n_samples, perturb=perturb,
        raw_noise_std=raw_noise_std, occ_state=occ_state, jitter=jitter, noise=noise,
        pdf_u=pdf_u, marks=marks,
    )
    z_m = result["z_vals"] * world_scale  # (B, S) meters
    w_pred = result["weights"]

    eps_min = cfg.min_depth_eps
    js_score, std = js_scores(z_m, w_pred, depths_gt_m, eps_min)

    depth_pred_m = result["depth"] * world_scale
    depth_loss = _masked_mean((depth_pred_m - depths_gt_m) ** 2, opaque, n_opaque)

    sel = cfg.loss_selection
    if sel in ("L1_JS", "L2_JS"):
        js_c = torch.where(js_score < cfg.min_js_score, 0.0, js_score)
        js_c = torch.clamp(js_c, max=cfg.max_js_score)
        eps_dyn = (eps_min * (1.0 + cfg.js_alpha * js_c)).detach()[:, None]  # (B, 1)
        per_ray_eps = eps_dyn[:, 0]
        depth_eps = eps_dyn.mean() if window is None else eps_dyn.sum() / window["rays"]
        weights_gt = get_weights_gt(z_m, depths_gt_m[:, None], eps=eps_dyn)
    elif sel in ("L1_LOS", "L2_LOS"):
        if cfg.decay_depth_eps:
            decayed = cfg.depth_eps * cfg.depth_eps_decay_rate ** (
                iteration_idx / cfg.depth_eps_decay_steps)
            depth_eps = torch.clamp(torch.as_tensor(decayed, dtype=z_m.dtype, device=z_m.device),
                                    min=cfg.min_depth_eps)
        else:
            depth_eps = torch.as_tensor(cfg.depth_eps, dtype=z_m.dtype, device=z_m.device)
        per_ray_eps = depth_eps.expand(depths_gt_m.shape)
        weights_gt = get_weights_gt(z_m, depths_gt_m[:, None], eps=depth_eps)
        if window is not None:
            depth_eps = depth_eps * window["share"]
    else:
        raise ValueError(f"Unknown loss selection {sel}")

    # Transparent and invalid rays get all-zero target weights.
    weights_gt = torch.where(opaque[:, None], weights_gt, 0.0)

    if cfg.decay_los_lambda:
        los_lambda = cfg.los_lambda * cfg.los_lambda_decay_rate ** (
            (global_step + 1.0) / cfg.los_lambda_decay_steps)
        los_lambda = (torch.clamp(los_lambda, min=cfg.min_los_lambda)
                      if isinstance(los_lambda, torch.Tensor)
                      else max(los_lambda, cfg.min_los_lambda))
    else:
        los_lambda = cfg.los_lambda

    diff = w_pred - weights_gt
    per_elem = diff.abs() if sel.startswith("L1") else diff * diff
    los_loss = _masked_mean(per_elem, valid[:, None].expand(per_elem.shape),
                            None if window is None else window["valid"] * per_elem.shape[1])
    opacity_loss = _masked_mean((result["opacity"] - 1.0).abs(), opaque, n_opaque)
    loss = cfg.depthloss_lambda * depth_loss + los_lambda * los_loss + opacity_loss

    aux = {
        "loss": loss,
        "depth_loss": depth_loss,
        "los_loss": los_loss,
        "opacity_loss": opacity_loss,
        "depth_eps": depth_eps,
        "js_score": js_score,
        "std": std,
        "points": result["points"],  # (B, S, 3) cube coords
        "z_m": z_m,
        "depths_gt_m": depths_gt_m,
        "opaque": opaque,
        "valid": valid,
        # The per-ray debug record (the mapper's store_ray, draw_samples and
        # draw_rays_eps flags); reading it changes no result.
        "rays": rays,
        "depths_cube": depths_cube,
        "per_ray_eps": per_ray_eps,
        "w_pred": w_pred,
        "w_gt": weights_gt,
    }
    return loss, aux
