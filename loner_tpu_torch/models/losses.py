"""Loss building blocks: truncated-Gaussian LOS targets, JS divergence,
occupancy log-odds gradients.

Counterpart of ``loner_tpu/models/losses.py``; these feed LONER's JS
dynamic-margin line-of-sight loss.
"""
from __future__ import annotations

import math

import torch

_INV_SQRT_2PI = 0.3989422804014327
_INV_SQRT_2 = 0.7071067811865476
# CDF mass of a standard normal inside [-3, 3]: the clip window's constant mass.
_MASS_3SIGMA = math.erf(3.0 * _INV_SQRT_2)


def _norm_pdf(x: torch.Tensor) -> torch.Tensor:
    return _INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def get_weights_gt(sampled_depth, gt_depth, eps, norm: bool = True) -> torch.Tensor:
    """Target weight distribution: truncated Gaussian N(d_gt, (eps/3)^2)
    clipped to [d_gt - eps, d_gt + eps], row-normalized.

    sampled_depth: (N, S); gt_depth: (N, 1); eps: scalar or (N, 1).
    """
    eps = torch.as_tensor(eps, dtype=sampled_depth.dtype, device=sampled_depth.device)
    sigma = eps / 3.0
    z = (sampled_depth - gt_depth) / sigma
    w = _norm_pdf(z) / sigma / _MASS_3SIGMA
    inside = (sampled_depth >= gt_depth - eps) & (sampled_depth <= gt_depth + eps)
    w = torch.where(inside, w, 0.0)
    if norm:
        w = w / (w.sum(dim=1, keepdim=True) + 1e-6)
    return w


def get_logits_grad(z_vals, depth, eps: float = 2.0, l_free: float = 0.25,
                    l_occ: float = 2.5) -> torch.Tensor:
    """Occupancy log-odds pseudo-gradient: +l_free well before the return,
    -l_occ in the +-eps band around it. Heaviside with H(0) = 0."""
    x = z_vals - depth

    def heav(v):
        return (v > 0).to(z_vals.dtype)

    return l_free * heav(-x - eps) - l_occ * heav(x + eps) * heav(eps - x)


def kl_divergence_gaussian(mean1, std1, mean2, std2):
    """KL(N1 || N2) closed form."""
    var1, var2 = std1 * std1, std2 * std2
    return torch.log(std2 / std1) + (var1 + (mean1 - mean2) ** 2) / (2.0 * var2) - 0.5


def js_divergence_gaussian(mean1, std1, mean2, std2):
    """The reference's approximate Gaussian JS divergence: both distributions
    against the moment average N(0.5(m1+m2), 0.5*sqrt(s1^2+s2^2))."""
    mean_m = 0.5 * (mean1 + mean2)
    std_m = 0.5 * torch.sqrt(std1 * std1 + std2 * std2)
    return 0.5 * kl_divergence_gaussian(mean1, std1, mean_m, std_m) + 0.5 * (
        kl_divergence_gaussian(mean2, std2, mean_m, std_m)
    )


def img_to_mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse_to_psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(x) / torch.log(torch.tensor(10.0, dtype=x.dtype, device=x.device))
