"""Proposal-MLP occupancy field: the importance sampler's guide.

Counterpart of ``loner_tpu/models/proposal.py``: a small Fourier MLP holds the
occupancy log-odds that guide sampling along each ray, trained by a linear
loss whose gradient is the reference's occupancy pseudo-gradient.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from loner_tpu_torch.models.field import FourierConfig, fourier_bmat


@dataclass(frozen=True)
class ProposalConfig:
    n_freqs: int = 16
    scale: float = 3.0
    n_neurons: int = 64
    n_hidden_layers: int = 2
    seed: int = 4321

    @staticmethod
    def from_settings(cfg: dict) -> "ProposalConfig":
        return ProposalConfig(
            n_freqs=int(cfg.get("n_freqs", 16)),
            scale=float(cfg.get("scale", 3.0)),
            n_neurons=int(cfg.get("n_neurons", 64)),
            n_hidden_layers=int(cfg.get("n_hidden_layers", 2)),
            seed=int(cfg.get("seed", 4321)),
        )


def init_proposal_params(generator: torch.Generator, cfg: ProposalConfig,
                         device: torch.device) -> Dict[str, Any]:
    """Parameter dict. ``bmat`` (the (3, F) projection, the same draw as the
    JAX package's) is stored with the weights so checkpoints are
    self-contained, but it is never trained."""
    bmat = fourier_bmat(FourierConfig(n_freqs=cfg.n_freqs, scale=cfg.scale, seed=cfg.seed), device)
    params: Dict[str, Any] = {"bmat": bmat.clone()}
    dims = [2 * cfg.n_freqs + 3] + [cfg.n_neurons] * cfg.n_hidden_layers + [1]
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = math.sqrt(6.0 / d_in)
        u = torch.rand((d_in, d_out), generator=generator, device=device)
        params[f"w{i}"] = u * (2.0 * bound) - bound
    return params


def proposal_logits(params: Dict[str, Any], points: torch.Tensor) -> torch.Tensor:
    """Occupancy log-odds at points in [-1, 1]^3. points: (..., 3) -> (...)."""
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    proj = p @ params["bmat"].detach()
    h = torch.cat([torch.sin(proj), torch.cos(proj), p], dim=-1)
    n_layers = sum(1 for k in params if k.startswith("w"))
    for i in range(n_layers):
        h = h @ params[f"w{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h[..., 0].reshape(shape)
