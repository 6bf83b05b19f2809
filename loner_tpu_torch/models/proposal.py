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

from loner_tpu_torch.models.field import FourierConfig, fourier_bmat, in_row_blocks


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


# Rays a block of the proposal MLP's last product. That product has one output
# column, and a product of one column (cuBLAS's gemv kernels, the CPU's BLAS)
# sums each row in an order that depends on the row count: a ray's logits would
# round differently in a window of 4096 rays and in a mesh rank's 1024. It runs
# on blocks of this many rays (the last padded), one shape a call, so each ray's
# logits have the same bits whatever else the batch holds. It divides every
# rank's share of the window on the meshes the port accepts (1024 rays at W=8 on
# [4] and [2, 2]) and the W=1 bootstrap's 512.
RAY_BLOCK = 512


class _OneColumnProduct(torch.autograd.Function):
    """``h @ w`` for a one-column ``w``, the forward ``rows`` rows at a time, each
    product of one shape. Its input gradient, ``g @ w.T``, sums no terms (one
    product an entry) and its weight gradient sums every row: each is one
    product."""

    @staticmethod
    def forward(ctx, h, w, rows):
        ctx.save_for_backward(h, w)
        return in_row_blocks(lambda b, o: torch.matmul(b, w, out=o), h, rows, 1)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = h.t() @ g if ctx.needs_input_grad[1] else None
        return gh, gw, None


def proposal_logits(params: Dict[str, Any], points: torch.Tensor) -> torch.Tensor:
    """Occupancy log-odds at points in [-1, 1]^3. points: (rays, ..., 3) -> (rays,
    ...). Each point's logit has the same bits whatever else the batch holds: the
    last product runs in blocks of RAY_BLOCK rays, and the wider products keep one
    order a row at every row count."""
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    proj = p @ params["bmat"].detach()
    h = torch.cat([torch.sin(proj), torch.cos(proj), p], dim=-1)
    n_layers = sum(1 for k in params if k.startswith("w"))
    for i in range(n_layers - 1):
        h = torch.relu(h @ params[f"w{i}"])
    rows = RAY_BLOCK * max(p.shape[0] // max(shape[0], 1), 1)  # RAY_BLOCK rays' points
    return _OneColumnProduct.apply(h, params[f"w{n_layers - 1}"], rows).reshape(shape)
