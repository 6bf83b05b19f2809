"""Occupancy grid (OGM): a learnable 3D log-odds field that guides sampling.

Counterpart of ``loner_tpu/models/occupancy_grid.py``. The grid is a plain
``(V, V, V)`` f32 tensor of logits, state rather than a parameter: it is read by
trilinear interpolation (``grid_sample`` on [-1, 1] coordinates,
``align_corners=False``, zero padding; x indexes the last axis) and moved by an
SGD step on the interpolation's gradient, the reference's
``point_logits.backward(gradient=g)`` + ``SGD.step()``. The JAX package computes
both in XLA; the grid is 4 MB at V = 100, so no kernel is written for them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_nn


def init_occ_grid(voxel_size: int, device: torch.device) -> torch.Tensor:
    """Zero logits: p(occupied) = 0.5 everywhere."""
    return torch.zeros((voxel_size,) * 3, dtype=torch.float32, device=device)


def interpolate_occ_logits(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of the (V, V, V) logits at (..., 3) points in
    [-1, 1]^3, ordered (x, y, z). Returns (...)."""
    shape = points.shape[:-1]
    out = F_nn.grid_sample(grid[None, None], points.reshape(1, 1, 1, -1, 3), mode="bilinear",
                           padding_mode="zeros", align_corners=False)
    return out.reshape(shape)


def occ_grid_update(grid: torch.Tensor, points: torch.Tensor, logits_grad: torch.Tensor,
                    lr: float) -> torch.Tensor:
    """One SGD step on the grid given the upstream gradient at sample points:
    each point's gradient scattered onto its 8 voxels with the trilinear weights."""
    with torch.enable_grad():
        g = grid.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(interpolate_occ_logits(g, points.detach()), g,
                                      logits_grad.detach())
    return grid.detach() - lr * grad
