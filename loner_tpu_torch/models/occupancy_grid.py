"""Occupancy grid (OGM): a learnable 3D log-odds field that guides sampling.

Counterpart of ``loner_tpu/models/occupancy_grid.py``. The grid is a plain
``(V, V, V)`` f32 tensor of logits, state rather than a parameter: it is read by
trilinear interpolation (``grid_sample`` on [-1, 1] coordinates,
``align_corners=False``, zero padding; x indexes the last axis) and moved by an
SGD step on the interpolation's gradient, the reference's
``point_logits.backward(gradient=g)`` + ``SGD.step()``. The JAX package computes
both in XLA; the grid is 4 MB at V = 100, so no kernel is written for them.

The gradient is an explicit scatter of each point's 8 trilinear weights times its
upstream gradient onto the voxels, in fixed point (``ops/fixed_point.py``, at
2^OGM_BITS, ``index_add_`` on int64): the same bits on every run, under any
permutation of the points and when the points are split into parts whose int64
sums are added (a mesh's ranks). ``grid_sample``'s own backward adds float atomics
in whatever order a CUDA device reaches them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F_nn

from loner_tpu_torch.ops.fixed_point import OGM_BITS, FixedPointSum


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


def grid_sum(grid: torch.Tensor, out: Optional[torch.Tensor] = None) -> FixedPointSum:
    """A zeroed fixed-point sum for ``grid``'s gradient (``out``: an int64 view to
    hold it)."""
    return FixedPointSum(grid.shape, OGM_BITS, grid.device, out=out)


def scatter_occ_grad(grid: torch.Tensor, points: torch.Tensor, logits_grad: torch.Tensor,
                     sink: FixedPointSum) -> None:
    """Add the grid's gradient from the upstream gradient at (..., 3) sample points
    to ``sink``: corner (z, y, x) of a point's cell gets ``((g wx) wy) wz`` (the
    JAX package's vjp of its trilinear sum, product for product), a corner outside
    the grid nothing (zero padding); x indexes the last axis, voxel centres at
    (i + 0.5) / V (``align_corners=False``)."""
    v = grid.shape[0]
    p = points.detach().reshape(-1, 3).to(torch.float32)
    g = logits_grad.detach().reshape(-1).to(torch.float32)
    coords = (p + 1.0) * 0.5 * v - 0.5
    c0 = torch.floor(coords)
    frac = coords - c0
    # Per axis (N, 3, 2): the two corners' cells, weights (1 - f, f) and whether
    # they lie inside the grid; the 8 corners (N, x, y, z) by broadcasting.
    cell = c0.to(torch.int32)[..., None] + torch.arange(2, dtype=torch.int32, device=p.device)
    w = torch.stack([1.0 - frac, frac], dim=-1)
    inside = (cell >= 0) & (cell <= v - 1)
    cell = cell.clamp(0, v - 1)
    wx, wy, wz = w[:, 0, :, None, None], w[:, 1, None, :, None], w[:, 2, None, None, :]
    vals = (g[:, None, None, None] * wx) * wy * wz
    cx, cy, cz = cell[:, 0, :, None, None], cell[:, 1, None, :, None], cell[:, 2, None, None, :]
    idx = cx + v * (cy + v * cz)
    keep = inside[:, 0, :, None, None] & inside[:, 1, None, :, None] & inside[:, 2, None, None, :]
    sink.add_(idx.reshape(-1), torch.where(keep, vals, 0.0).reshape(-1, 1))


def occ_grid_grad(grid: torch.Tensor, points: torch.Tensor,
                  logits_grad: torch.Tensor) -> torch.Tensor:
    """The grid's gradient from the upstream gradient at sample points: each
    point's gradient scattered onto its 8 voxels with the trilinear weights, in
    fixed point (``scatter_occ_grad``), converted to f32."""
    acc = grid_sum(grid)
    scatter_occ_grad(grid, points, logits_grad, acc)
    return acc.to_float()


def occ_grid_update(grid: torch.Tensor, points: torch.Tensor, logits_grad: torch.Tensor,
                    lr: float) -> torch.Tensor:
    """One SGD step on the grid given the upstream gradient at sample points."""
    return grid.detach() - lr * occ_grid_grad(grid, points, logits_grad)
