"""Isosurface extraction: marching tetrahedra as torch ops on the grid's device.

Counterpart of ``loner_tpu/ops/marching.py``, the same algorithm: each cell is
split into 6 tetrahedra around its 0-6 diagonal, each tetrahedron's 16 cases
come from the same derived table, the triangles are emitted in the same order
(tetrahedron, case, triangle of the case, cell in index order), duplicate
vertices are welded on keys rounded at 1e5 and degenerate faces dropped. The
weight grid of the mesher lives on the card, so the marching runs there too.

Arithmetic: the JAX package computes ``t`` in float32 and the vertex
``pa + t (pb - pa)`` in float64 (int64 corners times a float32 ``t``) before
casting it to float32. Here the vertex is computed in float32: ``pb - pa`` is
-1, 0 or 1, so ``t (pb - pa)`` is exact and ``pa + t (pb - pa)`` is rounded
once either way, to the same float32 value. The weld keeps, for each welded
vertex, the coordinates of its last occurrence (the value numpy's fancy
assignment leaves in practice).

The API mirrors skimage.measure.marching_cubes: vertices are in grid-index
coordinates.
"""
from __future__ import annotations

from typing import Tuple

import torch

# Cube corner offsets, standard numbering.
_CORNERS = [
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
]

# 6-tetrahedron decomposition of the cube around the 0-6 diagonal.
_TETS = [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)]


def _tet_case_triangles(mask: int):
    """Triangles for a tet occupancy mask, as lists of (inside, outside)
    vertex-index pairs (edges crossed by the surface)."""
    inside = [i for i in range(4) if (mask >> i) & 1]
    outside = [i for i in range(4) if not (mask >> i) & 1]
    if len(inside) == 0 or len(inside) == 4:
        return []
    if len(inside) == 1:
        a = inside[0]
        return [[(a, outside[0]), (a, outside[1]), (a, outside[2])]]
    if len(inside) == 3:
        d = outside[0]
        return [[(inside[0], d), (inside[1], d), (inside[2], d)]]
    a, b = inside
    c, d = outside
    # Quad (a,c)-(a,d)-(b,d)-(b,c) -> two triangles.
    return [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]


_CASES = {m: _tet_case_triangles(m) for m in range(16)}


def marching_tetrahedra(grid, level: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract the isosurface ``grid == level``.

    grid: (X, Y, Z) scalar field, a tensor (the marching runs on its device) or
    an array. Returns (vertices (V, 3) float32 in index coordinates, faces (F,
    3) int64), on the grid's device."""
    grid = torch.as_tensor(grid).to(torch.float32)
    dev = grid.device
    nx, ny, nz = grid.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    n_cells = cx * cy * cz

    # Corner values (8, C), cells in index order (x slowest).
    vals = torch.stack([grid[dx:dx + cx, dy:dy + cy, dz:dz + cz].reshape(-1)
                        for dx, dy, dz in _CORNERS])
    corners = torch.tensor(_CORNERS, dtype=torch.float32, device=dev)

    def cell_base(sel: torch.Tensor) -> torch.Tensor:
        """(n, 3) float32 base corner of the cells ``sel`` (flat indices)."""
        return torch.stack([sel // (cy * cz), (sel // cz) % cy, sel % cz], dim=1).to(torch.float32)

    tris = []
    for tet in _TETS:
        tv = vals[list(tet)]  # (4, C)
        inside = (tv > level).to(torch.int8)
        case = inside[0] + 2 * inside[1] + 4 * inside[2] + 8 * inside[3]
        for m in range(1, 15):
            sel = torch.nonzero(case == m)[:, 0]
            if sel.numel() == 0:
                continue
            base = cell_base(sel)
            for tri_edges in _CASES[m]:
                verts = []
                for vi, vo in tri_edges:
                    ci, co = tet[vi], tet[vo]
                    pa, pb = base + corners[ci], base + corners[co]
                    va, vb = vals[ci][sel], vals[co][sel]
                    t = (level - va) / torch.where(vb == va, 1.0, vb - va)
                    t = torch.clamp(t, 0.0, 1.0)[:, None]
                    verts.append(pa + t * (pb - pa))
                tris.append(torch.stack(verts, dim=1))  # (n, 3, 3)

    if not tris or n_cells == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))

    flat = torch.cat(tris, dim=0).reshape(-1, 3)  # (3T, 3)
    # Weld duplicate vertices (quantize to kill float jitter).
    keys = torch.round(flat * 1e5).to(torch.int64)
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    # Representative coordinates: each welded vertex's last occurrence.
    last = torch.full((uniq.shape[0],), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, inverse, torch.arange(flat.shape[0], device=dev), "amax")
    verts_out = flat[last]
    faces = inverse.reshape(-1, 3)
    # Drop degenerate faces (all mask-boundary cases can collapse).
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts_out, faces[ok]


def marching_cubes_compat(grid, level: float):
    """skimage.measure.marching_cubes-compatible wrapper: returns (verts, faces,
    normals=None, values=None), as numpy arrays on the host."""
    verts, faces = marching_tetrahedra(grid, level)
    return verts.cpu().numpy(), faces.cpu().numpy(), None, None

