"""Batched point-to-plane ICP in PyTorch.

Counterpart of ``loner_tpu/tracking/icp.py`` (Open3D's ``registration_icp``
with ``TransformationEstimationPointToPlane`` in the reference tracker, with
its 2-stage coarse-to-fine schedule). Everything is fixed-shape tensor ops on
one device:

  * normals: k-NN PCA. Brute-force distance matrix ``|a|^2 + |b|^2 - 2 a.b``,
    ``torch.topk`` neighbours, smallest eigenvector of each 3x3 covariance
  * correspondences: nearest target point per transformed source point,
    rejected beyond the stage threshold by masking
  * update: the 6x6 point-to-plane normal equations, ``torch.linalg.solve_ex``;
    the increment [t, axis-angle] composes onto the transform
  * convergence: relative fitness / RMSE deltas freeze further updates
    (``torch.where``), as Open3D's ICPConvergenceCriteria

Clouds are padded to a fixed size with a validity mask. Beyond 2^26 elements
the distance matrix is blocked over rows (``_map_row_blocks``); the default
5120-point tracker clouds stay one tile.

Precision: the distance terms are ~100 m^2, and a reduced-precision product
(TF32, bf16) quantises them by ~1 m. Every product here runs in float64, which
no matmul precision setting touches, and is rounded to float32; the caller's
``torch.set_float32_matmul_precision`` does not reach the ICP.

No host synchronisation: one ``run_icp_schedule`` uploads its clouds in one
pinned copy and returns device tensors; nothing in it waits for the device
(no ``.item()``, no ``bool()`` of a tensor, no error check of a solver:
``solve_ex``, and closed forms in place of ``eigh`` and ``svd``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from loner_tpu_torch.common import se3


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) source -> target
    fitness: torch.Tensor  # scalar inlier fraction
    inlier_rmse: torch.Tensor  # scalar


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float64, rounded to a's dtype (no reduced-precision path)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(a.dtype)


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) -> (N, M) squared distances |a|^2 + |b|^2 - 2 a.b as one
    float64 product of [a, |a|^2, 1] and [-2b, 1, |b|^2], rounded to float32."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    lhs = torch.cat([a64, (a64 * a64).sum(-1, keepdim=True), torch.ones_like(a64[:, :1])], -1)
    rhs = torch.cat([-2.0 * b64, torch.ones_like(b64[:, :1]), (b64 * b64).sum(-1, keepdim=True)], -1)
    return (lhs @ rhs.T).to(a.dtype).clamp_(min=0.0)


# Memory envelope of the brute-force distance matrices: up to 2^26 elements it
# is one tile; beyond, the row axis is blocked into tiles of at most 2^25.
_SINGLE_TILE_ELEMS = 1 << 26
_BLOCK_BUDGET_ELEMS = 1 << 25


def _row_block(n: int, m: int) -> Optional[int]:
    """Row-block size for an (n, m) distance computation, or None when the
    whole matrix fits the budget. The largest power of two within the budget;
    the rows pad up to a multiple of it."""
    if n * m <= _SINGLE_TILE_ELEMS:
        return None
    block = max(_BLOCK_BUDGET_ELEMS // m, 256)
    b = 1
    while b * 2 <= block:
        b *= 2
    return min(b, n)


def _map_row_blocks(fn, rows: torch.Tensor, m: int):
    """Apply ``fn`` ((B, 3) rows -> tensor or tuple of (B, ...) tensors) over
    row blocks of ``rows`` sized so each (B, m) tile stays inside the budget.
    ``fn`` must be row-independent: the ragged tail is padded with row 0 and
    cut off."""
    n = rows.shape[0]
    block = _row_block(n, m)
    if block is None:
        return fn(rows)
    n_pad = -(-n // block) * block
    if n_pad != n:
        rows = torch.cat([rows, rows[:1].expand(n_pad - n, rows.shape[-1])])
    outs = [fn(rows[i : i + block]) for i in range(0, n_pad, block)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts)[:n] for parts in zip(*outs))
    return torch.cat(outs)[:n]


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, k: int = 30) -> torch.Tensor:
    """k-NN PCA normals (Open3D's ``estimate_normals`` default knn = 30).

    points: (N, 3) padded; valid: (N,) bool. Returns (N, 3) unit normals of
    arbitrary sign (point-to-plane ICP squares the projection)."""
    def knn_rows(rows):  # invalid columns are never neighbours
        d2 = _pairwise_sqdist(rows, points).masked_fill_(~valid[None, :], torch.inf)
        return torch.topk(-d2, k, dim=-1).indices

    idx = _map_row_blocks(knn_rows, points, points.shape[0])
    nbrs = points[idx].to(torch.float64)  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = centered.transpose(1, 2) @ centered / k  # (N, 3, 3)
    normals = se3.symmetric3_smallest_eigvec(cov)
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
    return normals.to(points.dtype)


def _gauss_newton_step(src_t, tgt, tgt_normals, src_valid, tgt_valid, max_dist: float):
    """One point-to-plane Gauss-Newton step. Returns (xi (6,), fitness, rmse)."""
    def nn_rows(rows):
        d2 = _pairwise_sqdist(rows, tgt).masked_fill_(~tgt_valid[None, :], torch.inf)
        return tuple(torch.min(d2, dim=-1))

    nn_d2, nn_idx = _map_row_blocks(nn_rows, src_t, tgt.shape[0])
    q = tgt[nn_idx]
    n = tgt_normals[nn_idx]
    inlier = src_valid & (nn_d2 <= max_dist * max_dist)
    w = inlier.to(src_t.dtype)

    r = torch.sum((src_t - q) * n, dim=-1)  # signed point-to-plane residual
    # Jacobian rows [p x n, n] for the increment [omega, t].
    jac = torch.cat([torch.linalg.cross(src_t, n), n], dim=-1).to(torch.float64)
    jw = jac * w.to(torch.float64)[:, None]
    jtj = jw.T @ jac
    jtr = jw.T @ r.to(torch.float64)
    eye = torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    xi = -torch.linalg.solve_ex(jtj + 1e-6 * eye, jtr).result.to(src_t.dtype)

    w_sum = w.sum()
    fitness = w_sum / torch.clamp(src_valid.sum().to(w.dtype), min=1.0)
    rmse = torch.sqrt((r * r * w).sum() / torch.clamp(w_sum, min=1.0))
    return xi, fitness, rmse


def registration_icp(
    source: torch.Tensor,  # (N, 3) padded
    target: torch.Tensor,  # (M, 3) padded
    target_normals: torch.Tensor,  # (M, 3)
    source_valid: torch.Tensor,  # (N,) bool
    target_valid: torch.Tensor,  # (M,) bool
    max_correspondence_distance: float,
    init: torch.Tensor,  # (4, 4) initial source -> target
    max_iterations: int = 10,
    relative_fitness: float = 1e-8,
    relative_rmse: float = 1e-8,
) -> ICPResult:
    """Point-to-plane ICP: a fixed number of iterations, frozen once the
    relative fitness and RMSE changes fall below their thresholds."""
    t_mat = init.to(source.dtype)
    prev_fit = torch.zeros((), dtype=source.dtype, device=source.device)
    prev_rmse = torch.full((), torch.inf, dtype=source.dtype, device=source.device)
    converged = torch.zeros((), dtype=torch.bool, device=source.device)
    fitness, rmse = prev_fit, prev_rmse
    for _ in range(max_iterations):
        src_t = _mm(source, t_mat[:3, :3].T) + t_mat[:3, 3]
        xi, fitness, rmse = _gauss_newton_step(
            src_t, target, target_normals, source_valid, target_valid,
            float(max_correspondence_distance),
        )
        delta = se3.twist_to_matrix(torch.cat([xi[3:], xi[:3]]))
        new_t = _mm(delta, t_mat)
        newly_converged = (
            (torch.abs(fitness - prev_fit) < relative_fitness * torch.clamp(prev_fit, min=1e-12))
            & (torch.abs(rmse - prev_rmse) < relative_rmse * torch.clamp(prev_rmse, min=1e-12))
        )
        converged = converged | newly_converged
        t_mat = torch.where(converged, t_mat, new_t)
        prev_fit, prev_rmse = fitness, rmse
    return ICPResult(t_mat, fitness, rmse)


def pad_cloud(points: np.ndarray, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (N, 3) to (size, 3) + validity mask; excess points are dropped by
    uniform stride to keep the coverage."""
    n = points.shape[0]
    if n > size:
        points = points[np.linspace(0, n - 1, size).astype(np.int64)]
        n = size
    out = np.zeros((size, 3), np.float32)
    out[:n] = points
    if n > 0:
        out[n:] = points[0]  # padding repeats the first point: distances stay finite
    valid = np.zeros((size,), bool)
    valid[:n] = True
    return out, valid


def _icp_schedule_fused(src, tgt, src_valid, tgt_valid, thresholds: Sequence[float], init,
                        stage_params: Sequence[tuple], knn: int) -> ICPResult:
    """Normals, then every schedule stage, each refining the previous stage's
    transform; the result is projected onto SE(3). Composed float32 Rodrigues
    increments are orthonormal only to ~1e-5 each, and the tracker chains one
    result per frame."""
    normals = estimate_normals(tgt, tgt_valid, k=knn)
    t_mat, result = init, None
    for threshold, (max_iters, rel_fit, rel_rmse) in zip(thresholds, stage_params):
        result = registration_icp(src, tgt, normals, src_valid, tgt_valid, threshold, t_mat,
                                  max_iterations=int(max_iters), relative_fitness=float(rel_fit),
                                  relative_rmse=float(rel_rmse))
        t_mat = result.transformation
    return ICPResult(se3.orthonormalize_transform(result.transformation), result.fitness,
                     result.inlier_rmse)


def run_icp_schedule(
    source: np.ndarray,
    target: np.ndarray,
    schedule: list,
    pad_size: int = 5120,
    init: Union[np.ndarray, torch.Tensor, None] = None,
    knn: int = 30,
    device: Optional[torch.device] = None,
) -> ICPResult:
    """N-stage ICP of host clouds on ``device``: each stage refines the
    previous stage's result with its own correspondence threshold.

    ``init`` is a (4, 4) host array, or the device tensor of a previous
    result (the tracker's chained velocity init). ``device`` defaults to the
    init tensor's device, else the CPU. The clouds, their masks and a host
    init go up in one copy (pinned, asynchronous on a CUDA device); the result
    stays on the device."""
    if device is None:
        device = init.device if isinstance(init, torch.Tensor) else torch.device("cpu")
    device = torch.device(device)
    src, src_valid = pad_cloud(np.asarray(source, np.float32), pad_size)
    tgt, tgt_valid = pad_cloud(np.asarray(target, np.float32), pad_size)
    host_init = None if isinstance(init, torch.Tensor) else (
        np.eye(4, dtype=np.float32) if init is None else np.asarray(init, np.float32))

    n = 2 * pad_size * 4
    flat = np.empty(n + (16 if host_init is not None else 0), np.float32)
    clouds = flat[:n].reshape(2, pad_size, 4)
    clouds[0, :, :3], clouds[0, :, 3] = src, src_valid
    clouds[1, :, :3], clouds[1, :, 3] = tgt, tgt_valid
    if host_init is not None:
        flat[n:] = host_init.reshape(16)
    buf = torch.from_numpy(flat)
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    else:
        buf = buf.to(device)
    dev_clouds = buf[:n].view(2, pad_size, 4)
    t0 = buf[n:].view(4, 4) if host_init is not None else init.to(device, torch.float32)

    thresholds = [float(s["threshold"]) for s in schedule]
    stage_params = [(int(s["max_iterations"]), float(s.get("relative_fitness", 1e-8)),
                     float(s.get("relative_rmse", 1e-8))) for s in schedule]
    return _icp_schedule_fused(
        dev_clouds[0, :, :3], dev_clouds[1, :, :3], dev_clouds[0, :, 3] > 0.5,
        dev_clouds[1, :, 3] > 0.5, thresholds, t0, stage_params, knn,
    )
