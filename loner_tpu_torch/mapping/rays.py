"""Differentiable ray building from keyframe point buffers, on the device.

Counterpart of ``loner_tpu/mapping/rays.py``, LiDAR rays only. Every keyframe's
point buffer is padded to one size and stays on the device for the whole window
optimisation; each iteration samples ray indices, applies the pose twists,
scales into the world cube and computes near/far there. Gradients flow from the
loss through ray origins and directions to the twists. Invalid slots and rays
are masked, never filtered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from loner_tpu_torch.common import se3
from loner_tpu_torch.models.rendering import pack_rays


def get_far_val(origins: torch.Tensor, dirs: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """Distance along each ray to the exit of the [-1, 1]^3 cube.
    origins/dirs: (N, 3) -> (N,)."""
    d = dirs + eps
    t_neg = torch.clamp((-1.0 - origins) / d, min=0.0)
    t_pos = torch.clamp((1.0 - origins) / d, min=0.0)
    return torch.maximum(t_neg, t_pos).min(dim=-1).values


@dataclass
class WindowBuffers:
    """Device-resident window of keyframe scans, fixed shape.

    dirs:      (W, P, 3) sensor-frame unit ray directions (padded)
    depths:    (W, P)    measured ranges in meters (padding: 0)
    counts:    (W,)      valid point count per slot
    sky_dirs:  (W, PS, 3) sensor-frame sky directions (padded)
    sky_counts:(W,)      valid sky count per slot
    slot_valid:(W,)      bool, False for empty window slots
    """

    dirs: torch.Tensor
    depths: torch.Tensor
    counts: torch.Tensor
    sky_dirs: torch.Tensor
    sky_counts: torch.Tensor
    slot_valid: torch.Tensor


def _pad_pow2(n: int, minimum: int = 4096) -> int:
    """Quantized size class: the next power of two."""
    p = minimum
    while p < n:
        p *= 2
    return p


def pack_scan_slot(d: np.ndarray, z: np.ndarray, sky: Optional[np.ndarray], p: int,
                   sky_pad: int):
    """Pack one scan into the padded slot layout: (dirs (P,3), depths (P,),
    count, sky_dirs (PS,3), sky_count). Padding repeats the first point so
    gathers stay in range; depth padding is 0."""
    n = d.shape[1]
    dirs = np.zeros((p, 3), np.float32)
    dirs[:n] = d.T
    dirs[n:] = d[:, 0]
    depths = np.zeros((p,), np.float32)
    depths[:n] = z
    sdirs = np.zeros((sky_pad, 3), np.float32)
    ns = 0
    if sky is not None and sky.shape[1] > 0:
        ns = min(sky.shape[1], sky_pad)
        sdirs[:ns] = sky[:, :ns].T
    return dirs, depths, n, sdirs, ns


def build_window_buffers(scans_dirs: List[np.ndarray], scans_depths: List[np.ndarray],
                         sky_dirs: List[Optional[np.ndarray]], window_size: int,
                         sky_pad: int = 4096,
                         device: torch.device = torch.device("cpu")) -> WindowBuffers:
    """Pack host scans into fixed-shape buffers on ``device``.

    scans_dirs[i]: (3, N_i) sensor-frame dirs; scans_depths[i]: (N_i,).
    Empty slots replicate the last scan's data but are masked invalid.
    """
    w = window_size
    m = len(scans_dirs)
    if not 1 <= m <= w:
        raise ValueError(f"{m} scans for a window of {w}")
    p = _pad_pow2(max(d.shape[1] for d in scans_dirs))
    dirs = np.zeros((w, p, 3), np.float32)
    depths = np.zeros((w, p), np.float32)
    counts = np.zeros((w,), np.int32)
    sdirs = np.zeros((w, sky_pad, 3), np.float32)
    scounts = np.zeros((w,), np.int32)
    valid = np.zeros((w,), bool)
    for i in range(w):
        j = min(i, m - 1)
        dirs[i], depths[i], counts[i], sdirs[i], scounts[i] = pack_scan_slot(
            scans_dirs[j], scans_depths[j], sky_dirs[j], p, sky_pad
        )
        valid[i] = i < m
    return WindowBuffers(*(torch.from_numpy(a).to(device)
                           for a in (dirs, depths, counts, sdirs, scounts, valid)))


def sample_and_build_rays(buffers: WindowBuffers, twists: torch.Tensor,
                          world_scale, world_shift: torch.Tensor,
                          ray_range: Tuple[float, float], n_lidar: int, n_sky: int,
                          u: Optional[torch.Tensor] = None,
                          fixed_indices: bool = False):
    """Sample ray indices per slot and build rays, on the device.

    u: (W, n_lidar) uniforms that pick the ray indices (unused with
    ``fixed_indices``). Returns (rays (B, 11) in cube coords, depths_cube (B,),
    valid (B,)) with B = W * n_lidar. Rays with less than 1 m inside the cube,
    or whose origin is outside it, are masked.
    """
    if n_sky > 0:
        raise NotImplementedError("sky rays are not ported yet")
    w = buffers.dirs.shape[0]
    counts = buffers.counts[:, None].long()
    if fixed_indices:
        idx = torch.arange(n_lidar, device=twists.device).expand(w, n_lidar)
    else:
        idx = torch.floor(u * counts.to(u.dtype)).long()
    idx = torch.minimum(idx, counts - 1)

    dirs_s = torch.gather(buffers.dirs, 1, idx[..., None].expand(w, n_lidar, 3))
    depths_m = torch.gather(buffers.depths, 1, idx)
    valid = buffers.slot_valid[:, None].expand(w, n_lidar)

    mats = se3.twist_to_matrix(twists)  # (W, 4, 4), differentiable
    rot, trans = mats[:, None, :3, :3], mats[:, None, :3, 3]
    # World-frame directions as f32 products and sums (no reduced-precision
    # matmul path), normalized.
    dirs_w = (rot * dirs_s[:, :, None, :]).sum(dim=-1)
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    origins = ((trans + world_shift) / world_scale).expand(dirs_w.shape)

    b = w * n_lidar
    origins = origins.reshape(b, 3)
    dirs_w = dirs_w.reshape(b, 3)
    depths_cube = (depths_m / world_scale).reshape(b)
    valid = valid.reshape(b)

    near = torch.full((b,), ray_range[0], dtype=origins.dtype, device=origins.device) / world_scale
    far = torch.clamp(get_far_val(origins, dirs_w), max=ray_range[1] / world_scale)
    valid = valid & (far > near + 1.0 / world_scale)
    valid = valid & (origins.abs().max(dim=-1).values <= 1.0)
    return pack_rays(origins, dirs_w, near, far), depths_cube, valid
