"""Depth-map warping and optical-flow colouring, in numpy.

Counterpart of ``loner_tpu/analysis/warp.py``, with its conventions: depths are
positive ray ranges along each pixel's ray (what the renderer writes), and
holes are ``np.inf``.
"""
from __future__ import annotations

import numpy as np


def vis_flow(flow: np.ndarray, scale: float = 0.0) -> np.ndarray:
    """A (H, W, 2) pixel displacement field as (H, W, 3) float RGB in [0, 1]:
    hue is the direction, saturation the magnitude (min-max normalised, or over
    ``scale``), value 1."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.hypot(fx, fy)
    ang = np.degrees(np.arctan2(fy, fx)) % 360.0
    if scale == 0.0:
        rng = mag.max() - mag.min()
        mag = (mag - mag.min()) / rng if rng > 0 else np.zeros_like(mag)
    else:
        mag = mag / scale
    mag = np.clip(mag, 0.0, 1.0)
    # HSV -> RGB with s = mag, v = 1, by hue sector.
    h6 = ang / 60.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p, q, t = 1.0 - mag, 1.0 - mag * f, 1.0 - mag * (1.0 - f)
    one = np.ones_like(mag)
    lut = np.stack([np.stack(c, -1) for c in ((one, t, p), (q, one, p), (p, one, t),
                                              (p, q, one), (t, p, one), (one, p, q))], 0)
    return np.take_along_axis(lut, i[None, ..., None], axis=0)[0]


def depth_to_warp(depth_map1: np.ndarray, depth_map2: np.ndarray, K1: np.ndarray,
                  T12: np.ndarray, K2: np.ndarray, occlusion_threshold: float = 0.5) -> tuple:
    """The pixel warp from camera 1 to camera 2 that two range maps imply.

    ``T12`` maps camera-1 points into camera 2's frame. Returns ``(warp, mask)``:
    (H, W, 2) f32 displacements (u2 - u1, v2 - v1), zero at holes, and (H, W, 1)
    visibility, True where the warped point lies inside camera 2's image, in
    front of it, not at a hole, and within ``occlusion_threshold`` of the
    smallest range of the 4 pixels around its projection."""
    assert depth_map1.shape == depth_map2.shape, "depth maps must share a shape"
    H, W = depth_map1.shape
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    u1, v1 = uu.reshape(-1), vv.reshape(-1)
    d1 = depth_map1.reshape(-1).astype(np.float64)
    holes1 = ~np.isfinite(d1)
    x_over_z = (u1 - K1[0, 2]) / K1[0, 0]
    y_over_z = (v1 - K1[1, 2]) / K1[1, 1]
    # Range along the unit ray -> z, its optical-axis leg.
    z = np.where(holes1, 1.0, d1) / np.sqrt(1.0 + x_over_z**2 + y_over_z**2)
    pts1 = np.stack([x_over_z * z, y_over_z * z, z, np.ones_like(z)], axis=0)
    pts2 = (np.asarray(T12, np.float64) @ pts1)[:3]  # (3, H W) in camera 2's frame
    z2 = np.maximum(pts2[2], 1e-9)
    u2 = K2[0, 0] * pts2[0] / z2 + K2[0, 2]
    v2 = K2[1, 1] * pts2[1] / z2 + K2[1, 2]
    warp = np.stack([u2 - u1, v2 - v1], axis=1).reshape(H, W, 2).astype(np.float32)
    warp[~np.isfinite(depth_map1)] = 0.0

    range2_warped = np.linalg.norm(pts2, axis=0)
    u_lo = np.clip(np.floor(u2).astype(int), 0, W - 1)
    u_hi = np.clip(np.ceil(u2).astype(int), 0, W - 1)
    v_lo = np.clip(np.floor(v2).astype(int), 0, H - 1)
    v_hi = np.clip(np.ceil(v2).astype(int), 0, H - 1)
    behind = pts2[2] <= 0
    neighbor_min = np.minimum.reduce([depth_map2[v_lo, u_lo], depth_map2[v_lo, u_hi],
                                      depth_map2[v_hi, u_lo], depth_map2[v_hi, u_hi]])
    in_bounds = (u2 >= 0) & (u2 <= W - 1) & (v2 >= 0) & (v2 <= H - 1)
    consistent = np.abs(neighbor_min - range2_warped) < occlusion_threshold
    mask = (consistent & in_bounds & ~behind & ~holes1).reshape(H, W, 1)
    return warp, mask
