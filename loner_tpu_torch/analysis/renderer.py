"""Depth frames from a trained checkpoint.

Counterpart of the frame part of ``loner_tpu/analysis/renderer.py``: ray
directions for a pinhole camera or a panorama, and ``render_dataset_frame``,
which renders one depth / variance / opacity (and intensity) frame at a pose in
ray chunks.
The sequence, flythrough and PNG writers are not ported (they need
matplotlib).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from loner_tpu_torch.analysis.render_utils import LoadedModel, render_depth_chunked


def camera_ray_directions(k: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H*W, 3) pinhole ray directions in camera frame (z forward)."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    dirs = np.stack(
        [(xs - k[0, 2]) / k[0, 0], (ys - k[1, 2]) / k[1, 1], np.ones_like(xs, dtype=np.float64)],
        axis=-1,
    ).reshape(-1, 3)
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def spherical_ray_directions(
    width: int = 512, height: int = 256, v_fov_deg: Tuple[float, float] = (-45, 45)
) -> np.ndarray:
    """Panoramic (equirectangular) directions: the natural 'image' for a
    lidar-only map."""
    azim = np.linspace(0, 2 * np.pi, width, endpoint=False)
    elev = np.deg2rad(np.linspace(v_fov_deg[1], v_fov_deg[0], height))
    az, el = np.meshgrid(azim, elev)
    return np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    ).reshape(-1, 3).astype(np.float32)


def render_dataset_frame(
    model: LoadedModel,
    pose_mat: np.ndarray,
    dirs_sensor: np.ndarray,
    image_shape: Tuple[int, int],
    ray_range: Optional[Tuple[float, float]] = None,
    n_samples: int = 2048,
    chunk: int = 2048,
    with_intensity: bool = False,
    with_peak: bool = False,
) -> dict:
    """Render one frame; returns {'depth', 'variance', 'opacity'} as (H, W),
    plus 'intensity' (H, W, C) when ``with_intensity`` (a head trained with
    ``freeze_rgb_mlp: False``) and 'peak_depth_consistency' (H, W) meters when
    ``with_peak``."""
    if ray_range is None:
        ray_range = tuple(
            float(x) for x in model.settings.mapper.optimizer.model_config["data"]["ray_range"]
        )
    dirs_world = dirs_sensor @ pose_mat[:3, :3].T
    origins = np.broadcast_to(pose_mat[:3, 3], dirs_world.shape)
    out = render_depth_chunked(
        model, origins, dirs_world, ray_range, n_samples=n_samples, chunk=chunk,
        with_intensity=with_intensity, with_peak=with_peak,
    )
    h, w = image_shape
    result = {
        "depth": out["depth"].reshape(h, w),
        "variance": out["variance"].reshape(h, w),
        "opacity": out["opacity"].reshape(h, w),
    }
    if with_intensity:
        result["intensity"] = out["rgb"].reshape(h, w, -1)
    if with_peak:
        result["peak_depth_consistency"] = out["peak_depth_consistency"].reshape(h, w)
    return result
