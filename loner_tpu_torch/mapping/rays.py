"""Differentiable ray building from keyframe point buffers, on the device.

Counterpart of ``loner_tpu/mapping/rays.py``: LiDAR, sky and camera rays. Every
keyframe's point buffer is padded to one size and stays on the device for the
whole window optimisation; each iteration samples ray indices, applies the pose
twists, scales into the world cube and computes near/far there. Gradients flow
from the loss through the LiDAR rays' origins and directions to the twists; sky
rays are built from detached poses. Camera rays come from the window's images
(``CameraWindowBuffers``): pixels drawn per slot, cast from the camera pose.
Invalid slots and rays are masked, never filtered.
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
                          fixed_indices: bool = False,
                          sky_u: Optional[torch.Tensor] = None, gather=None):
    """Sample ray indices per slot and build rays, on the device.

    u: (W, n_lidar) uniforms that pick the ray indices (unused with
    ``fixed_indices``); sky_u: (W, n_sky) uniforms that pick the sky directions.
    Returns (rays (B, 11) in cube coords, depths_cube (B,), valid (B,)) with
    B = W * (n_lidar + n_sky), each slot's rays laid out as [n_lidar | n_sky].
    Sky rays take the depth ray_range[1] + 1 (transparent supervision), are
    valid where their slot is and has sky directions, and are built from
    detached poses: no pose gradient comes from them. Rays with less than 1 m
    inside the cube, or whose origin is outside it, are masked. ``gather``:
    ``(buffers, idx) -> (dirs (W, n, 3), depths (W, n))`` in place of the
    gathers from the buffers (a mesh's ray axis, ``parallel/mesh.py``).
    """
    w = buffers.dirs.shape[0]
    counts = buffers.counts[:, None].long()
    if fixed_indices:
        idx = torch.arange(n_lidar, device=twists.device).expand(w, n_lidar)
    else:
        idx = torch.floor(u * counts.to(u.dtype)).long()
    idx = torch.minimum(idx, counts - 1)

    if gather is None:
        dirs_s = torch.gather(buffers.dirs, 1, idx[..., None].expand(w, n_lidar, 3))
        depths_m = torch.gather(buffers.depths, 1, idx)
    else:
        dirs_s, depths_m = gather(buffers, idx)
    valid = buffers.slot_valid[:, None].expand(w, n_lidar)

    mats = se3.twist_to_matrix(twists)  # (W, 4, 4), differentiable
    rot, trans = mats[:, None, :3, :3], mats[:, None, :3, 3]
    # World-frame directions as f32 products and sums (no reduced-precision
    # matmul path), normalized.
    dirs_w = (rot * dirs_s[:, :, None, :]).sum(dim=-1)
    origins = ((trans + world_shift) / world_scale).expand(dirs_w.shape)
    if n_sky > 0:
        sky_counts = buffers.sky_counts[:, None]
        sidx = torch.floor(sky_u * torch.clamp(sky_counts, min=1).to(sky_u.dtype)).long()
        sky_s = torch.gather(buffers.sky_dirs, 1, sidx[..., None].expand(w, n_sky, 3))
        sky_w = (rot.detach() * sky_s[:, :, None, :]).sum(dim=-1)
        sky_o = ((trans.detach() + world_shift) / world_scale).expand(sky_w.shape)
        dirs_w = torch.cat([dirs_w, sky_w], dim=1)
        origins = torch.cat([origins, sky_o], dim=1)
        depths_m = torch.cat([depths_m, torch.full((w, n_sky), ray_range[1] + 1.0,
                                                   dtype=depths_m.dtype, device=depths_m.device)],
                             dim=1)
        sky_valid = buffers.slot_valid[:, None] & (sky_counts > 0)
        valid = torch.cat([valid, sky_valid.expand(w, n_sky)], dim=1)
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)

    b = w * (n_lidar + n_sky)
    origins = origins.reshape(b, 3)
    dirs_w = dirs_w.reshape(b, 3)
    depths_cube = (depths_m / world_scale).reshape(b)
    valid = valid.reshape(b)

    near = torch.full((b,), ray_range[0], dtype=origins.dtype, device=origins.device) / world_scale
    far = torch.clamp(get_far_val(origins, dirs_w), max=ray_range[1] / world_scale)
    valid = valid & (far > near + 1.0 / world_scale)
    valid = valid & (origins.abs().max(dim=-1).values <= 1.0)
    return pack_rays(origins, dirs_w, near, far), depths_cube, valid


@dataclass
class CameraWindowBuffers:
    """Device-resident window of keyframe camera images, fixed shape.

    cam_dirs:        (HW, 3) camera-frame pixel ray directions (one calibration a run)
    intensities:     (W, HW, C) per-slot pixel values in [0, 1] (zeros without an image)
    has_image:       (W,) bool, False for slots without a matched image
    lidar_to_camera: (4, 4) extrinsic (LiDAR pose -> camera pose)
    """

    cam_dirs: torch.Tensor
    intensities: torch.Tensor
    has_image: torch.Tensor
    lidar_to_camera: torch.Tensor


def pack_camera_images(images: List[Optional[np.ndarray]], hw: int, window_size: int,
                       num_colors: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Per-slot (H, W, C) images in [0, 1] (or None) -> ((W, HW, C) f32 pixels,
    (W,) bool). A mono image is broadcast to ``num_colors``."""
    intens = np.zeros((window_size, hw, num_colors), np.float32)
    has = np.zeros((window_size,), bool)
    for i, img in enumerate(images[:window_size]):
        if img is None:
            continue
        flat = np.asarray(img, np.float32).reshape(-1, img.shape[-1] if img.ndim == 3 else 1)
        if flat.shape[-1] != num_colors:
            flat = np.broadcast_to(flat[:, :1], (flat.shape[0], num_colors))
        n = min(flat.shape[0], hw)
        intens[i, :n] = flat[:n]
        has[i] = True
    return intens, has


def build_camera_window_buffers(images: List[Optional[np.ndarray]], cam_dirs: np.ndarray,
                                lidar_to_camera: np.ndarray, window_size: int,
                                num_colors: int = 3,
                                device: torch.device = torch.device("cpu")) -> CameraWindowBuffers:
    """Pack per-slot images into fixed-shape device buffers; slots without an
    image hold zeros and are masked by ``has_image``."""
    intens, has = pack_camera_images(images, cam_dirs.shape[0], window_size, num_colors)
    return CameraWindowBuffers(
        torch.from_numpy(np.asarray(cam_dirs, np.float32)).to(device),
        torch.from_numpy(intens).to(device), torch.from_numpy(has).to(device),
        torch.from_numpy(np.asarray(lidar_to_camera, np.float32)).to(device))


def sample_and_build_camera_rays(cam: CameraWindowBuffers, twists: torch.Tensor, world_scale,
                                 world_shift: torch.Tensor, ray_range: Tuple[float, float],
                                 n_camera: int, slot_valid: torch.Tensor, u: torch.Tensor,
                                 detach_poses: bool = True):
    """Pick pixels per slot by ``u`` ((W, n_camera) uniforms) and build their
    rays from the camera pose (LiDAR pose times the extrinsic), in cube
    coordinates: near = ray_range[0] / scale, far = the cube's exit. With
    ``detach_poses`` (the default) no gradient reaches the twists. Returns
    (rays (B, 11), intensities (B, C), valid (B,)), B = W n_camera; a ray is
    valid where its slot is and has an image and its origin lies in the cube."""
    w = twists.shape[0]
    hw = cam.cam_dirs.shape[0]
    idx = torch.clamp(torch.floor(u * hw).long(), max=hw - 1)
    dirs_c = cam.cam_dirs[idx.reshape(-1)].reshape(w, n_camera, 3)
    intens = torch.gather(cam.intensities, 1,
                          idx[..., None].expand(w, n_camera, cam.intensities.shape[-1]))

    mats = se3.twist_to_matrix(twists)
    if detach_poses:
        mats = mats.detach()
    cam_mats = mats @ cam.lidar_to_camera[None]
    dirs_w = (cam_mats[:, None, :3, :3] * dirs_c[:, :, None, :]).sum(dim=-1)
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    origins = ((cam_mats[:, None, :3, 3] + world_shift) / world_scale).expand(dirs_w.shape)

    b = w * n_camera
    origins = origins.reshape(b, 3)
    dirs_w = dirs_w.reshape(b, 3)
    near = torch.full((b,), ray_range[0], dtype=origins.dtype, device=origins.device) / world_scale
    far = get_far_val(origins, dirs_w)
    valid = (slot_valid & cam.has_image)[:, None].expand(w, n_camera).reshape(b)
    valid = valid & (origins.abs().max(dim=-1).values <= 1.0)
    return pack_rays(origins, dirs_w, near, far), intens.reshape(b, -1), valid


class DeviceScanPool:
    """Per-keyframe scans resident on the device.

    Counterpart of ``loner_tpu/mapping/rays.py::DeviceScanPool``. Each
    keyframe's padded scan is uploaded once, when it first enters a window, and
    windows are assembled on the device with ``torch.stack``: a keyframe moves
    about 1 MB to the device once, where a host-built window would ship all its
    slots every time. All scans pad to one shared power-of-two size, so a
    window matches ``build_window_buffers`` bit for bit; a scan beyond the
    current size re-pads the pool on the device.

    Entries are keyed by the keyframe's monotonic ``uid`` and never evicted
    (keyframes are never culled). ``uploads`` counts host-to-device uploads.
    """

    def __init__(self, device: torch.device, sky_pad: int = 4096) -> None:
        self._device = torch.device(device)
        self._entries: dict = {}
        self._p: Optional[int] = None
        self._sky_pad = sky_pad
        self.uploads = 0

    def _pack(self, kf, use_mask: bool) -> dict:
        d, z = kf.scan_dirs(use_mask), kf.scan_depths(use_mask)
        n = d.shape[1]
        if self._p is None or n > self._p:
            new_p = _pad_pow2(n)
            for e in self._entries.values():  # re-pad: pad rows repeat point 0
                pad = new_p - e["dirs"].shape[0]
                e["dirs"] = torch.cat([e["dirs"], e["dirs"][:1].expand(pad, 3)])
                e["depths"] = torch.cat([e["depths"], e["depths"].new_zeros(pad)])
            self._p = new_p
        dirs, depths, count, sdirs, ns = pack_scan_slot(d, z, kf.sky_dirs(), self._p, self._sky_pad)
        self.uploads += 1
        return {"dirs": torch.from_numpy(dirs).to(self._device),
                "depths": torch.from_numpy(depths).to(self._device), "count": count,
                "sky_dirs": torch.from_numpy(sdirs).to(self._device), "sky_count": ns}

    def build_window(self, window: list, window_size: int, use_mask: bool) -> WindowBuffers:
        """WindowBuffers for a keyframe window; uploads only unseen scans.
        Empty slots replicate the last keyframe's scan and are masked invalid,
        as in ``build_window_buffers``."""
        w, m = window_size, len(window)
        if not 1 <= m <= w:
            raise ValueError(f"{m} keyframes for a window of {w}")
        entries = []
        for kf in window:
            key = (kf.uid, use_mask)
            if key not in self._entries:
                self._entries[key] = self._pack(kf, use_mask)
            entries.append(self._entries[key])
        slots = [entries[min(i, m - 1)] for i in range(w)]
        small = torch.from_numpy(np.asarray(
            [[e["count"] for e in slots], [e["sky_count"] for e in slots], [i < m for i in range(w)]],
            np.int32)).to(self._device)
        return WindowBuffers(
            torch.stack([e["dirs"] for e in slots]), torch.stack([e["depths"] for e in slots]),
            small[0], torch.stack([e["sky_dirs"] for e in slots]), small[1], small[2].bool(),
        )
