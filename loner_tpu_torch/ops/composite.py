"""Fused alpha compositing over ray samples, forward only.

PyTorch counterpart of ``loner_tpu/ops/pallas/composite.py``. On a CUDA tensor
``composite_rays`` is the hand-written Hopper kernel of ``csrc/composite.cu``;
on a CPU tensor it is the plain PyTorch version below, the same function as
``models/rendering.py::raw2outputs`` without sigma noise:

  delta_i = (z_{i+1} - z_i) |d|, the last delta 1e10 |d|
  alpha_i = 1 - exp(-delta_i act(sigma_i)),  act = relu or softplus
  w_i     = alpha_i prod_{j<i} (1 - alpha_j + 1e-10)
  opacity = sum w,  depth = sum w z + (1 - opacity) far,  var = sum w (depth - z)^2

The kernel has no backward (the test-render path needs none): the CUDA wrapper
refuses inputs that ask for a gradient.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F_nn

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class LaunchCounts:
    """Kernel launches made by the wrapper of this module."""

    def __init__(self) -> None:
        self.composite_launches = 0

    def reset(self) -> None:
        self.composite_launches = 0


counts = LaunchCounts()


def composite_plain(z_vals: torch.Tensor, sigmas: torch.Tensor, far: torch.Tensor,
                    rays_d_norm: torch.Tensor, softplus: bool = False) -> Outputs:
    """Plain version of the kernel. z_vals, sigmas (raw, pre-activation): (B, S);
    far, rays_d_norm: (B,). Returns (depth, opacity, var (B,), weights (B, S))."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(z_vals[:, :1], 1e10)], dim=-1)  # S = 1 too
    deltas = deltas * rays_d_norm[:, None]
    act = F_nn.softplus(sigmas) if softplus else torch.relu(sigmas)
    alphas = 1.0 - torch.exp(-deltas * act)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1), dim=-1
    )[:, :-1]
    weights = alphas * trans
    opacity = weights.sum(dim=-1)
    depth = (weights * z_vals).sum(dim=-1) + (1.0 - opacity) * far
    var = (weights * (depth[:, None] - z_vals) ** 2).sum(dim=-1)
    return depth, opacity, var, weights


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

MAX_THREADS = 256  # a block's threads (csrc/composite.cu::kMaxThreads)


@dataclass(frozen=True)
class CompositePlan:
    """How ``lt_composite`` covers a (B, S) call: one block of ``threads`` per ray,
    ``v`` consecutive samples per thread, ``tiles`` per row (threads * v * tiles >=
    S); ``vec`` for 16-byte accesses (S % 4 == 0 and rows 16-byte aligned)."""

    threads: int
    v: int
    tiles: int
    vec: bool


def composite_plan(s: int, aligned: bool = True) -> CompositePlan:
    """The launch plan for rows of S samples (``aligned``: z, sigma and the weights
    start on 16 bytes). One tile up to S = 2048 (128 x 8 at 1024, 256 x 8 at 2048),
    so that a row is read once into registers."""
    v = 8 if s >= 256 else 4
    threads = min(MAX_THREADS, 32 * -(-s // (32 * v)))
    return CompositePlan(threads, v, -(-s // (threads * v)), aligned and s % 4 == 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernel, with its C signature declared (pointers and the stream
    as void*, so ctypes does not cut them to 32 bits)."""
    from loner_tpu_torch.ops.build import load_library

    lib = load_library("composite")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lt_composite.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.lt_composite.restype = ctypes.c_int
    return lib


def check_operands(z_vals, sigmas, far, rays_d_norm) -> Tuple[int, int]:
    """Raise ValueError unless the operands are what the kernel takes: float32,
    contiguous, on one device, (B, S), (B, S), (B,), (B,), no gradient asked.
    Returns (B, S)."""
    if z_vals.dim() != 2:
        raise ValueError(f"z_vals must be (B, S), got {tuple(z_vals.shape)}")
    b, s = z_vals.shape
    for name, t, shape in (("z_vals", z_vals, (b, s)), ("sigmas", sigmas, (b, s)),
                           ("far", far, (b,)), ("rays_d_norm", rays_d_norm, (b,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != z_vals.device:
            raise ValueError(f"{name} is on {t.device}, z_vals on {z_vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("the composite kernel is forward only; use composite_plain "
                             "where a gradient is needed")
    # Sample indices of a row's last tile stay below 2^31.
    if b >= 2 ** 31 or s > 2 ** 31 - 8 * MAX_THREADS:
        raise ValueError(f"({b}, {s}): the kernel takes fewer than 2^31 rays and "
                         f"{2 ** 31 - 8 * MAX_THREADS} samples")
    return b, s


def launch(z_vals, sigmas, far, rays_d_norm, softplus: bool, depth, opacity, var,
           weights) -> None:
    """One launch of the kernel on the current stream, into the given outputs, for
    operands that ``check_operands`` passed with B, S > 0."""
    b, s = z_vals.shape
    plan = composite_plan(s, all(t.data_ptr() % 16 == 0 for t in (z_vals, sigmas, weights)))
    with torch.cuda.device(z_vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().lt_composite(
            *(ctypes.c_void_p(t.data_ptr()) for t in (z_vals, sigmas, far, rays_d_norm)),
            b, s, int(softplus), plan.threads, plan.v, plan.tiles, int(plan.vec),
            *(ctypes.c_void_p(t.data_ptr()) for t in (depth, opacity, var, weights)),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"lt_composite failed with CUDA error {rc}")
    counts.composite_launches += 1


def composite_cuda(z_vals, sigmas, far, rays_d_norm, softplus: bool = False) -> Outputs:
    b, s = check_operands(z_vals, sigmas, far, rays_d_norm)
    dev = z_vals.device
    depth = torch.empty((b,), dtype=torch.float32, device=dev)
    opacity = torch.empty((b,), dtype=torch.float32, device=dev)
    var = torch.empty((b,), dtype=torch.float32, device=dev)
    weights = torch.empty((b, s), dtype=torch.float32, device=dev)
    if b == 0 or s == 0:
        return depth, opacity, var, weights
    launch(z_vals, sigmas, far, rays_d_norm, softplus, depth, opacity, var, weights)
    return depth, opacity, var, weights


def composite_rays(z_vals: torch.Tensor, sigmas: torch.Tensor, far: torch.Tensor,
                   rays_d_norm: torch.Tensor, softplus: bool = False,
                   plain: bool = False) -> Outputs:
    """Fused compositing: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor (or on any device when ``plain`` asks for the reference).
    Returns (depth (B,), opacity (B,), var (B,), weights (B, S))."""
    if plain or z_vals.device.type == "cpu":
        return composite_plain(z_vals, sigmas, far, rays_d_norm, softplus)
    if z_vals.device.type == "cuda":
        return composite_cuda(z_vals, sigmas, far, rays_d_norm, softplus)
    raise ValueError(f"no compositing implementation for device {z_vals.device}")
