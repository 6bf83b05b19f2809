"""Fused Fourier-feature + MLP sigma head, forward and backward.

PyTorch counterpart of ``loner_tpu/ops/pallas/fourier_mlp.py``. On a CUDA tensor
the forward and the backward are the hand-written Hopper kernels of
``csrc/fourier_mlp.cu``; on a CPU tensor they are the plain PyTorch version
below, which computes the same function with bf16 rounding at the same places:

  forward   x = [bf16 sin(pts01 B), bf16 cos(pts01 B), bf16 pts01]
            h_i = bf16(relu(h_{i-1} W_i + b_i)),  sigma = h W_L + b_L   (f32 out)
  backward  recompute the forward; cotangents rounded to bf16 after each ReLU
            mask; dW = h^T g and db = sum g in f32;
            dpts = g W_0[2F:]^T + bf16(dx_sin cos - dx_cos sin) bf16(B^T); dB = 0.

The plain version holds bf16 values in float32 tensors and multiplies them in
float32: products of two bf16 values are exact in float32, so this is the
kernel's bf16 x bf16 -> f32 product up to the order of summation.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

TILE = 64  # points per tile in csrc/fourier_mlp.cu


class LaunchCounts:
    """Kernel launches made by the wrappers of this module."""

    def __init__(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0

    def reset(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0


counts = LaunchCounts()


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round float32 values to ``dtype`` and hold them in float32."""
    return x.to(dtype).to(torch.float32)


def _features(pts01: torch.Tensor, bmat: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # Three rounded products and two rounded sums, the kernel's order (no FMA):
    # the phase reaches ~110 rad, where an f32 ulp flips bf16 roundings of sin.
    proj = pts01[:, 0:1] * bmat[0] + pts01[:, 1:2] * bmat[1] + pts01[:, 2:3] * bmat[2]
    return torch.cat(
        [_round(torch.sin(proj), dtype), _round(torch.cos(proj), dtype), _round(pts01, dtype)],
        dim=-1,
    )


def fourier_mlp_fwd_plain(ws, bs, bmat, pts01, dtype) -> torch.Tensor:
    """Plain version of the forward kernel: (N, 3) -> (N, 1) f32."""
    h = _features(pts01, bmat, dtype)
    for w, b in zip(ws[:-1], bs[:-1]):
        h = _round(torch.relu(h @ _round(w, dtype) + b), dtype)
    return h @ _round(ws[-1], dtype) + bs[-1]


def fourier_mlp_bwd_plain(ws, bs, bmat, pts01, dout, dtype):
    """Plain version of the backward kernel: returns (dws, dbs, dpts)."""
    f = bmat.shape[1]
    x = _features(pts01, bmat, dtype)
    wr = [_round(w, dtype) for w in ws]
    acts = []
    h = x
    for w, b in zip(wr[:-1], bs[:-1]):
        h = _round(torch.relu(h @ w + b), dtype)
        acts.append(h)
    n_layers = len(ws)
    dws: List[torch.Tensor] = [None] * n_layers
    dbs: List[torch.Tensor] = [None] * n_layers
    g = _round(dout, dtype)
    for i in range(n_layers - 1, 0, -1):
        h_prev = acts[i - 1]
        dws[i] = h_prev.T @ g
        dbs[i] = g.sum(dim=0)
        g = _round(torch.where(h_prev > 0, g @ wr[i].T, 0.0), dtype)
    dws[0] = x.T @ g
    dbs[0] = g.sum(dim=0)
    dx = g @ wr[0].T
    dproj = dx[:, :f] * x[:, f : 2 * f] - dx[:, f : 2 * f] * x[:, :f]
    dpts = dx[:, 2 * f :] + _round(dproj, dtype) @ _round(bmat.T, dtype)
    return dws, dbs, dpts


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernels, with their C signatures declared (pointers and the
    stream as void*, so ctypes does not cut them to 32 bits)."""
    from loner_tpu_torch.ops.build import load_library

    lib = load_library("fourier_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.lt_fourier_mlp_fwd.argtypes = [p, p, i, i, i, i, p, p, p, p, p, p]
    lib.lt_fourier_mlp_bwd.argtypes = [p, p, i, i, i, i, p, p, p, p, p, p, p, i, p, p]
    lib.lt_fourier_mlp_bwd_layout.argtypes = [i, i, i, ip, ip, ip]
    for fn in (lib.lt_fourier_mlp_fwd, lib.lt_fourier_mlp_bwd, lib.lt_fourier_mlp_bwd_layout):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def _bwd_layout(f: int, h: int, n_layers: int, device_index: int) -> Tuple[int, int, int]:
    stride, count, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(
            _lib().lt_fourier_mlp_bwd_layout(
                f, h, n_layers, ctypes.byref(stride), ctypes.byref(count), ctypes.byref(per_sm)
            ),
            "lt_fourier_mlp_bwd_layout",
        )
    if per_sm.value < 1:
        raise RuntimeError("the Fourier-MLP backward kernel does not fit on one SM")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return stride.value, count.value, per_sm.value * sms


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _cuda_args(ws, bs, bmat, pts01, dtype):
    """Validate the operands and pack the weights as the kernels take them."""
    if dtype != torch.bfloat16:
        raise ValueError("the CUDA Fourier-MLP kernels compute in bfloat16 only")
    dev = pts01.device
    n_layers = len(ws)
    f = bmat.shape[1]
    k0, h = ws[0].shape
    if pts01.dtype != torch.float32 or pts01.dim() != 2 or pts01.shape[1] != 3:
        raise ValueError(f"pts01 must be (N, 3) float32, got {tuple(pts01.shape)} {pts01.dtype}")
    if bmat.dtype != torch.float32 or bmat.shape[0] != 3 or bmat.device != dev:
        raise ValueError("bmat must be (3, F) float32 on the points' device")
    if k0 != 2 * f + 3:
        raise ValueError(f"w0 has {k0} rows; the kernel needs 2F + 3 = {2 * f + 3} (include_input)")
    if n_layers < 2 or h % 16 or not 16 <= h <= 256:
        raise ValueError(f"the kernel takes >= 2 layers of width 16..256 in steps of 16, got {h}")
    for i, w in enumerate(ws):
        want = (k0, h) if i == 0 else (h, 1) if i == n_layers - 1 else (h, h)
        if tuple(w.shape) != want or w.device != dev:
            raise ValueError(f"w{i} must be {want} on {dev}, got {tuple(w.shape)} on {w.device}")
    k0p = -(-k0 // 16) * 16
    w0p = torch.zeros((k0p, h), dtype=torch.bfloat16, device=dev)
    w0p[:k0] = ws[0]
    wh = (
        torch.stack([w.to(torch.bfloat16) for w in ws[1:-1]]).contiguous()
        if n_layers > 2
        else torch.empty((0,), dtype=torch.bfloat16, device=dev)
    )
    wl = ws[-1].reshape(h).to(torch.bfloat16).contiguous()
    bias = torch.cat([b.reshape(-1).to(torch.float32) for b in bs]).contiguous()
    return (pts01.contiguous(), bmat.contiguous(), w0p, wh, wl, bias, f, h, n_layers)


def fourier_mlp_fwd_cuda(ws, bs, bmat, pts01, dtype) -> torch.Tensor:
    pts, bm, w0p, wh, wl, bias, f, h, n_layers = _cuda_args(ws, bs, bmat, pts01, dtype)
    n = pts.shape[0]
    out = torch.empty((n, 1), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(
            _lib().lt_fourier_mlp_fwd(
                _ptr(pts), _ptr(bm), n, f, h, n_layers, _ptr(w0p), _ptr(wh), _ptr(wl),
                _ptr(bias), _ptr(out), ctypes.c_void_p(stream),
            ),
            "lt_fourier_mlp_fwd",
        )
    counts.fwd_launches += 1
    return out


def fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, dtype):
    pts, bm, w0p, wh, wl, bias, f, h, n_layers = _cuda_args(ws, bs, bmat, pts01, dtype)
    n = pts.shape[0]
    if dout.shape != (n, 1) or dout.device != pts.device:
        raise ValueError(f"dout must be ({n}, 1) on {pts.device}, got {tuple(dout.shape)}")
    dout = dout.to(torch.float32).contiguous()
    stride, count, max_blocks = _bwd_layout(f, h, n_layers, pts.device.index)
    nblocks = max(1, min(-(-n // TILE), max_blocks))
    partials = torch.empty((nblocks * stride,), dtype=torch.float32, device=pts.device)
    grads = torch.empty((count,), dtype=torch.float32, device=pts.device)
    dpts = torch.empty((n, 3), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(
            _lib().lt_fourier_mlp_bwd(
                _ptr(pts), _ptr(bm), n, f, h, n_layers, _ptr(w0p), _ptr(wh), _ptr(wl),
                _ptr(bias), _ptr(dout), _ptr(dpts), _ptr(partials), nblocks, _ptr(grads),
                ctypes.c_void_p(stream),
            ),
            "lt_fourier_mlp_bwd",
        )
    counts.bwd_launches += 1
    # Unpack [dW_0 (k0p x H) | dW_1..dW_{L-2} | dW_L (H) | db_0..db_{L-2} (H each), db_L].
    k0p = w0p.shape[0]
    dws, o = [grads[: k0p * h].view(k0p, h)[: 2 * f + 3]], k0p * h
    for _ in range(n_layers - 2):
        dws.append(grads[o : o + h * h].view(h, h))
        o += h * h
    dws.append(grads[o : o + h].view(h, 1))
    o += h
    dbs = [grads[o + i * h : o + (i + 1) * h] for i in range(n_layers - 1)]
    dbs.append(grads[o + (n_layers - 1) * h :].view(1))
    return dws, dbs, dpts


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _select(pts01: torch.Tensor, plain: bool):
    """The implementation for these points: the plain version on the CPU (or when
    ``plain`` asks for the reference), the CUDA kernels on a CUDA tensor."""
    if plain or pts01.device.type == "cpu":
        return fourier_mlp_fwd_plain, fourier_mlp_bwd_plain
    if pts01.device.type == "cuda":
        return fourier_mlp_fwd_cuda, fourier_mlp_bwd_cuda
    raise ValueError(f"no Fourier-MLP implementation for device {pts01.device}")


class FourierMLPFunction(torch.autograd.Function):
    """Custom-VJP pair: residuals are only the parameters, B and pts01; the
    backward recomputes the forward. Returns no gradient for B."""

    @staticmethod
    def forward(ctx, pts01, bmat, dtype, plain, n_layers, *params):
        ws, bs = list(params[:n_layers]), list(params[n_layers:])
        fwd, _ = _select(pts01, plain)
        ctx.save_for_backward(pts01, bmat, *params)
        ctx.meta = (dtype, plain, n_layers)
        return fwd(ws, bs, bmat, pts01, dtype)

    @staticmethod
    def backward(ctx, dout):
        dtype, plain, n_layers = ctx.meta
        pts01, bmat, *params = ctx.saved_tensors
        ws, bs = params[:n_layers], params[n_layers:]
        _, bwd = _select(pts01, plain)
        dws, dbs, dpts = bwd(ws, bs, bmat, pts01, dout.contiguous(), dtype)
        dbs = [db.reshape(b.shape) for db, b in zip(dbs, bs)]
        return (dpts, None, None, None, None, *dws, *dbs)


def fourier_sigma_fused(
    mlp_params: Dict[str, torch.Tensor],
    pts01: torch.Tensor,
    bmat: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
) -> torch.Tensor:
    """Fourier sigma query for the [sin, cos, pts] feature order with
    include_input. pts01: (N, 3) in [0, 1] -> raw sigma (N, 1) f32.

    Missing biases count as zeros and get no gradient."""
    n_layers = sum(1 for k in mlp_params if k.startswith("w"))
    ws = [mlp_params[f"w{i}"] for i in range(n_layers)]
    bs: List[Optional[torch.Tensor]] = []
    for i, w in enumerate(ws):
        b = mlp_params.get(f"b{i}")
        bs.append(torch.zeros(w.shape[1], dtype=torch.float32, device=w.device) if b is None else b)
    return FourierMLPFunction.apply(pts01, bmat, compute_dtype, plain, n_layers, *ws, *bs)
