"""Fused Fourier-feature + MLP sigma head, forward and backward.

PyTorch counterpart of ``loner_tpu/ops/pallas/fourier_mlp.py``. On a CUDA tensor
the forward and the backward are the hand-written Hopper kernels of
``csrc/fourier_mlp.cu`` (bf16, wgmma) and, for a head that computes in float32,
of ``csrc/fourier_mlp_f32.cu`` (the Pallas kernel's f32 mode: split-TF32
``mma.sync`` products, as accurate as f32 ones); on a CPU tensor they are the
plain PyTorch version below, which computes the same function with bf16 rounding
at the same places:

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


class LaunchCounts:
    """Kernel launches made by the wrappers of this module: the bf16 pair's and
    the f32 pair's."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0
        self.fwd_f32_launches = 0
        self.bwd_f32_launches = 0


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
# CUDA kernels: shapes, the packed weight image and the backward's workspace
# ---------------------------------------------------------------------------

WIDTHS = (32, 64, 128, 192, 256)  # hidden widths the kernels are built for
MAX_LAYERS = 8  # linear layers, the last (H -> 1) included
CHUNK_ROWS = 64  # packed input rows per weight chunk
MAX_CHUNKS = 40  # chunks of layers 0 .. L-2, and 128-row weight-gradient tiles
MAX_TILE_PAIRS = 2 ** 31 - 1  # the kernels count a CTA's 128-point tile pairs in 32 bits


def padded_freqs(f: int) -> int:
    """Frequencies padded to a multiple of 16 (zero columns of B, zero rows of W_0)."""
    return -(-f // 16) * 16


def layer0_rows(f: int) -> torch.Tensor:
    """Row of W_0 ([sin | cos | pts] order) held by each packed layer-0 row, -1 for a
    row of zeros. The kernels take the features as [16 sin | 16 cos] per 16
    frequencies, then [pts | 13 zeros]: 2 Fp + 16 rows."""
    idx: List[int] = []
    for s in range(0, padded_freqs(f), 16):
        idx += [j if j < f else -1 for j in range(s, s + 16)]
        idx += [f + j if j < f else -1 for j in range(s, s + 16)]
    idx += [2 * f, 2 * f + 1, 2 * f + 2] + [-1] * 13
    return torch.tensor(idx, dtype=torch.long)


def _chunk_rows(rows: int) -> List[Tuple[int, int]]:
    return [(r, min(CHUNK_ROWS, rows - r)) for r in range(0, rows, CHUNK_ROWS)]


def pack_weights(ws, f: int) -> torch.Tensor:
    """The kernels' image of W_0 .. W_{L-2}, bf16, flat: each layer (W_0's rows in
    ``layer0_rows`` order) in chunks of 64 input rows; a chunk of R rows x H outputs
    as 8 x 8 core matrices, core (o // 8, i // 8) at ((o // 8) * R / 8 + i // 8) * 64,
    element (o % 8) * 8 + i % 8 (``csrc/fourier_mlp.cu::Plan``)."""
    h, dev = ws[0].shape[1], ws[0].device
    flat = torch.cat([w.reshape(-1) for w in ws[:-1]] + [ws[0].new_zeros(1)]).to(torch.bfloat16)
    return flat[_pack_index(f, h, len(ws), dev)]


@functools.lru_cache(maxsize=None)
def _pack_index(f: int, h: int, n_layers: int, device: torch.device) -> torch.Tensor:
    """For each element of the image, its position in W_0 .. W_{L-2} flattened and
    concatenated, or the position after them (a zero) for W_0's padding rows: one
    gather packs a call's weights."""
    idx = layer0_rows(f)
    sizes = [(2 * f + 3) * h] + [h * h] * (n_layers - 2)
    w0 = torch.arange(sizes[0]).reshape(2 * f + 3, h)
    w0 = torch.where(idx[:, None] >= 0, w0[idx.clamp_min(0)], sum(sizes))
    mats = [w0] + [torch.arange(h * h).reshape(h, h) + sum(sizes[: i + 1]) for i in range(n_layers - 2)]
    parts = []
    for m in mats:
        for r0, rows in _chunk_rows(m.shape[0]):
            c = m[r0 : r0 + rows]
            parts.append(c.reshape(rows // 8, 8, h // 8, 8).permute(2, 0, 3, 1).reshape(-1))
    return torch.cat(parts).to(device)


def unpack_weights(img: torch.Tensor, f: int, h: int, n_layers: int) -> List[torch.Tensor]:
    """Inverse of ``pack_weights``: W_0 (2F + 3, H), W_1 .. W_{L-2} (H, H)."""
    idx = layer0_rows(f).to(img.device)
    mats, o = [], 0
    for rows in [len(idx)] + [h] * (n_layers - 2):
        blocks = []
        for _, r in _chunk_rows(rows):
            c = img[o : o + r * h].reshape(h // 8, r // 8, 8, 8).permute(1, 3, 0, 2)
            blocks.append(c.reshape(r, h))
            o += r * h
        mats.append(torch.cat(blocks))
    keep = idx >= 0
    w0 = mats[0].new_empty((2 * f + 3, h))
    w0[idx[keep]] = mats[0][keep]
    return [w0] + mats[1:]


def core_layout(mat: torch.Tensor) -> torch.Tensor:
    """An (N, C) matrix (N a multiple of 64, C of 8) in the workspace's core-matrix
    order, flat: 64-point block, 8-column group, 8-point group, then the 8 x 8 core."""
    n, c = mat.shape
    return mat.reshape(n // 64, 8, 8, c // 8, 8).permute(0, 3, 1, 2, 4).reshape(-1)


def from_core_layout(flat: torch.Tensor, n: int, c: int) -> torch.Tensor:
    return flat.reshape(n // 64, c // 8, 8, 8, 8).permute(0, 2, 3, 1, 4).reshape(n, c)


def check_shape(f: int, h: int, n_layers: int) -> None:
    """Raise ValueError, before any launch, for a shape the kernels do not take."""
    if h not in WIDTHS:
        raise ValueError(f"the CUDA Fourier-MLP kernels take hidden widths {WIDTHS}, got {h}")
    if not 2 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the CUDA Fourier-MLP kernels take 2..{MAX_LAYERS} layers, got {n_layers}")
    k0 = 2 * padded_freqs(f) + 16
    chunks = len(_chunk_rows(k0)) + (n_layers - 2) * len(_chunk_rows(h))
    tiles = -(-k0 // 128) + (n_layers - 2) * -(-h // 128)
    if f < 1 or chunks > MAX_CHUNKS or tiles > MAX_CHUNKS:
        raise ValueError(f"the CUDA Fourier-MLP kernels take at most {MAX_CHUNKS} weight chunks "
                         f"and gradient tiles; F = {f}, {n_layers} layers of {h} need {chunks}, {tiles}")


def check_point_count(n: int) -> None:
    """The kernels index points, the workspace and the partials in 64 bits; a CTA
    counts its 128-point tile pairs in 32 bits (``csrc/fourier_mlp.cu::tile_pairs``)."""
    if -(-n // 128) > MAX_TILE_PAIRS:
        raise ValueError(
            f"{n} points: the Fourier-MLP kernels take at most {128 * MAX_TILE_PAIRS} per "
            "call (32-bit tile-pair counts); split the call"
        )


class BackwardPlan:
    """Sizes of the backward's buffers and its fixed order of summation.

    ``features_kernel`` writes x (K0 columns; column 2 Fp + 3 is ones) to ``work``
    (bf16, ``np`` points in core-matrix order); ``bwd_tile_kernel`` runs ``grid`` CTAs
    over the 128-point tile pairs (CTA b takes pairs b, b + grid, ...), adds h_0 ..
    h_{L-3} and G_0 .. G_{L-2} (H columns each) to it, and writes one f32 partial of
    [db_0 .. db_{L-2} | dW_L | db_L] (``count_b`` values, rows ``stride_b`` apart; the
    db_0 slot stays 0: db_0 is dW_0's row for x's column of ones) per CTA.
    ``dw_kernel`` runs (split, tile) CTAs: ``tiles`` lists the (layer, m) of each
    128-row tile of dW_0 .. dW_{L-2}, and split s sums the 64-point blocks
    ``split_blocks(s)`` in order into one f32 partial (``tiles`` x 128 x H).
    ``reduce_kernel`` adds the partials in split, then CTA, order. No step depends on
    timing, so every call sums in the same order."""

    def __init__(self, n: int, f: int, h: int, n_layers: int, sms: int) -> None:
        self.k0 = 2 * padded_freqs(f) + 16
        pairs = max(1, -(-n // 128))
        self.np = 128 * pairs
        self.grid = max(1, min(sms, pairs))
        self.work_elems = (self.k0 + (n_layers - 2) * h + (n_layers - 1) * h) * self.np
        self.tiles = [(0, m) for m in range(-(-self.k0 // 128))] + [
            (layer, m) for layer in range(1, n_layers - 1) for m in range(-(-h // 128))
        ]
        self.splits = max(1, min(sms // len(self.tiles), self.np // 64))
        self.count_b = n_layers * h + 1
        self.stride_b = -(-self.count_b // 64) * 64
        self.count_w = len(self.tiles) * 128 * h

    def split_blocks(self, s: int) -> Tuple[int, int]:
        nb = self.np // 64
        return s * nb // self.splits, (s + 1) * nb // self.splits


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernels, with their C signatures declared (pointers and the
    stream as void*, so ctypes does not cut them to 32 bits)."""
    from loner_tpu_torch.ops.build import load_library

    lib = load_library("fourier_mlp")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lt_fourier_mlp_fwd.argtypes = [p, p, ll, i, i, i, p, p, p, p, i, p]
    lib.lt_fourier_mlp_bwd.argtypes = [p, p, ll, i, i, i, p, p, p, p, p, p, p, i, p, i, p, p, p]
    lib.lt_wgmma_selftest.argtypes = [p] * 8
    for fn in (lib.lt_fourier_mlp_fwd, lib.lt_fourier_mlp_bwd, lib.lt_wgmma_selftest):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cuda_args(ws, bs, bmat, pts01, dtype):
    """Validate the operands and pack them as the kernels take them."""
    if dtype != torch.bfloat16:
        raise ValueError("the CUDA Fourier-MLP kernels compute in bfloat16 only")
    dev = pts01.device
    n_layers = len(ws)
    f = bmat.shape[1]
    k0, h = ws[0].shape
    if pts01.dtype != torch.float32 or pts01.dim() != 2 or pts01.shape[1] != 3:
        raise ValueError(f"pts01 must be (N, 3) float32, got {tuple(pts01.shape)} {pts01.dtype}")
    check_point_count(pts01.shape[0])
    if bmat.dtype != torch.float32 or bmat.shape[0] != 3 or bmat.device != dev:
        raise ValueError("bmat must be (3, F) float32 on the points' device")
    if k0 != 2 * f + 3:
        raise ValueError(f"w0 has {k0} rows; the kernel needs 2F + 3 = {2 * f + 3} (include_input)")
    check_shape(f, h, n_layers)
    for i, w in enumerate(ws):
        want = (k0, h) if i == 0 else (h, 1) if i == n_layers - 1 else (h, h)
        if tuple(w.shape) != want or w.device != dev:
            raise ValueError(f"w{i} must be {want} on {dev}, got {tuple(w.shape)} on {w.device}")
    bpad = torch.nn.functional.pad(bmat, (0, padded_freqs(f) - f))
    wl = ws[-1].reshape(h).to(torch.bfloat16).contiguous()
    bias = torch.cat([b.reshape(-1).to(torch.float32) for b in bs]).contiguous()
    return pts01.contiguous(), bpad, pack_weights(ws, f), wl, bias, f, h, n_layers


def fourier_mlp_fwd_cuda(ws, bs, bmat, pts01, dtype) -> torch.Tensor:
    pts, bpad, wimg, wl, bias, f, h, n_layers = _cuda_args(ws, bs, bmat, pts01, dtype)
    n = pts.shape[0]
    out = torch.empty((n, 1), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    grid = max(1, min(_sms(pts.device), -(-n // 128)))
    with torch.cuda.device(pts.device):
        _check(
            _lib().lt_fourier_mlp_fwd(
                _ptr(pts), _ptr(bpad), n, f, h, n_layers, _ptr(wimg), _ptr(wl), _ptr(bias),
                _ptr(out), grid, _stream(pts.device),
            ),
            "lt_fourier_mlp_fwd",
        )
    counts.fwd_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _layer0_positions(f: int, device: torch.device) -> torch.Tensor:
    """Packed row of each W_0 row, on the device."""
    idx = layer0_rows(f)
    keep = torch.nonzero(idx >= 0).reshape(-1)
    pos = torch.empty(2 * f + 3, dtype=torch.long)
    pos[idx[keep]] = keep
    return pos.to(device)


def fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, dtype):
    pts, bpad, wimg, wl, bias, f, h, n_layers = _cuda_args(ws, bs, bmat, pts01, dtype)
    n, dev = pts.shape[0], pts.device
    if dout.shape != (n, 1) or dout.device != dev:
        raise ValueError(f"dout must be ({n}, 1) on {dev}, got {tuple(dout.shape)}")
    if n == 0:
        return ([torch.zeros_like(w, dtype=torch.float32) for w in ws],
                [torch.zeros(b.numel(), dtype=torch.float32, device=dev) for b in bs],
                torch.zeros((0, 3), dtype=torch.float32, device=dev))
    dout = dout.to(torch.float32).contiguous()
    plan = BackwardPlan(n, f, h, n_layers, _sms(dev))
    work = torch.empty((plan.work_elems,), dtype=torch.bfloat16, device=dev)
    sizes = [plan.grid * plan.stride_b, plan.splits * plan.count_w, plan.count_w, plan.count_b,
             3 * n]
    part_b, part_w, grads_w, grads_b, dpts = torch.empty(
        (sum(sizes),), dtype=torch.float32, device=dev).split(sizes)
    grads_w, dpts = grads_w.view(len(plan.tiles), 128, h), dpts.view(n, 3)
    with torch.cuda.device(dev):
        _check(
            _lib().lt_fourier_mlp_bwd(
                _ptr(pts), _ptr(bpad), n, f, h, n_layers, _ptr(wimg), _ptr(wl), _ptr(bias),
                _ptr(dout), _ptr(dpts), _ptr(work), _ptr(part_b), plan.grid, _ptr(part_w),
                plan.splits, _ptr(grads_w), _ptr(grads_b), _stream(dev),
            ),
            "lt_fourier_mlp_bwd",
        )
    counts.bwd_launches += 1
    # grads_w: the 128-row tiles of dW_0 (packed rows) .. dW_{L-2}, in layer order.
    per = [-(-plan.k0 // 128)] + [-(-h // 128)] * (n_layers - 2)
    dws, t = [], 0
    for layer, k in enumerate(per):
        rows = plan.k0 if layer == 0 else h
        dws.append(grads_w[t : t + k].reshape(k * 128, h)[:rows])
        t += k
    # x's column 2 Fp + 3 is all ones, so dW_0's packed row for it is db_0.
    db0 = dws[0][2 * padded_freqs(f) + 3]
    dws[0] = dws[0][_layer0_positions(f, dev)]
    dws.append(grads_b[(n_layers - 1) * h : n_layers * h].view(h, 1))
    dbs = [db0] + [grads_b[i * h : (i + 1) * h] for i in range(1, n_layers - 1)]
    dbs.append(grads_b[n_layers * h :].view(1))
    return dws, dbs, dpts


# ---------------------------------------------------------------------------
# The f32 kernels (csrc/fourier_mlp_f32.cu)
# ---------------------------------------------------------------------------

def _bind_f32(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures of a build of ``csrc/fourier_mlp_f32.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lt_fourier_mlp_f32_fwd.argtypes = [p, p, ll, i, i, i, p, p, i, p]
    lib.lt_fourier_mlp_f32_bwd.argtypes = [p, p, ll, i, i, i, p, p, p, p, i, p, p]
    for fn in (lib.lt_fourier_mlp_f32_tile, lib.lt_fourier_mlp_f32_occupancy):
        fn.argtypes = [i, i, i, i]
    lib.lt_mma_tf32_selftest.argtypes = [p] * 8
    for fn in (lib.lt_fourier_mlp_f32_fwd, lib.lt_fourier_mlp_f32_bwd, lib.lt_fourier_mlp_f32_tile,
               lib.lt_fourier_mlp_f32_occupancy, lib.lt_mma_tf32_selftest):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib_f32() -> ctypes.CDLL:
    from loner_tpu_torch.ops.build import load_library

    return _bind_f32(load_library("fourier_mlp_f32"))


@functools.lru_cache(maxsize=None)
def f32_tiles(f: int, h: int, n_layers: int) -> Tuple[int, int]:
    """Points a block of the f32 forward and of the backward takes per round of
    its loop (``csrc/fourier_mlp_f32.cu::lt_fourier_mlp_f32_tile``: the resident
    build of the head's padded shape, else the streamed kernels); raises
    ValueError, before any launch, for a head whose layout fits neither."""
    lib = _lib_f32()
    tiles = (lib.lt_fourier_mlp_f32_tile(f, h, n_layers, 0),
             lib.lt_fourier_mlp_f32_tile(f, h, n_layers, 1))
    if min(tiles) < 1:
        raise ValueError(f"the f32 Fourier-MLP kernels take 2..8 layers whose tile fits a "
                         f"block's shared memory; F = {f}, {n_layers} layers of {h} does not")
    return tiles


@functools.lru_cache(maxsize=None)
def f32_occupancy(f: int, h: int, n_layers: int, backward: bool, device: torch.device) -> int:
    """Resident blocks an SM of the f32 forward or backward kernel for this head
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    f32_tiles(f, h, n_layers)
    with torch.cuda.device(device):
        blocks = _lib_f32().lt_fourier_mlp_f32_occupancy(f, h, n_layers, int(backward))
    if blocks < 1:
        raise RuntimeError(f"the f32 Fourier-MLP kernel fits no block on an SM ({blocks})")
    return blocks


def _f32_args(ws, bs, bmat, pts01):
    dev = pts01.device
    n_layers, f = len(ws), bmat.shape[1]
    k0, h = ws[0].shape
    if pts01.dtype != torch.float32 or pts01.dim() != 2 or pts01.shape[1] != 3:
        raise ValueError(f"pts01 must be (N, 3) float32, got {tuple(pts01.shape)} {pts01.dtype}")
    if bmat.dtype != torch.float32 or bmat.shape[0] != 3 or bmat.device != dev:
        raise ValueError("bmat must be (3, F) float32 on the points' device")
    if k0 != 2 * f + 3:
        raise ValueError(f"w0 has {k0} rows; the kernel needs 2F + 3 = {2 * f + 3} (include_input)")
    if n_layers < 2:
        raise ValueError(f"the f32 kernels take a hidden layer and an output layer, got {n_layers}")
    for i, w in enumerate(ws):
        want = (k0, h) if i == 0 else (h, 1) if i == n_layers - 1 else (h, h)
        if tuple(w.shape) != want or w.device != dev:
            raise ValueError(f"w{i} must be {want} on {dev}, got {tuple(w.shape)} on {w.device}")
    params = torch.cat([t for w, b in zip(ws, bs)
                        for t in (w.reshape(-1).float(), b.reshape(-1).float())]).contiguous()
    return pts01.contiguous(), bmat.contiguous(), params, f, h, n_layers


def fourier_mlp_fwd_cuda_f32(ws, bs, bmat, pts01) -> torch.Tensor:
    """The f32 forward kernel: (N, 3) -> (N, 1) f32. A persistent grid of
    resident blocks an SM times SMs, over tiles of ``f32_tiles``' points."""
    pts, bm, params, f, h, n_layers = _f32_args(ws, bs, bmat, pts01)
    n, dev = pts.shape[0], pts.device
    tile = f32_tiles(f, h, n_layers)[0]
    out = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    grid = min(f32_occupancy(f, h, n_layers, False, dev) * _sms(dev), -(-n // tile))
    with torch.cuda.device(dev):
        _check(_lib_f32().lt_fourier_mlp_f32_fwd(
            _ptr(pts), _ptr(bm), n, f, h, n_layers, _ptr(params), _ptr(out), grid,
            _stream(dev)), "lt_fourier_mlp_f32_fwd")
    counts.fwd_f32_launches += 1
    return out


def fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts01, dout, grid: Optional[int] = None):
    """The f32 backward kernels: a persistent pass of ``grid`` blocks (default
    min(SMs, tiles); only tests set it) that each write one partial of their
    tiles' dW and db, then the partials' sum in block order. Returns (dws, dbs,
    dpts)."""
    pts, bm, params, f, h, n_layers = _f32_args(ws, bs, bmat, pts01)
    n, dev = pts.shape[0], pts.device
    if dout.shape != (n, 1) or dout.device != dev:
        raise ValueError(f"dout must be ({n}, 1) on {dev}, got {tuple(dout.shape)}")
    tile = f32_tiles(f, h, n_layers)[1]
    if n == 0:
        return ([torch.zeros_like(w, dtype=torch.float32) for w in ws],
                [torch.zeros(b.numel(), dtype=torch.float32, device=dev) for b in bs],
                torch.zeros((0, 3), dtype=torch.float32, device=dev))
    tiles = -(-n // tile)
    if grid is None:
        grid = min(_sms(dev), tiles)
    if not 1 <= grid <= tiles:
        raise ValueError(f"grid must be 1..{tiles} blocks for {n} points, got {grid}")
    partial = torch.empty((grid, params.numel()), dtype=torch.float32, device=dev)
    grads = torch.empty((params.numel(),), dtype=torch.float32, device=dev)
    dpts = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _check(_lib_f32().lt_fourier_mlp_f32_bwd(
            _ptr(pts), _ptr(bm), n, f, h, n_layers, _ptr(params),
            _ptr(dout.to(torch.float32).contiguous()), _ptr(dpts), _ptr(partial), grid,
            _ptr(grads), _stream(dev)), "lt_fourier_mlp_f32_bwd")
    counts.bwd_f32_launches += 1
    dws, dbs, at = [], [], 0
    for w, b in zip(ws, bs):
        dws.append(grads[at : at + w.numel()].view(w.shape))
        at += w.numel()
        dbs.append(grads[at : at + b.numel()])
        at += b.numel()
    return dws, dbs, dpts


def mma_tf32_selftest(a: torch.Tensor, w: torch.Tensor, g: torch.Tensor, h: torch.Tensor):
    """One split-TF32 m16n8k8 product in each operand form of the f32 kernels, on
    the card, through their fragment loads and weight image
    (``csrc/fourier_mlp_f32.cu::selftest_kernel``): (A W, A W^T, G^T H) for A
    (16, 8), W (8, 8), G (8, 16), H (8, 8), f32."""
    dev = a.device
    args = [t.to(torch.float32).contiguous() for t in (a, w, g, h)]
    outs = [torch.empty((16, 8), dtype=torch.float32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        _check(_lib_f32().lt_mma_tf32_selftest(*[_ptr(t) for t in args + outs], _stream(dev)),
               "lt_mma_tf32_selftest")
    return outs


def wgmma_selftest(w: torch.Tensor, a: torch.Tensor, x: torch.Tensor, g: torch.Tensor):
    """The kernels' three operand forms on 64 x 64 bf16 matrices on the card:
    (A W, A W^T, X^T G), each through ``csrc/fourier_mlp.cu::selftest_kernel``."""
    dev = a.device
    # One 64-row chunk of W, as pack_weights packs a hidden layer.
    wimg = w.to(torch.bfloat16).reshape(8, 8, 8, 8).permute(2, 0, 3, 1).reshape(-1).contiguous()
    outs = [torch.empty((64, 64), dtype=torch.float32, device=dev) for _ in range(3)]
    args = [wimg, a.to(torch.bfloat16).contiguous(), core_layout(x.to(torch.bfloat16)).contiguous(),
            core_layout(g.to(torch.bfloat16)).contiguous()]
    with torch.cuda.device(dev):
        _check(_lib().lt_wgmma_selftest(*[_ptr(t) for t in args + outs], _stream(dev)),
               "lt_wgmma_selftest")
    return outs


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _select(pts01: torch.Tensor, plain: bool):
    """The implementation for these points: the plain version on the CPU (or when
    ``plain`` asks for the reference), the CUDA kernels on a CUDA tensor."""
    if plain or pts01.device.type == "cpu":
        return fourier_mlp_fwd_plain, fourier_mlp_bwd_plain
    if pts01.device.type == "cuda":
        return fourier_mlp_fwd_cuda_any, fourier_mlp_bwd_cuda_any
    raise ValueError(f"no Fourier-MLP implementation for device {pts01.device}")


def fourier_mlp_fwd_cuda_any(ws, bs, bmat, pts01, dtype) -> torch.Tensor:
    """The CUDA forward of ``dtype``: the bf16 kernel, or the f32 one."""
    if dtype == torch.float32:
        return fourier_mlp_fwd_cuda_f32(ws, bs, bmat, pts01)
    return fourier_mlp_fwd_cuda(ws, bs, bmat, pts01, dtype)


def fourier_mlp_bwd_cuda_any(ws, bs, bmat, pts01, dout, dtype):
    """The CUDA backward of ``dtype``: the bf16 kernels, or the f32 ones."""
    if dtype == torch.float32:
        return fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts01, dout)
    return fourier_mlp_bwd_cuda(ws, bs, bmat, pts01, dout, dtype)


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
