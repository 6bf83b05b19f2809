"""Multiresolution hash-grid encode, forward and backward.

PyTorch counterpart of the JAX package's ``hash_encode`` and ``hash_encode_vjp``
(``loner_tpu/models/hash_encoding.py``), which XLA computes there; it is not a
TPU kernel. On a CUDA tensor the forward and the backward are the hand-written
Hopper kernels of ``csrc/hash_grid.cu``; on a CPU tensor they are the plain
PyTorch version below, which computes the same function with the same rounding
at the same places:

  forward   out[:, l] = sum_k w_k table[idx_k]                      (f32)
            out[:, l] = bf16(sum_k bf16(bf16(table[idx_k]) bf16(w_k)))  (bf16, f32 sum)
  backward  dtable[idx_k] += w_k g_l in fixed point (``ops/fixed_point.py``: each
            f32 product w_k g_l rounded to int64 at 2^HASH_BITS, summed in int64 by
            ``index_add_``, converted to f32 once); dpos by the closed form
            through the trilinear weights, with half weight at an exact 0 or 1.

Sums run in a fixed order (the 8 corners, the 2 x 2 terms of a frac gradient,
the levels), the kernel's order, so the plain version is the kernel's reference
to the bit on the forward and dpos; the table gradient's integer sums have no
order, so it is the kernel's to the bit too, and the same under any permutation
of the points and when the points are split into parts whose int64 sums are
added (a mesh rank's share). Torch has no full uint32 arithmetic: the
hash is taken in int64, and only its low ``log2_hashmap_size`` bits survive the
mask, so the uint32 wrap of the prime products does not matter.

The backward's dpos half is optional (``need_dpos``): points that need no
gradient, as with frozen poses, skip it in both versions, and on the card the
kernel then neither re-gathers the corners nor forms their dot products.

On the card neither kernel is bound by HBM bytes or operations: the 29.7 MB
table of the reference's grid stays in L2, and what counts is L2 gathers and,
in the backward, int64 atomics that serialise where many lanes add to one entry,
as the sorted samples of a ray do on the coarse levels. The kernels take blocks
of consecutive points x all levels, a warp = 32 points of one level; the
backward sums its atomics' integer terms over each run of lanes that share
entries, adds in lane pairs (one entry's two features an instruction) and is
launched in groups of levels whose int64 sums fit the L2 (``BWD_GROUP_BYTES``;
``csrc/hash_grid.cu`` has the design and the levers tried; PERF.md the times).

``sink``: a caller that sums the table gradient of several calls, or of several
mesh ranks, before converting it (``mapping/phase_graph.py``) passes a
``FixedPointSum`` to ``hash_encode``; the backward then adds into its int64 sums
and gives the table no f32 gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from loner_tpu_torch.ops.fixed_point import HASH_BITS, FixedPointSum

PRIMES = (1, 2654435761, 805459861)
MAX_LEVELS = 32  # csrc/hash_grid.cu::kMaxLevels
INDEX_LIMIT = 2 ** 31  # points x levels x 8 corners, and table entries x features
# The backward launches its levels in groups whose slice of the int64 sums is at most
# this many bytes (whole pairs of levels; a level larger than the budget alone), so
# that a group's atomics stay in the card's L2 (PERF.md section 6 has the sweep).
BWD_GROUP_BYTES = 24 << 20


class LaunchCounts:
    """Kernel launches made by the wrappers of this module. ``bwd_launches``
    counts every backward launch, one a level group (``level_groups``), so a
    call at the reference's grid makes several; ``bwd_no_dpos_launches`` those of
    them that skipped the position gradient."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0
        self.bwd_no_dpos_launches = 0


counts = LaunchCounts()


def corner_geometry(pos01: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell (N, L, 3) int64 and frac (N, L, 3) f32 of every level. pos01 is
    clipped to [0, 1]; the cell is clamped to res - 1, so frac is exactly 1 at
    pos = 1."""
    res = torch.as_tensor(cfg.level_resolutions(), dtype=torch.float32, device=pos01.device)
    scaled = pos01.clamp(0.0, 1.0)[:, None, :] * res[None, :, None]
    cell = torch.minimum(torch.floor(scaled), (res - 1.0)[None, :, None])
    return cell.long(), scaled - cell


def _axis_weights(frac: torch.Tensor):
    """Per-axis (1 - f, f) pairs, each (N, L, 2)."""
    return [torch.stack([1.0 - frac[..., a], frac[..., a]], dim=-1) for a in range(3)]


def corner_indices(pos01: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices (N, L, 8) int64 into the concatenated table and trilinear weights
    (N, L, 8) f32; corner ``4 ix + 2 iy + iz``."""
    n, dev = pos01.shape[0], pos01.device
    res = torch.as_tensor(cfg.level_resolutions(), device=dev)
    offsets = torch.as_tensor(cfg.level_offsets()[:-1], device=dev)
    dense = torch.as_tensor(cfg.level_dense(), device=dev)
    cell, frac = corner_geometry(pos01, cfg)
    wx, wy, wz = _axis_weights(frac)
    w = (wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]).reshape(
        n, cfg.n_levels, 8)
    corner = [torch.stack([cell[..., a], cell[..., a] + 1], dim=-1) for a in range(3)]  # (N, L, 2)
    r1 = (res + 1)[None, :, None]
    dense_idx = (corner[0][..., :, None, None] + (corner[1] * r1)[..., None, :, None]
                 + (corner[2] * r1 * r1)[..., None, None, :])
    hashed = [corner[a] * PRIMES[a] for a in range(3)]
    hash_idx = (hashed[0][..., :, None, None] ^ hashed[1][..., None, :, None]
                ^ hashed[2][..., None, None, :]) & (2 ** cfg.log2_hashmap_size - 1)
    idx = torch.where(dense[None, :, None, None, None], dense_idx, hash_idx)
    return idx.reshape(n, cfg.n_levels, 8) + offsets[None, :, None], w


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).to(torch.float32)


def _corner_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the corner axis (2) in corner order, as the kernel adds."""
    acc = x[:, :, 0]
    for k in range(1, 8):
        acc = acc + x[:, :, k]
    return acc


def hash_encode_fwd_plain(table: torch.Tensor, pos01: torch.Tensor, cfg,
                          dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the forward kernel: (N, 3) -> (N, L F) f32."""
    n = pos01.shape[0]
    idx, w = corner_indices(pos01, cfg)
    feats = table[idx]  # (N, L, 8, F)
    if dtype == torch.bfloat16:
        # bf16 x bf16 is exact in f32; the product is rounded to bf16 as JAX's bf16
        # multiply rounds it, the 8 products summed in f32 and the sum rounded.
        out = _round(_corner_sum(_round(_round(feats, dtype) * _round(w, dtype)[..., None],
                                        dtype)), dtype)
    else:
        out = _corner_sum(feats * w[..., None])
    return out.reshape(n, cfg.output_dim)


def table_sum(table: torch.Tensor) -> FixedPointSum:
    """A zeroed fixed-point sum for ``table``'s gradient."""
    return FixedPointSum(table.shape, HASH_BITS, table.device)


def hash_encode_bwd_plain(table: torch.Tensor, pos01: torch.Tensor, dout: torch.Tensor, cfg,
                          dtype: torch.dtype, need_dpos: bool = True,
                          sink: Optional[FixedPointSum] = None
                          ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of the backward kernel: (dtable (T, F) f32, dpos (N, 3) f32),
    dpos None when ``need_dpos`` is False (then its half is not computed). With
    ``sink`` the table gradient is added to its int64 sums and dtable is None."""
    n, n_levels, f_dim = pos01.shape[0], cfg.n_levels, cfg.n_features_per_level
    idx, w = corner_indices(pos01, cfg)
    g = dout.reshape(n, n_levels, 1, f_dim).to(torch.float32)
    acc = table_sum(table) if sink is None else sink
    acc.add_(idx.reshape(-1), (w[..., None] * g).reshape(-1, f_dim))
    dtable = acc.to_float() if sink is None else None
    if not need_dpos:
        return dtable, None

    feats = table[idx]
    if dtype == torch.bfloat16:
        feats = _round(feats, dtype)
    s = feats[..., 0] * g[..., 0]
    for j in range(1, f_dim):
        s = s + feats[..., j] * g[..., j]
    s = s.reshape(n, n_levels, 2, 2, 2)  # [ix, iy, iz]
    _, frac = corner_geometry(pos01, cfg)
    wx, wy, wz = _axis_weights(frac)
    terms = (
        (lambda a, b: s[:, :, 1, a, b] - s[:, :, 0, a, b], wy, wz),
        (lambda a, b: s[:, :, a, 1, b] - s[:, :, a, 0, b], wx, wz),
        (lambda a, b: s[:, :, a, b, 1] - s[:, :, a, b, 0], wx, wy),
    )
    dfrac = []
    for diff, wu, wv in terms:
        acc = None
        for a in range(2):
            for b in range(2):
                t = diff(a, b) * (wu[..., a] * wv[..., b])
                acc = t if acc is None else acc + t
        dfrac.append(acc)
    res = torch.as_tensor(cfg.level_resolutions(), dtype=torch.float32, device=pos01.device)
    dfrac = torch.stack(dfrac, dim=-1) * res[None, :, None]  # (N, L, 3)
    dpos = dfrac[:, 0]
    for lvl in range(1, n_levels):
        dpos = dpos + dfrac[:, lvl]
    clip_w = ((pos01 > 0.0) & (pos01 < 1.0)).to(torch.float32) + 0.5 * (
        (pos01 == 0.0) | (pos01 == 1.0)).to(torch.float32)
    return dtable, dpos * clip_w


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built kernels."""
    from loner_tpu_torch.ops.build import load_library

    return bind(load_library("hash_grid"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/hash_grid.cu) with its C signatures declared
    (pointers and the stream as void*, so ctypes does not cut them to 32 bits)."""
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    up = ctypes.POINTER(ctypes.c_uint)
    lib.lt_hash_fwd.argtypes = [p, p, ll, i, u, up, up, up, i, p, p]
    lib.lt_hash_fwd.restype = ctypes.c_int
    lib.lt_hash_bwd.argtypes = [p, p, p, ll, i, u, up, up, up, i, i, i, i, i, ctypes.c_float,
                                p, p, p, p]
    lib.lt_hash_bwd.restype = ctypes.c_int
    return lib


def check_sizes(n: int, cfg) -> None:
    """Raise ValueError, before any launch, on what the kernels do not take:
    more than 32 levels, other than 2 features per level, and index spaces past
    32 bits (points x levels x 8 corners, table entries x features)."""
    if not 1 <= cfg.n_levels <= MAX_LEVELS:
        raise ValueError(f"the hash kernels take 1 to {MAX_LEVELS} levels, got {cfg.n_levels}")
    if cfg.n_features_per_level != 2:
        raise ValueError("the hash kernels take 2 features per level, got "
                         f"{cfg.n_features_per_level}")
    if n * cfg.n_levels * 8 >= INDEX_LIMIT:
        raise ValueError(f"{n} points x {cfg.n_levels} levels x 8 corners reach 2^31: "
                         "evaluate the field in blocks of points")
    if cfg.total_table_size * cfg.n_features_per_level >= INDEX_LIMIT:
        raise ValueError(f"a table of {cfg.total_table_size} entries reaches 2^31 values")


def _check_operands(table: torch.Tensor, pos01: torch.Tensor, cfg, dtype) -> int:
    n = pos01.shape[0] if pos01.dim() == 2 else -1
    if pos01.shape != (n, 3) or pos01.dtype != torch.float32:
        raise ValueError(f"pos01 must be (N, 3) float32, got {tuple(pos01.shape)} {pos01.dtype}")
    if tuple(table.shape) != (cfg.total_table_size, cfg.n_features_per_level) or (
            table.dtype != torch.float32):
        raise ValueError(f"table must be ({cfg.total_table_size}, {cfg.n_features_per_level}) "
                         f"float32, got {tuple(table.shape)} {table.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the hash kernels compute in float32 or bfloat16, not {dtype}")
    check_sizes(n, cfg)
    for name, t in (("pos01", pos01), ("table", table)):
        if t.device != pos01.device or not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous, 8-byte aligned and on {pos01.device}")
    return n


def _levels(cfg):
    def arr(values):
        values = [int(v) for v in values]
        return (ctypes.c_uint * len(values))(*values)

    return (cfg.n_levels, ctypes.c_uint(2 ** cfg.log2_hashmap_size - 1),
            arr(cfg.level_resolutions()), arr(cfg.level_offsets()[:-1]),
            arr(cfg.level_dense()))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def level_groups(cfg, budget: int) -> list:
    """(first level, levels) of each launch of the backward: consecutive levels,
    in pairs, while the group's int64 sums (16 bytes an entry) fit ``budget``."""
    sizes = [16 * int(t) for t in cfg.level_table_sizes()]
    step = 2 if cfg.n_levels % 2 == 0 else 1
    groups, start, used = [], 0, 0
    for l0 in range(0, cfg.n_levels, step):
        b = sum(sizes[l0:l0 + step])
        if l0 > start and used + b > budget:
            groups.append((start, l0 - start))
            start, used = l0, 0
        used += b
    groups.append((start, cfg.n_levels - start))
    return groups


def hash_encode_fwd_cuda(table: torch.Tensor, pos01: torch.Tensor, cfg,
                         dtype: torch.dtype) -> torch.Tensor:
    n = _check_operands(table, pos01, cfg, dtype)
    out = torch.empty((n, cfg.output_dim), dtype=torch.float32, device=pos01.device)
    if n == 0:
        return out
    with torch.cuda.device(pos01.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().lt_hash_fwd(_ptr(pos01), _ptr(table), n, *_levels(cfg),
                                  int(dtype == torch.bfloat16), _ptr(out),
                                  ctypes.c_void_p(stream)), "lt_hash_fwd")
    counts.fwd_launches += 1
    return out


def hash_encode_bwd_cuda(table: torch.Tensor, pos01: torch.Tensor, dout: torch.Tensor, cfg,
                         dtype: torch.dtype, need_dpos: bool = True,
                         sink: Optional[FixedPointSum] = None,
                         group_bytes: int = BWD_GROUP_BYTES
                         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dtable, dpos); dpos None, and neither re-gathered nor formed on the card,
    when ``need_dpos`` is False; dtable None with ``sink`` (the kernel adds into
    its int64 sums). One launch a level group of at most ``group_bytes`` of sums."""
    n = _check_operands(table, pos01, cfg, dtype)
    if dout.shape != (n, cfg.output_dim) or dout.dtype != torch.float32 or (
            dout.device != pos01.device or not dout.is_contiguous() or dout.data_ptr() % 8):
        raise ValueError(f"dout must be ({n}, {cfg.output_dim}) float32, contiguous, on "
                         f"{pos01.device}; got {tuple(dout.shape)} {dout.dtype}")
    acc = table_sum(table) if sink is None else sink
    if acc.acc.shape != table.shape or acc.acc.device != table.device or (
            acc.bits != HASH_BITS or not acc.acc.is_contiguous()):
        raise ValueError(f"the table gradient's sum must be a contiguous {tuple(table.shape)} "
                         f"int64 sum at 2^{HASH_BITS} on {table.device}")
    dpos = torch.empty((n, 3), dtype=torch.float32, device=pos01.device) if need_dpos else None
    if n > 0:
        groups = level_groups(cfg, group_bytes)
        with torch.cuda.device(pos01.device):
            stream = torch.cuda.current_stream().cuda_stream
            for i, (l0, lg) in enumerate(groups):
                _check(_lib().lt_hash_bwd(_ptr(pos01), _ptr(table), _ptr(dout), n, *_levels(cfg),
                                          int(dtype == torch.bfloat16), l0, lg, int(i == 0),
                                          int(i == len(groups) - 1), float(2.0 ** acc.bits),
                                          _ptr(acc.acc), _ptr(acc.mag),
                                          _ptr(dpos) if need_dpos else ctypes.c_void_p(None),
                                          ctypes.c_void_p(stream)), "lt_hash_bwd")
                counts.bwd_launches += 1
                if not need_dpos:
                    counts.bwd_no_dpos_launches += 1
    return (acc.to_float() if sink is None else None), dpos


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _select(pos01: torch.Tensor, plain: bool):
    """The plain version on the CPU (or when ``plain`` asks for the reference),
    the CUDA kernels on a CUDA tensor."""
    if plain or pos01.device.type == "cpu":
        return hash_encode_fwd_plain, hash_encode_bwd_plain
    if pos01.device.type == "cuda":
        return hash_encode_fwd_cuda, hash_encode_bwd_cuda
    raise ValueError(f"no hash-encode implementation for device {pos01.device}")


class HashEncodeFunction(torch.autograd.Function):
    """Residuals are the table and the points: the backward recomputes the
    corners and re-gathers their features (the table is unchanged between the
    two passes)."""

    @staticmethod
    def forward(ctx, table, pos01, cfg, dtype, plain, sink):
        fwd, _ = _select(pos01, plain)
        ctx.save_for_backward(table, pos01)
        ctx.meta = (cfg, dtype, plain, sink)
        return fwd(table, pos01, cfg, dtype)

    @staticmethod
    def backward(ctx, dout):
        cfg, dtype, plain, sink = ctx.meta
        table, pos01 = ctx.saved_tensors
        _, bwd = _select(pos01, plain)
        # Points that need no gradient (frozen poses) skip the dpos half; a table
        # that needs none adds nothing to the sink.
        dtable, dpos = bwd(table, pos01, dout.to(torch.float32).contiguous(), cfg, dtype,
                           need_dpos=ctx.needs_input_grad[1],
                           sink=sink if ctx.needs_input_grad[0] else None)
        return dtable, dpos, None, None, None, None


def hash_encode(table: torch.Tensor, pos01: torch.Tensor, cfg,
                dtype: torch.dtype = torch.float32, plain: bool = False,
                sink: Optional[FixedPointSum] = None) -> torch.Tensor:
    """Encode (N, 3) points in [0, 1] into (N, L F) f32 features with the
    concatenated (T, F) table; differentiable in both. ``dtype`` is the compute
    dtype of the gather and the trilinear sum (float32 or bfloat16). With
    ``sink`` (a ``table_sum``) the backward adds the table's gradient to it and
    gives the table none."""
    return HashEncodeFunction.apply(table, pos01, cfg, dtype, plain, sink)

