"""The plain reference of the mapper's joint pose-and-map iteration.

Plain PyTorch, eager, and independent of the port: it imports nothing of
``loner_tpu_torch`` (nor JAX, nor the JAX package). It is a frozen copy of the
mathematics the port's plain paths state, written out again from the
configuration file: LiDAR rays built through the pose twists
(``mapping/rays.py``), the occupancy-grid or proposal sampler
(``models/rendering.py``, ``models/proposal.py``), the sigma field (Fourier
features and MLP as ``ops/fourier_mlp.py``'s plain version computes them; the
hash grid as ``ops/hash_grid.py``'s, with its table gradient an exact float64
sum rounded once, where the port sums in fixed point), alpha compositing, the
JS dynamic-margin loss and the proposal's linear loss (``mapping/loss.py``,
``mapping/optimizer.py``), Adam on the sigma, twist and proposal parameters and
the occupancy grid's SGD step, whose gradient is autograd's through
``grid_sample``.

``Precision``: ``lower=False`` computes in what the configuration states:
values rounded to bfloat16 where it computes in bfloat16, float32 products
with TF32 off elsewhere. ``lower=True`` is the control, one step below each:
float8 (e4m3, scaled per tensor) where bfloat16 is stated, TF32 (operands
rounded to 10 mantissa bits) where float32 is. The draws come from the run's
generator through ``draw``, a copy of the port's ``draw_step``: the same
tensors in the same order give the same numbers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to float8 e4m3 under one scale for the tensor, its
    largest magnitude at the format's largest value (as fp8 training scales)."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Precision:
    """Where values are rounded: ``reduced(x, dtype)`` where the configuration
    computes in ``dtype``; ``operand(x)`` on every float32 product's operands."""

    def __init__(self, lower: bool = False) -> None:
        self.lower = lower

    def reduced(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if dtype == torch.float32:
            return self.operand(x)
        if self.lower:
            return round_e4m3(x)
        return x.to(dtype).to(torch.float32)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.lower else x


def fourier_bmat(config: dict, seed: int, n_freqs: int, scale: float) -> torch.Tensor:
    """The fixed (3, F) projection: the configuration's unscaled draw times scale
    times 2 pi, in float32 as the port forms it."""
    b = np.asarray(config["bmats"][f"{seed}_{n_freqs}"], dtype=np.float32)
    return torch.from_numpy(b * np.float32(scale) * np.float32(2.0 * math.pi))


# -- draws ---------------------------------------------------------------------

def draw(generator: torch.Generator, opt: dict, window: int, device) -> Dict[str, torch.Tensor]:
    """One iteration's draws: ray picks, sampler jitter, sigma noise and (OGM) the
    importance uniforms, in the port's order."""
    b, s = window * opt["n_lidar_samples"], opt["n_samples_per_ray"]
    ogm = opt["samples_strategy"] == "OGM"
    shapes = [("ray_u", (window, opt["n_lidar_samples"]))]
    if opt["perturb"] > 0:
        shapes.append(("jitter", (b, s // 2 if ogm else s)))
    if opt["raw_noise_std"] > 0:
        shapes.append(("noise", (b, s)))
    if ogm:
        shapes.append(("pdf_u", (b, s // 2)))
    out = {}
    for name, shape in shapes:
        t = torch.empty(shape, device=device)
        if name == "noise":
            t.normal_(generator=generator)
        else:
            t.uniform_(generator=generator)
        out[name] = t
    return out


# -- rays -----------------------------------------------------------------------

def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(aa * aa, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = torch.zeros_like(x)
    k = torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(k.shape)
    k2 = aa[..., :, None] * aa[..., None, :] - theta2 * eye
    return eye + a * k + b * k2


def far_value(origins: torch.Tensor, dirs: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    d = dirs + eps
    t_neg = torch.clamp((-1.0 - origins) / d, min=0.0)
    t_pos = torch.clamp((1.0 - origins) / d, min=0.0)
    return torch.maximum(t_neg, t_pos).min(dim=-1).values


def build_rays(window: Dict[str, torch.Tensor], twists: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, ray_range, n_lidar: int, u: torch.Tensor):
    """(rays (B, 11) in cube coordinates, depths_cube (B,), valid (B,)). ``scale``
    is a 0-dim float32 tensor, as the port holds it: a division by a Python
    number multiplies by its reciprocal, which rounds otherwise."""
    w = window["dirs"].shape[0]
    counts = window["counts"][:, None].long()
    idx = torch.minimum(torch.floor(u * counts.to(u.dtype)).long(), counts - 1)
    dirs_s = torch.gather(window["dirs"], 1, idx[..., None].expand(w, n_lidar, 3))
    depths_m = torch.gather(window["depths"], 1, idx)
    valid = window["slot_valid"][:, None].expand(w, n_lidar)
    rot = axis_angle_to_matrix(twists[:, 3:])[:, None]
    trans = twists[:, None, :3]
    dirs_w = (rot * dirs_s[:, :, None, :]).sum(dim=-1)
    origins = ((trans + shift) / scale).expand(dirs_w.shape)
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    b = w * n_lidar
    origins, dirs_w = origins.reshape(b, 3), dirs_w.reshape(b, 3)
    depths_cube = (depths_m / scale).reshape(b)
    valid = valid.reshape(b)
    near = torch.full((b,), ray_range[0], dtype=origins.dtype, device=origins.device) / scale
    far = torch.clamp(far_value(origins, dirs_w), max=ray_range[1] / scale)
    valid = valid & (far > near + 1.0 / scale)
    valid = valid & (origins.abs().max(dim=-1).values <= 1.0)
    rays = torch.cat([origins, dirs_w, -dirs_w, near[:, None], far[:, None]], dim=-1)
    return rays, depths_cube, valid


# -- samplers -------------------------------------------------------------------

def inverse_cdf(cdf, bins, u, eps: float = 1e-5, edges=None):
    m = cdf.shape[-1]
    hi = torch.searchsorted(cdf, u.contiguous(), right=True).clamp(1, m - 1)
    lo = hi - 1
    cdf_lo, cdf_hi = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    if edges is None:
        bin_lo, bin_hi = torch.gather(bins, 1, lo), torch.gather(bins, 1, hi)
    else:
        near, far, t = edges
        t_lo, t_hi = t[lo], t[hi]
        bin_lo, bin_hi = near * (1.0 - t_lo) + far * t_lo, near * (1.0 - t_hi) + far * t_hi
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, 1.0, denom)
    out = bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)
    return torch.where(u >= cdf[:, -1:], bins[:, -1:], out)


def stratified(near, far, n: int, perturb: float, rand):
    steps = torch.linspace(0.0, 1.0, n, dtype=near.dtype, device=near.device)
    z = near * (1.0 - steps) + far * steps
    if perturb > 0 and rand is not None:
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        upper = torch.cat([mid, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mid], dim=-1)
        z = lower + (upper - lower) * (perturb * rand)
    return z


def grid_logits(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    shape = points.shape[:-1]
    out = F.grid_sample(grid[None, None], points.reshape(1, 1, 1, -1, 3), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(shape)


def ogm_samples(rays, n: int, perturb: float, grid, jitter, pdf_u):
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 9:10], rays[:, 10:11]
    half = n // 2
    z = stratified(near, far, half, perturb, jitter)
    with torch.no_grad():
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        probs = torch.sigmoid(grid_logits(grid, pts))
        probs = 2.0 * (torch.clamp(probs, 0.5, 1.0) - 0.5)
        bins = 0.5 * (z[:, :-1] + z[:, 1:])
        weights = probs[:, 1:-1] + 1e-5
        pdf = weights / weights.sum(dim=-1, keepdim=True)
        cdf = torch.cumsum(pdf, dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
        u = torch.minimum(pdf_u, cdf[:, -1:])
        z_imp = inverse_cdf(cdf, bins, u)
    return torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1).values


def proposal_logits(prop: Dict[str, torch.Tensor], points: torch.Tensor,
                    prec: Precision) -> torch.Tensor:
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    proj = prec.operand(p) @ prec.operand(prop["bmat"])
    h = torch.cat([torch.sin(proj), torch.cos(proj), p], dim=-1)
    n = sum(1 for k in prop if k.startswith("w"))
    for i in range(n):
        h = matmul32(h, prop[f"w{i}"], prec)
        if i < n - 1:
            h = torch.relu(h)
    return h.reshape(shape)


def proposal_samples(rays, n: int, perturb: float, prop, n_ctrl: int, jitter, prec):
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 9:10], rays[:, 10:11]
    steps = torch.linspace(0.0, 1.0, n_ctrl, dtype=rays.dtype, device=rays.device)
    z_ctrl = near * (1.0 - steps) + far * steps
    with torch.no_grad():
        pts = o[:, None, :] + d[:, None, :] * z_ctrl[..., None]
        probs = torch.sigmoid(proposal_logits(prop, pts, prec))
        probs = 2.0 * (torch.clamp(probs, 0.5, 1.0) - 0.5)
        occ_w = 0.5 * (probs[:, :-1] + probs[:, 1:]) + 1e-5
        occ_w = occ_w / occ_w.sum(dim=-1, keepdim=True)
        w = 0.5 / (n_ctrl - 1) + 0.5 * occ_w
        cdf = torch.cumsum(w, dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    q = torch.arange(n, dtype=rays.dtype, device=rays.device)
    if perturb > 0 and jitter is not None:
        u = (q[None, :] + jitter) / n
    else:
        u = ((q + 0.5) / n).expand(rays.shape[0], n)
    u = torch.minimum(u, cdf[:, -1:])
    return inverse_cdf(cdf, z_ctrl, u, edges=(near, far, steps))


# -- products ---------------------------------------------------------------------

class _Matmul32(torch.autograd.Function):
    """``x @ w`` in float32 with every product's operands through
    ``Precision.operand``, in the backward's products too."""

    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(x, w)
        ctx.prec = prec
        return prec.operand(x) @ prec.operand(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        op = ctx.prec.operand
        gx = op(g) @ op(w).t() if ctx.needs_input_grad[0] else None
        gw = op(x).t() @ op(g) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def matmul32(x, w, prec: Precision):
    return _Matmul32.apply(x, w, prec) if prec.lower else x @ w


# -- sigma field -------------------------------------------------------------------

def _fourier_features(p, bmat, dtype, prec):
    proj = p[:, 0:1] * bmat[0] + p[:, 1:2] * bmat[1] + p[:, 2:3] * bmat[2]
    return torch.cat([prec.reduced(torch.sin(proj), dtype), prec.reduced(torch.cos(proj), dtype),
                      prec.reduced(p, dtype)], dim=-1)


class _FourierMLP(torch.autograd.Function):
    """Fourier features [sin, cos, p] and a ReLU MLP with biases in ``dtype``
    (f32 sums; biases added in f32); the backward recomputes the forward,
    rounds each cotangent to ``dtype`` and sums dW and db in f32."""

    @staticmethod
    def forward(ctx, p, bmat, dtype, prec, n, *wb):
        ws, bs = wb[:n], wb[n:]
        ctx.save_for_backward(p, bmat, *wb)
        ctx.meta = (dtype, prec, n)
        h = _fourier_features(p, bmat, dtype, prec)
        for w, b in zip(ws[:-1], bs[:-1]):
            h = prec.reduced(torch.relu(h @ prec.reduced(w, dtype) + b), dtype)
        return h @ prec.reduced(ws[-1], dtype) + bs[-1]

    @staticmethod
    def backward(ctx, dout):
        dtype, prec, n = ctx.meta
        p, bmat, *wb = ctx.saved_tensors
        ws, bs = wb[:n], wb[n:]
        f = bmat.shape[1]
        x = _fourier_features(p, bmat, dtype, prec)
        wr = [prec.reduced(w, dtype) for w in ws]
        acts, h = [], x
        for w, b in zip(wr[:-1], bs[:-1]):
            h = prec.reduced(torch.relu(h @ w + b), dtype)
            acts.append(h)
        dws: List[Any] = [None] * n
        dbs: List[Any] = [None] * n
        g = prec.reduced(dout, dtype)
        for i in range(n - 1, 0, -1):
            h_prev = acts[i - 1]
            dws[i] = h_prev.T @ g
            dbs[i] = g.sum(dim=0).reshape(bs[i].shape)
            g = prec.reduced(torch.where(h_prev > 0, g @ wr[i].T, 0.0), dtype)
        dws[0] = x.T @ g
        dbs[0] = g.sum(dim=0).reshape(bs[0].shape)
        dx = g @ wr[0].T
        dproj = dx[:, :f] * x[:, f:2 * f] - dx[:, f:2 * f] * x[:, :f]
        dp = dx[:, 2 * f:] + prec.reduced(dproj, dtype) @ prec.reduced(bmat.T, dtype)
        return (dp, None, None, None, None, *dws, *dbs)


def hash_geometry(pos01: torch.Tensor, hcfg: dict):
    """Per level: corner indices (N, L, 8) into the concatenated table, trilinear
    weights (N, L, 8), frac (N, L, 3), resolutions (L,); corner 4 ix + 2 iy + iz."""
    n_levels, log2 = hcfg["n_levels"], hcfg["log2_hashmap_size"]
    res_np = np.floor(hcfg["base_resolution"] * hcfg["per_level_scale"] ** np.arange(n_levels)
                      ).astype(np.int64)
    sizes = np.minimum((res_np + 1) ** 3, 2 ** log2)
    offsets_np = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    dev = pos01.device
    res = torch.as_tensor(res_np, device=dev)
    resf = res.to(torch.float32)
    dense = torch.as_tensor((res_np + 1) ** 3 <= 2 ** log2, device=dev)
    scaled = pos01.clamp(0.0, 1.0)[:, None, :] * resf[None, :, None]
    cellf = torch.minimum(torch.floor(scaled), (resf - 1.0)[None, :, None])
    frac = scaled - cellf
    cell = cellf.long()
    ax = [torch.stack([1.0 - frac[..., a], frac[..., a]], dim=-1) for a in range(3)]
    n = pos01.shape[0]
    w = (ax[0][..., :, None, None] * ax[1][..., None, :, None] * ax[2][..., None, None, :]
         ).reshape(n, n_levels, 8)
    corner = [torch.stack([cell[..., a], cell[..., a] + 1], dim=-1) for a in range(3)]
    r1 = (res + 1)[None, :, None]
    dense_idx = (corner[0][..., :, None, None] + (corner[1] * r1)[..., None, :, None]
                 + (corner[2] * r1 * r1)[..., None, None, :])
    primes = (1, 2654435761, 805459861)
    hashed = [corner[a] * primes[a] for a in range(3)]
    hash_idx = (hashed[0][..., :, None, None] ^ hashed[1][..., None, :, None]
                ^ hashed[2][..., None, None, :]) & (2 ** log2 - 1)
    idx = torch.where(dense[None, :, None, None, None], dense_idx, hash_idx)
    idx = idx.reshape(n, n_levels, 8) + torch.as_tensor(offsets_np, device=dev)[None, :, None]
    return idx, w, frac, resf, ax


class _HashEncode(torch.autograd.Function):
    """The multiresolution hash encode in ``dtype`` (corner values and weights
    rounded, their products rounded, summed in f32 in corner order, the sum
    rounded); the table gradient an exact float64 sum of w g rounded to f32
    once; the position gradient by the closed form through the weights, half
    weight at an exact 0 or 1."""

    @staticmethod
    def forward(ctx, table, pos01, hcfg, dtype, prec):
        idx, w, _, _, _ = hash_geometry(pos01, hcfg)
        feats = table[idx]
        prod = prec.reduced(prec.reduced(feats, dtype) * prec.reduced(w, dtype)[..., None], dtype)
        acc = prod[:, :, 0]
        for k in range(1, 8):
            acc = acc + prod[:, :, k]
        ctx.save_for_backward(table, pos01)
        ctx.meta = (hcfg, dtype, prec)
        return prec.reduced(acc, dtype).reshape(pos01.shape[0], -1)

    @staticmethod
    def backward(ctx, dout):
        table, pos01 = ctx.saved_tensors
        hcfg, dtype, prec = ctx.meta
        n, n_levels, f_dim = pos01.shape[0], hcfg["n_levels"], hcfg["n_features_per_level"]
        idx, w, frac, resf, ax = hash_geometry(pos01, hcfg)
        g = dout.reshape(n, n_levels, 1, f_dim).to(torch.float32)
        dtable = None
        if ctx.needs_input_grad[0]:
            acc = torch.zeros(table.shape, dtype=torch.float64, device=table.device)
            acc.index_add_(0, idx.reshape(-1), (w[..., None] * g).reshape(-1, f_dim).double())
            dtable = acc.to(torch.float32)
        dpos = None
        if ctx.needs_input_grad[1]:
            feats = prec.reduced(table[idx], dtype) if dtype != torch.float32 else table[idx]
            s = feats[..., 0] * g[..., 0]
            for j in range(1, f_dim):
                s = s + feats[..., j] * g[..., j]
            s = s.reshape(n, n_levels, 2, 2, 2)
            wx, wy, wz = ax
            terms = ((lambda a, b: s[:, :, 1, a, b] - s[:, :, 0, a, b], wy, wz),
                     (lambda a, b: s[:, :, a, 1, b] - s[:, :, a, 0, b], wx, wz),
                     (lambda a, b: s[:, :, a, b, 1] - s[:, :, a, b, 0], wx, wy))
            dfrac = []
            for diff, wu, wv in terms:
                total = None
                for a in range(2):
                    for b in range(2):
                        t = diff(a, b) * (wu[..., a] * wv[..., b])
                        total = t if total is None else total + t
                dfrac.append(total)
            dfrac = torch.stack(dfrac, dim=-1) * resf[None, :, None]
            dpos = dfrac[:, 0]
            for lvl in range(1, n_levels):
                dpos = dpos + dfrac[:, lvl]
            clip = ((pos01 > 0.0) & (pos01 < 1.0)).to(torch.float32) + 0.5 * (
                (pos01 == 0.0) | (pos01 == 1.0)).to(torch.float32)
            dpos = dpos * clip
        return dtable, dpos, None, None, None


def sigma_field(params: Dict[str, torch.Tensor], pos: torch.Tensor, config: dict,
                prec: Precision, bmat: Optional[torch.Tensor]) -> torch.Tensor:
    """Raw sigma (N, 1) at cube points (N, 3)."""
    fcfg, opt = config["field"], config["optimizer"]
    dtype = dtype_of(fcfg["compute_dtype"])
    pos01 = (pos + 1.0) * 0.5
    n = sum(1 for k in params if k.startswith("w"))
    ws = [params[f"w{i}"] for i in range(n)]
    if fcfg["encoding_sigma"] == "fourier":
        bs = [params[f"b{i}"] for i in range(n)]
        sigma = _FourierMLP.apply(pos01, bmat, dtype, prec, n, *ws, *bs)
    else:
        encode_dtype = {"vjp_bf16": torch.bfloat16}.get(opt["encode_impl"], torch.float32)
        h = _HashEncode.apply(params["table"], pos01, fcfg["pos_encoding_sigma"], encode_dtype,
                              prec)
        if dtype != torch.float32:
            raise NotImplementedError("the hash head's MLP in a reduced dtype")
        for i, w in enumerate(ws):
            h = matmul32(h, w, prec)
            if f"b{i}" in params:
                h = h + params[f"b{i}"]
            if i < n - 1:
                h = torch.relu(h)
        sigma = h
    finfo = torch.finfo(dtype)
    return torch.nan_to_num(sigma, posinf=finfo.max, neginf=finfo.min)


# -- compositing and loss -------------------------------------------------------------

def composite(raw, z, rays_d, noise, noise_std, softplus: bool, far):
    sig = raw[..., 0]
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if noise_std > 0 and noise is not None:
        sig = sig + noise * noise_std
    act = F.softplus(sig) if softplus else torch.relu(sig)
    alphas = 1.0 - torch.exp(-deltas * act)
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10],
                                    dim=-1), dim=-1)[:, :-1]
    weights = alphas * trans
    opacity = weights.sum(dim=-1)
    z_app = torch.cat([z, far], dim=-1)
    w_app = torch.cat([weights, 1.0 - weights.sum(dim=-1, keepdim=True)], dim=-1)
    return (w_app * z_app).sum(dim=-1), weights, opacity


MASS_3SIGMA = math.erf(3.0 / math.sqrt(2.0))


def weights_gt(z, depth, eps):
    sigma = eps / 3.0
    x = (z - depth) / sigma
    w = 0.3989422804014327 * torch.exp(-0.5 * x * x) / sigma / MASS_3SIGMA
    w = torch.where((z >= depth - eps) & (z <= depth + eps), w, 0.0)
    return w / (w.sum(dim=1, keepdim=True) + 1e-6)


def logits_grad(z, depth, eps: float = 2.0, l_free: float = 0.25, l_occ: float = 2.5):
    x = z - depth
    heav = lambda v: (v > 0).to(z.dtype)  # noqa: E731
    return l_free * heav(-x - eps) - l_occ * heav(x + eps) * heav(eps - x)


def kl_gauss(m1, s1, m2, s2):
    return torch.log(s2 / s1) + (s1 * s1 + (m1 - m2) ** 2) / (2.0 * s2 * s2) - 0.5


def js_gauss(m1, s1, m2, s2):
    mm, sm = 0.5 * (m1 + m2), 0.5 * torch.sqrt(s1 * s1 + s2 * s2)
    return 0.5 * kl_gauss(m1, s1, mm, sm) + 0.5 * kl_gauss(m2, s2, mm, sm)


def masked_mean(x, mask):
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# -- the iteration ------------------------------------------------------------------

class PlainTrainer:
    """The joint phase from a given state: ``step(draws)`` is one iteration
    (forward, backward, the pose mask, Adam, the OGM step when it is due).

    ``state``: {"sigma": {"w0", ..., ["b0", ...], ["table"]}, "twists": (W, 6),
    "proposal": {"bmat", "w0", ...} or "grid": (V, V, V)}; ``window``: the
    buffers (dirs, depths, counts, slot_valid); copies are trained."""

    def __init__(self, config: dict, window: Dict[str, torch.Tensor], state: Dict[str, Any],
                 scale: float, lower: bool = False, step0: int = 0) -> None:
        self.config = config
        self.opt = config["optimizer"]
        self.prec = Precision(lower)
        self.window = window
        dev = window["dirs"].device
        self.scale = torch.tensor(float(scale), dtype=torch.float32, device=dev)
        self.shift = torch.zeros(3, device=dev)
        self.leaves: Dict[str, torch.Tensor] = {}
        self.rates: Dict[str, float] = {}
        for k, v in state["sigma"].items():
            self._leaf(f"sigma.{k}", v, self.opt["lr_sigma"])
        self._leaf("twists", state["twists"], self.opt["lr_pose"])
        self.prop_bmat = None
        if "proposal" in state:
            self.prop_bmat = state["proposal"]["bmat"].detach().clone()
            for k, v in state["proposal"].items():
                if k != "bmat":
                    self._leaf(f"proposal.{k}", v, self.opt["prop_lr"])
        self.grid = state["grid"].detach().clone() if "grid" in state else None
        fcfg = config["field"]
        self.bmat = None
        if fcfg["encoding_sigma"] == "fourier":
            f = fcfg["fourier_sigma"]
            self.bmat = fourier_bmat(config, f["seed"], f["n_freqs"], f["scale"]).to(dev)
        self.mask = torch.ones(window["dirs"].shape[0], device=dev)  # every slot's pose trained
        self.moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in self.leaves.items()}
        self.t = 0
        self.gstep = step0
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def _leaf(self, name: str, value: torch.Tensor, rate: float) -> None:
        self.leaves[name] = value.detach().clone().requires_grad_(True)
        self.rates[name] = rate

    def state(self) -> Dict[str, torch.Tensor]:
        out = {k: v.detach() for k, v in self.leaves.items()}
        if self.grid is not None:
            out["grid"] = self.grid
        return out

    def loss(self, d: Dict[str, torch.Tensor]):
        opt, prec = self.opt, self.prec
        sigma = {k.split(".", 1)[1]: v for k, v in self.leaves.items() if k.startswith("sigma.")}
        prop = {k.split(".", 1)[1]: v for k, v in self.leaves.items() if k.startswith("proposal.")}
        if prop:
            prop["bmat"] = self.prop_bmat
        rays, depths_cube, valid = build_rays(self.window, self.leaves["twists"], self.scale,
                                              self.shift, opt["ray_range"], opt["n_lidar_samples"],
                                              d["ray_u"])
        s = opt["n_samples_per_ray"]
        if opt["samples_strategy"] == "OGM":
            z = ogm_samples(rays, s, opt["perturb"], self.grid, d.get("jitter"), d.get("pdf_u"))
        elif opt["samples_strategy"] == "PROPOSAL":
            z = proposal_samples(rays, s, opt["perturb"], prop, opt["prop_n_ctrl"] or s // 2,
                                 d.get("jitter"), prec)
        else:
            raise NotImplementedError(opt["samples_strategy"])
        o, dirs, far = rays[:, 0:3], rays[:, 3:6], rays[:, 10:11]
        pts = o[:, None, :] + dirs[:, None, :] * z[..., None]
        raw = sigma_field(sigma, pts.reshape(-1, 3), self.config, prec, self.bmat)
        softplus = self.config["field"]["density_activation"] == "softplus"
        depth, w_pred, opacity = composite(raw.reshape(pts.shape[0], s, 1), z, dirs, d.get("noise"),
                                           opt["raw_noise_std"], softplus, far)
        lc = opt["loss"]
        if lc["loss_selection"] not in ("L1_JS", "L2_JS"):
            raise NotImplementedError(lc["loss_selection"])
        z_m = z * self.scale
        gt_m = depths_cube * self.scale
        opaque = (depths_cube > 0) & (~(depths_cube > far[:, 0])) & valid
        eps_min = lc["min_depth_eps"]
        w_sum = w_pred.sum(dim=1)
        mean = (z_m * w_pred).sum(dim=1) / (w_sum + 1e-10)
        var = ((z_m - mean[:, None]) ** 2 * w_pred).sum(dim=1) / (w_sum + 1e-10) + 1e-10
        js = js_gauss(gt_m, eps_min / 3.0, mean, torch.sqrt(var))
        depth_loss = masked_mean((depth * self.scale - gt_m) ** 2, opaque)
        js_c = torch.clamp(torch.where(js < lc["min_js_score"], 0.0, js), max=lc["max_js_score"])
        eps_dyn = (eps_min * (1.0 + lc["js_alpha"] * js_c)).detach()[:, None]
        wgt = torch.where(opaque[:, None], weights_gt(z_m, gt_m[:, None], eps_dyn), 0.0)
        diff = w_pred - wgt
        per = diff.abs() if lc["loss_selection"].startswith("L1") else diff * diff
        if lc["decay_los_lambda"]:
            raise NotImplementedError("a decayed line-of-sight weight")
        los = masked_mean(per, valid[:, None].expand(per.shape))
        opacity_loss = masked_mean((opacity - 1.0).abs(), opaque)
        mapping = lc["depthloss_lambda"] * depth_loss + lc["los_lambda"] * los + opacity_loss
        total = mapping
        if prop:
            sub = max(int(opt["prop_train_subsample"]), 1)
            z_sub = z_m[:, ::sub].detach()
            lg = logits_grad(z_sub, gt_m[:, None].detach()) * valid[:, None]
            logits = proposal_logits(prop, pts[:, ::sub].detach(), prec)
            denom = torch.clamp(valid.sum().to(logits.dtype) * z_sub.shape[1], min=1.0)
            total = total + (lg * logits).sum() / denom
        return total, mapping, {"z_m": z_m, "gt_m": gt_m, "valid": valid, "points": pts}

    def step(self, d: Dict[str, torch.Tensor]) -> float:
        opt = self.opt
        for v in self.leaves.values():
            v.grad = None
        total, mapping, aux = self.loss(d)
        total.backward()
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in self.leaves.items()}
        grads["twists"] = grads["twists"] * self.mask[:, None]
        occ_step = self.grid is not None and self.gstep % int(opt["occ_update_every"]) == 0
        grid_grad = None
        if occ_step:
            lg = logits_grad(aux["z_m"].detach(), aux["gt_m"][:, None].detach())
            lg = lg * aux["valid"][:, None]
            leaf = self.grid.clone().requires_grad_(True)
            grid_logits(leaf, aux["points"].detach()).backward(lg)
            grid_grad = leaf.grad
        if self.first_grads is None:
            self.first_grads = {k: g.detach().clone() for k, g in grads.items()}
            if grid_grad is not None:
                self.first_grads["grid"] = grid_grad.detach().clone()
        self.t += 1
        b1, b2 = BETAS
        with torch.no_grad():
            for k, v in self.leaves.items():
                m, s2 = self.moments[k]
                g = grads[k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                s2.mul_(b2).addcmul_(g, g, value=1 - b2)
                rate = self.rates[k]
                if not k.startswith("proposal."):
                    rate = rate * opt["lr_gamma"] ** (self.t - 1)
                m_hat = m / (1 - b1 ** self.t)
                v_hat = s2 / (1 - b2 ** self.t)
                v.sub_(rate * m_hat / (v_hat.sqrt() + ADAM_EPS))
            if grid_grad is not None:
                self.grid = self.grid - opt["occ_lr"] * grid_grad
        self.gstep += 1
        return float(mapping.detach())
