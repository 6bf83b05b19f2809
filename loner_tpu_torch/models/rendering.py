"""Volume rendering: stratified, occupancy-grid and proposal-guided sampling,
alpha compositing.

Counterpart of ``loner_tpu/models/rendering.py``: depth renders through the
sigma head, and colour renders through the intensity head too. Random numbers are inputs: the stratified jitter, the importance sampler's
uniforms and the sigma noise arrive as tensors, so a test can hand the port the
draws the JAX package made.

Ray format: each ray is 11 floats ``[origin(3), dir(3), viewdir(3), near, far]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F_nn

from loner_tpu_torch.models.field import in_row_blocks
from loner_tpu_torch.runtime import profiling


def pack_rays(origins, dirs, near, far, viewdirs=None) -> torch.Tensor:
    """Assemble (N, 11) rays. viewdirs default to -dirs (lidar convention)."""
    if viewdirs is None:
        viewdirs = -dirs
    return torch.cat([origins, dirs, viewdirs, near[..., None], far[..., None]], dim=-1)


def _inverse_cdf(cdf: torch.Tensor, bins: torch.Tensor, u: torch.Tensor,
                 eps: float = 1e-5, edges: Optional[tuple] = None) -> torch.Tensor:
    """Map u in [0, cdf[:, -1]] through the piecewise-linear inverse CDF.

    cdf: (B, M) strictly increasing with cdf[:, 0] == 0; bins: (B, M) ascending
    edge positions; u: (B, Q). ``searchsorted(right=True)`` picks the same
    interval as the JAX package's masked min/max lookup: the low edge is the
    last with cdf <= u, the high edge the first with cdf > u. u at (or clamped
    to) the top edge maps to the last bin edge.

    ``edges``: (near (B, 1), far (B, 1), t (M,)) when ``bins`` is ``near (1 - t)
    + far t``. The picked edges are then formed from the picked t, the same
    values, so their gradient reaches near and far through products and a sum
    along the ray, where a gather's gradient would scatter float atomics in an
    order that changes from run to run on a CUDA device.
    """
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


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               u: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF importance sampling. bins: (N, B+1) edges; weights: (N, B);
    u: (N, n_importance) uniforms, or None for the deterministic linspace."""
    n_rays = weights.shape[0]
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(n_rays, n_importance)
    u = torch.minimum(u, cdf[:, -1:])
    return _inverse_cdf(cdf, bins, u, eps)


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      perturb: float, rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform near->far z values, jittered within each stratum by ``rand``
    (B, S) uniforms when perturb > 0. near/far: (N, 1)."""
    steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z = near * (1.0 - steps) + far * steps
    if perturb > 0 and rand is not None:
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        upper = torch.cat([mid, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mid], dim=-1)
        z = lower + (upper - lower) * (perturb * rand)
    return z


# Rows (rays) a call of the transmittance's scans. On a CUDA tensor PyTorch's
# scan along the last axis picks how many threads share a row by the row count,
# and with it the order of each row's products or sums: a ray's weights would round
# differently in a window's 1024 camera rays and in a mesh rank's 256 (with 513
# samples a row, 16 threads above 512 rows, 32 at 257-512). The forward's cumprod
# and the backward's reversed cumsum run on blocks of this many rows, the last
# padded (ones, zeros), one shape a call.
SCAN_ROWS = 1024


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of strictly positive values (N, S),
    SCAN_ROWS rows a call, with the gradient PyTorch's own backward takes when no
    value is zero, ``reversed_cumsum(out * grad) / x``, its cumsum SCAN_ROWS rows a
    call too. PyTorch's backward first checks the input for zeros with
    ``.item()``: a host synchronisation, which a CUDA graph cannot capture and
    which stalls an eager loop once an iteration."""

    @staticmethod
    def forward(ctx, x):
        out = in_row_blocks(lambda b, o: torch.cumprod(b, dim=-1, out=o), x, SCAN_ROWS,
                            x.shape[1], 1.0)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        rev = in_row_blocks(lambda b, o: torch.cumsum(b, dim=-1, out=o), (out * grad).flip(-1),
                            SCAN_ROWS, x.shape[1])
        return rev.flip(-1).div(x)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                noise: Optional[torch.Tensor] = None, raw_noise_std: float = 0.0,
                softplus: bool = False, far: Optional[torch.Tensor] = None,
                ret_var: bool = False, sigma_only: bool = True, num_colors: int = 3,
                white_bkgd: bool = False) -> Dict[str, torch.Tensor]:
    """Alpha compositing. raw: (N, S, 1), or (N, S, C + 1) [colour.., sigma]
    when not ``sigma_only``; z_vals: (N, S); rays_d: (N, 3); noise: (N, S)
    standard normals; far: (N, 1). Depth uses the far-appended residual bin:
    sum(w z) + (1 - sum w) far. With colours, ``rgb`` = sum(w c) (+ 1 - sum w
    on a white background)."""
    if sigma_only:
        sigmas = raw[..., 0]
    else:
        rgbs, sigmas = raw[..., :num_colors], raw[..., num_colors]
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    # The last delta from z_vals, not from the (B, 0) deltas of a one-sample ray.
    deltas = torch.cat([deltas, torch.full_like(z_vals[:, :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if raw_noise_std > 0 and noise is not None:
        sigmas = sigmas + noise * raw_noise_std
    act = F_nn.softplus(sigmas) if softplus else torch.relu(sigmas)
    alphas = 1.0 - torch.exp(-deltas * act)
    # Every factor is at least 1e-10: the cumprod's gradient needs no zero check.
    trans = _PositiveCumprod.apply(
        torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], dim=-1)
    )[:, :-1]
    weights = alphas * trans
    opacity = weights.sum(dim=-1)
    if far is not None:
        z_app = torch.cat([z_vals, far], dim=-1)
        w_app = torch.cat([weights, 1.0 - weights.sum(dim=-1, keepdim=True)], dim=-1)
        depth = (w_app * z_app).sum(dim=-1)
    else:
        depth = (weights * z_vals).sum(dim=-1)
    out = {"depth": depth, "weights": weights, "opacity": opacity}
    if not sigma_only:
        rgb = (weights[..., None] * rgbs).sum(dim=-2)
        if white_bkgd:
            rgb = rgb + (1.0 - opacity[..., None])
        out["rgb"] = rgb
    if ret_var:
        out["variance"] = (weights * (depth[:, None] - z_vals) ** 2).sum(dim=-1)
    return out


class UniformRaySampler:
    """Stratified-uniform z sampling."""

    def get_samples(self, rays, n_samples, perturb, occ_state=None, jitter=None, pdf_u=None):
        near, far = rays[:, 9:10], rays[:, 10:11]
        return stratified_z_vals(near, far, n_samples, perturb, jitter)


class OccGridRaySampler:
    """Half stratified, half occupancy-importance samples, merged and sorted (the
    reference's OccGridRaySampler). ``jitter`` (B, S/2) jitters the stratified
    half; ``pdf_u`` (B, S/2) are the inverse-CDF uniforms, the deterministic
    linspace without them. The importance half carries no gradient."""

    def get_samples(self, rays, n_samples, perturb, occ_state=None, jitter=None, pdf_u=None):
        from loner_tpu_torch.models.occupancy_grid import interpolate_occ_logits

        if occ_state is None:
            return UniformRaySampler().get_samples(rays, n_samples, perturb, None, jitter)
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        near, far = rays[:, 9:10], rays[:, 10:11]
        n_half = n_samples // 2
        z_vals = stratified_z_vals(near, far, n_half, perturb, jitter)
        with torch.no_grad():
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            probs = torch.sigmoid(interpolate_occ_logits(occ_state, pts))
            probs = 2.0 * (torch.clamp(probs, 0.5, 1.0) - 0.5)
            z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
            z_imp = sample_pdf(z_mid, probs[:, 1:-1], n_half, u=pdf_u)
        return torch.sort(torch.cat([z_vals, z_imp], dim=-1), dim=-1).values


class ProposalRaySampler:
    """Proposal-MLP sampler: one stratified inverse-CDF pass over the blended
    density 0.5 U(near, far) + 0.5 occupancy, the occupancy read from the
    proposal MLP at ``n_ctrl`` control points along each ray. Stratified u is
    sorted, so the samples come out sorted."""

    def __init__(self, n_ctrl: Optional[int] = None) -> None:
        self._n_ctrl = n_ctrl

    def get_samples(self, rays, n_samples, perturb, occ_state=None, jitter=None, pdf_u=None):
        from loner_tpu_torch.models.proposal import proposal_logits

        if occ_state is None:
            return UniformRaySampler().get_samples(rays, n_samples, perturb, None, jitter)
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        near, far = rays[:, 9:10], rays[:, 10:11]
        n_ctrl = self._n_ctrl or n_samples // 2
        steps = torch.linspace(0.0, 1.0, n_ctrl, dtype=rays.dtype, device=rays.device)
        # z_ctrl stays differentiable (through near/far, like the uniform
        # sampler's z values); the occupancy CDF only guides where to sample and
        # carries no gradient, to the poses or to the proposal.
        z_ctrl = near * (1.0 - steps) + far * steps  # (B, C) bin edges
        with torch.no_grad():
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_ctrl[..., None]
            probs = torch.sigmoid(proposal_logits(occ_state, pts))
            probs = 2.0 * (torch.clamp(probs, 0.5, 1.0) - 0.5)
            occ_w = 0.5 * (probs[:, :-1] + probs[:, 1:]) + 1e-5
            occ_w = occ_w / occ_w.sum(dim=-1, keepdim=True)
            w = 0.5 / (n_ctrl - 1) + 0.5 * occ_w  # (B, C-1)
            cdf = torch.cumsum(w, dim=-1)
            cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
        q = torch.arange(n_samples, dtype=rays.dtype, device=rays.device)
        if perturb > 0 and jitter is not None:
            u = (q[None, :] + jitter) / n_samples
        else:
            u = ((q + 0.5) / n_samples).expand(rays.shape[0], n_samples)
        u = torch.minimum(u, cdf[:, -1:])
        return _inverse_cdf(cdf, z_ctrl, u, edges=(near, far, steps))


def make_sampler(occ_state, n_ctrl: Optional[int] = None):
    """The sampler for an occupancy-slot state: None -> uniform, a dict of
    proposal-MLP params -> proposal sampler with the trained ``n_ctrl``, a
    (V, V, V) logit grid -> occupancy-grid sampler."""
    if occ_state is None:
        return UniformRaySampler()
    if isinstance(occ_state, dict):
        return ProposalRaySampler(n_ctrl=n_ctrl)
    return OccGridRaySampler()


POINT_BLOCK = 2 ** 22  # field points per sigma call: a render chunk is evaluated in blocks


def render_rays(rays: torch.Tensor, field_params, field_cfg, sampler, n_samples: int,
                perturb: float = 0.0, raw_noise_std: float = 0.0, occ_state=None,
                ret_var: bool = False, jitter: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, pdf_u: Optional[torch.Tensor] = None,
                compositor: str = "xla", sigma_only: bool = True, detach_sigma: bool = True,
                white_bkgd: bool = False, marks=None) -> Dict[str, torch.Tensor]:
    """Render a batch of (N, 11) rays through the sigma field, and the intensity
    head unless ``sigma_only`` (view directions from the rays' viewdir columns;
    ``detach_sigma`` stops the colour loss's gradients into the sigma
    parameters). Returns depth / weights / opacity [/ variance] [/ rgb] / z_vals
    / points.

    The field is evaluated in blocks of ``POINT_BLOCK`` points (the JAX package's
    ``point_chunk``): the values do not change, and one test-render chunk of
    16384 rays x 2048 samples (33.5 M points) stays inside the hash kernels' 32-bit
    index space and a few GB of device memory.

    ``compositor="pallas"`` (the JAX package's config word) takes the fused
    compositor of ``ops/composite.py`` when it applies, by the JAX rule:
    ``sigma_only``, ``ret_var`` and no sigma noise. It is the CUDA kernel on a CUDA tensor and
    its plain version on a CPU tensor; ``"plain"`` takes the plain version on
    every device (the reference the kernel is held to on the card). Otherwise,
    and for ``"xla"``, compositing is ``raw2outputs``.

    ``marks``: a training iteration's ``runtime/profiling.py::LayerMarks``,
    which marks the sigma field's start and end, forward and backward."""
    from loner_tpu_torch.models.field import query_field

    if compositor not in ("xla", "pallas", "plain"):
        raise ValueError(f"compositor must be 'xla', 'pallas' or 'plain', got {compositor!r}")
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    far = rays[:, 10:11]
    z_vals = sampler.get_samples(rays, n_samples, perturb, occ_state, jitter, pdf_u)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]  # (N, S, 3)
    n_rays, s = pts.shape[:2]
    flat = pts.reshape(-1, 3)
    if marks is not None:
        flat = marks.boundary(flat, profiling.FIELD, profiling.RAYS_BWD)
    flat_dirs = None if sigma_only else rays[:, None, 6:9].expand(n_rays, s, 3).reshape(-1, 3)
    raw = torch.cat([query_field(field_params, flat[i : i + POINT_BLOCK],
                                 None if sigma_only else flat_dirs[i : i + POINT_BLOCK],
                                 field_cfg, sigma_only=sigma_only, detach_sigma=detach_sigma)
                     for i in range(0, max(flat.shape[0], 1), POINT_BLOCK)])
    if marks is not None:
        raw = marks.boundary(raw, profiling.COMPOSITE, profiling.FIELD_BWD)
    softplus = field_cfg.density_activation == "softplus"
    if (compositor != "xla" and sigma_only and ret_var
            and (raw_noise_std == 0 or noise is None)):
        from loner_tpu_torch.ops.composite import composite_rays

        depth, opacity, var, weights = composite_rays(
            z_vals.contiguous(), raw.reshape(n_rays, s), far[:, 0].contiguous(),
            torch.linalg.norm(rays_d, dim=-1), softplus=softplus, plain=compositor == "plain",
        )
        out = {"depth": depth, "weights": weights, "opacity": opacity, "variance": var}
    else:
        out = raw2outputs(
            raw.reshape(n_rays, s, -1), z_vals, rays_d, noise=noise,
            raw_noise_std=raw_noise_std, softplus=softplus, far=far, ret_var=ret_var,
            sigma_only=sigma_only, num_colors=field_cfg.num_colors, white_bkgd=white_bkgd,
        )
    out["z_vals"] = z_vals
    out["points"] = pts
    return out
