"""The neural scene field: the sigma head, hash-grid or Fourier.

Counterpart of ``loner_tpu/models/field.py``. The field is a function of a
parameter dict; freezing a head is a gradient mask in the optimizer. Inputs
arrive in [-1, 1]^3 (world cube) and are mapped to [0, 1].

Two sigma heads:
- ``hash`` (the reference's, cfg/nerf_config/default_nerf_hash.yaml): the
  multiresolution hash encoding of ``models/hash_encoding.py`` (the hand-written
  CUDA kernel pair on CUDA tensors, its plain version on the CPU) feeding a
  bias-free ReLU MLP, which the JAX package computes outside any kernel: in f32,
  where ``sigma_mlp_engages`` holds, the hand-written kernel pair of
  ``ops/sigma_mlp.py``, else plain ``torch`` matmuls (``mlp_apply``);
- ``fourier``: the fused Fourier-feature + MLP function of
  ``ops/fourier_mlp.py`` (the JAX package's ``sigma_kernel: pallas`` path)
  wherever that is the function the settings ask for (``FieldConfig.fused_fourier``),
  else the JAX package's encode and MLP as plain PyTorch: ``fourier_encode`` or,
  under ``encode_impl: xla``, ``fourier_encode_autograd``; ``mlp_apply_vjp`` or,
  under ``mlp_grad: xla``, ``mlp_apply_autograd``.

The intensity head (``query_field(sigma_only=False)``) encodes the position by
a hash table (``encoding_intensity: hash``, through the same hash kernels) or
Fourier features (``fourier``), appends the spherical-harmonics encoding of the
view direction, and runs a bias-free ReLU MLP and a sigmoid. That MLP is a
plain product in the JAX package too (``mlp_apply_vjp``, outside any Pallas
kernel): here it is ``torch.matmul`` on values rounded to the compute dtype
where the JAX package rounds them, with the JAX package's bf16 cotangents.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from loner_tpu_torch.models.hash_encoding import HashEncodingConfig, hash_encode, init_hash_table
from loner_tpu_torch.models.sh_encoding import sh_encode
from loner_tpu_torch.ops import sigma_mlp as sigma_mlp_ops
from loner_tpu_torch.ops.fourier_mlp import fourier_sigma_fused

BMAT_FIXTURE = Path(__file__).resolve().parent / "fourier_bmats.npz"


@dataclass(frozen=True)
class MLPConfig:
    n_neurons: int = 64
    n_hidden_layers: int = 1
    output_dim: int = 1


@dataclass(frozen=True)
class FourierConfig:
    """Gaussian random-Fourier-feature encoding. The projection matrix is a
    fixed function of (seed, n_freqs), read from a checked-in fixture."""

    n_freqs: int = 64
    scale: float = 6.0
    include_input: bool = True
    seed: int = 1234
    # "vjp": sin/cos of the f32 phase emitted and saved in the compute dtype, with
    # the JAX package's custom VJP (``fourier_encode``); "xla": f32 features and
    # plain autograd (``fourier_encode_autograd``).
    encode_impl: str = "vjp"

    @property
    def output_dim(self) -> int:
        return 2 * self.n_freqs + (3 if self.include_input else 0)

    @staticmethod
    def from_settings(cfg: dict) -> "FourierConfig":
        encode_impl = str(cfg.get("encode_impl", "vjp"))
        if encode_impl not in ("vjp", "xla"):
            raise ValueError(f"fourier encode_impl must be 'vjp' or 'xla', got {encode_impl!r}")
        return FourierConfig(
            n_freqs=int(cfg.get("n_freqs", 64)),
            scale=float(cfg.get("scale", 6.0)),
            include_input=bool(cfg.get("include_input", True)),
            seed=int(cfg.get("seed", 1234)),
            encode_impl=encode_impl,
        )


@functools.lru_cache(maxsize=None)
def _unscaled_bmat(seed: int, n_freqs: int) -> np.ndarray:
    with np.load(BMAT_FIXTURE) as z:
        key = f"{seed}_{n_freqs}"
        if key not in z.files:
            raise KeyError(
                f"no Fourier projection for seed {seed}, n_freqs {n_freqs} in "
                f"{BMAT_FIXTURE.name}; regenerate the fixture with the JAX package"
            )
        return z[key]


@functools.lru_cache(maxsize=None)
def fourier_bmat(cfg: FourierConfig, device: torch.device) -> torch.Tensor:
    """The fixed (3, F) projection: jax.random.normal(key(seed)) * scale * 2pi,
    bit-equal to the JAX package's ``fourier_bmat``."""
    b = _unscaled_bmat(cfg.seed, cfg.n_freqs) * np.float32(cfg.scale) * np.float32(2.0 * math.pi)
    # Cached for the process: never an inference tensor, whatever mode the
    # first caller runs in, or autograd could not save it later.
    with torch.inference_mode(False):
        return torch.from_numpy(b.astype(np.float32)).to(device)


@dataclass(frozen=True)
class FieldConfig:
    num_colors: int = 3
    enable_view_dependence: bool = True
    sh_degree: int = 4
    encoding_sigma: str = "hash"  # "hash" (the reference's) or "fourier"
    pos_encoding_sigma: HashEncodingConfig = dc_field(default_factory=HashEncodingConfig)
    fourier_sigma: FourierConfig = dc_field(default_factory=FourierConfig)
    encoding_intensity: str = "hash"
    pos_encoding_intensity: HashEncodingConfig = dc_field(
        default_factory=lambda: HashEncodingConfig(log2_hashmap_size=19)
    )
    fourier_intensity: FourierConfig = dc_field(
        default_factory=lambda: FourierConfig(seed=4321)
    )
    sigma_mlp: MLPConfig = dc_field(default_factory=MLPConfig)
    intensity_mlp: MLPConfig = dc_field(
        default_factory=lambda: MLPConfig(n_hidden_layers=4, output_dim=3)
    )
    density_activation: str = "relu"
    sigma_mlp_bias: bool = False
    compute_dtype: torch.dtype = torch.float32
    # "fused": the CUDA kernels on CUDA tensors, their plain version on the CPU.
    # "plain": the plain version on every device (the reference the kernels are
    # checked against on the card).
    sigma_kernel: str = "fused"
    # The hash encode's compute dtype. Renders encode in f32; the optimizer sets
    # the training encode's (OptimizerConfig.encode_impl: vjp_bf16 -> bfloat16).
    hash_encode_dtype: torch.dtype = torch.float32
    # The MLPs' backward, the JAX package's ``mlp_grad``: "vjp", its custom VJP
    # (``mlp_apply_vjp``: bf16 cotangents, f32 dW and db); "xla", plain autograd
    # in the compute dtype (``mlp_apply_autograd``). One function in float32.
    mlp_grad: str = "vjp"
    # The JAX package's ``sigma_kernel`` word: "xla", "auto" or "pallas". It says
    # which function the Fourier sigma head computes (``fused_fourier``); "auto"
    # is the fused function only on a TPU, so here it is "xla".
    fourier_sigma_impl: str = "xla"

    @property
    def sigma_input_dim(self) -> int:
        if self.encoding_sigma == "fourier":
            return self.fourier_sigma.output_dim
        return self.pos_encoding_sigma.output_dim

    @property
    def intensity_pos_dim(self) -> int:
        if self.encoding_intensity == "fourier":
            return self.fourier_intensity.output_dim
        return self.pos_encoding_intensity.output_dim

    @property
    def fused_fourier(self) -> bool:
        """Whether the Fourier sigma head computes the fused function of
        ``ops/fourier_mlp.py`` (the CUDA kernels): where the JAX package runs its
        fused kernel (``sigma_kernel: pallas``, with the input features), and
        where its unfused path computes the same function, the custom-VJP encode
        and MLP (``encode_impl: vjp``, ``mlp_grad: vjp``), as every config in
        cfg/ asks."""
        if self.encoding_sigma != "fourier" or not self.fourier_sigma.include_input:
            return False
        return self.fourier_sigma_impl == "pallas" or (
            self.fourier_sigma.encode_impl == "vjp" and self.mlp_grad == "vjp")

    @staticmethod
    def from_settings(nerf_cfg: dict, num_colors: int = 3,
                      compute_dtype: torch.dtype = torch.float32) -> "FieldConfig":
        """Build from the nerf config dict (cfg/nerf_config/*.yaml). ``mlp_grad``
        and ``sigma_kernel`` are the JAX package's words; where it takes any
        other value silently as "xla" (``mlp_grad`` not "vjp", ``sigma_kernel``
        not "pallas" or "auto"), the port raises ``ValueError``."""
        encoding = str(nerf_cfg.get("encoding_sigma", "hash"))
        if encoding not in ("hash", "fourier"):
            raise ValueError(f"unknown encoding_sigma {encoding!r}")
        encoding_intensity = str(nerf_cfg.get("encoding_intensity", "hash"))
        if encoding_intensity not in ("hash", "fourier"):
            raise ValueError(f"unknown encoding_intensity {encoding_intensity!r}")
        sigma_net = nerf_cfg["sigma_network"]
        if "compute_dtype" in nerf_cfg:
            compute_dtype = torch.bfloat16 if "bf" in str(nerf_cfg["compute_dtype"]) else torch.float32
        mlp_grad = str(nerf_cfg.get("mlp_grad", "vjp"))
        if mlp_grad not in ("vjp", "xla"):
            raise ValueError(f"mlp_grad must be 'vjp' or 'xla', got {mlp_grad!r}")
        sigma_impl = str(nerf_cfg.get("sigma_kernel", "xla"))
        if sigma_impl not in ("xla", "auto", "pallas"):
            raise ValueError(f"sigma_kernel must be 'xla', 'auto' or 'pallas', got {sigma_impl!r}")
        return FieldConfig(
            num_colors=num_colors,
            enable_view_dependence=bool(nerf_cfg.get("enable_view_dependence", True)),
            sh_degree=int(nerf_cfg.get("dir_encoding_intensity", {}).get("degree", 4)),
            encoding_sigma=encoding,
            pos_encoding_sigma=HashEncodingConfig.from_settings(
                nerf_cfg.get("pos_encoding_sigma", {})),
            fourier_sigma=FourierConfig.from_settings(nerf_cfg.get("fourier_sigma", {})),
            encoding_intensity=encoding_intensity,
            pos_encoding_intensity=HashEncodingConfig.from_settings(
                nerf_cfg["pos_encoding_intensity"]
            ),
            fourier_intensity=FourierConfig.from_settings(
                {"seed": 4321, **nerf_cfg.get("fourier_intensity", {})}
            ),
            sigma_mlp=MLPConfig(
                n_neurons=int(sigma_net["n_neurons"]),
                n_hidden_layers=int(sigma_net["n_hidden_layers"]),
                output_dim=1,
            ),
            intensity_mlp=MLPConfig(
                n_neurons=int(nerf_cfg["intensity_network"]["n_neurons"]),
                n_hidden_layers=int(nerf_cfg["intensity_network"]["n_hidden_layers"]),
                output_dim=num_colors,
            ),
            density_activation=str(
                nerf_cfg.get("density_activation", "softplus" if encoding == "fourier" else "relu")
            ),
            sigma_mlp_bias=bool(nerf_cfg.get("sigma_mlp_bias", encoding == "fourier")),
            compute_dtype=compute_dtype,
            mlp_grad=mlp_grad,
            fourier_sigma_impl=sigma_impl,
        )


def _init_mlp(generator: torch.Generator, in_dim: int, cfg: MLPConfig, bias: bool,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """He-uniform weights; optional zero biases."""
    dims = [in_dim] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.output_dim]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = math.sqrt(6.0 / d_in)
        u = torch.rand((d_in, d_out), generator=generator, device=device)
        params[f"w{i}"] = u * (2.0 * bound) - bound
        if bias:
            params[f"b{i}"] = torch.zeros((d_out,), device=device)
    return params


def init_field_params(generator: torch.Generator, cfg: FieldConfig,
                      device: torch.device) -> Dict[str, Any]:
    """{"sigma": {"mlp": ..., ["table": ...]}, "intensity": {"mlp": ..., ["table": ...]}}."""
    intensity_in = cfg.intensity_pos_dim + (
        cfg.sh_degree ** 2 if cfg.enable_view_dependence else 0
    )
    intensity: Dict[str, Any] = {
        "mlp": _init_mlp(generator, intensity_in, cfg.intensity_mlp, False, device)
    }
    if cfg.encoding_intensity != "fourier":
        intensity["table"] = init_hash_table(generator, cfg.pos_encoding_intensity, device)
    sigma: Dict[str, Any] = {
        "mlp": _init_mlp(generator, cfg.sigma_input_dim, cfg.sigma_mlp, cfg.sigma_mlp_bias, device)
    }
    if cfg.encoding_sigma != "fourier":
        sigma["table"] = init_hash_table(generator, cfg.pos_encoding_sigma, device)
    return {"sigma": sigma, "intensity": intensity}


def in_row_blocks(fn, x: torch.Tensor, rows: int, width: int, pad: float = 0.0) -> torch.Tensor:
    """``fn(block, out)`` on blocks of ``rows`` rows of ``x``, each writing the
    block's rows of an (N, ``width``) result into ``out``; the last block padded
    with ``pad``. Every call takes one shape, so a CUDA kernel that the library
    picks by the row count, and with it each row's bits, do not depend on N."""
    n = x.shape[0]
    out = x.new_empty((n, width))
    full = n - n % rows
    for i in range(0, full, rows):
        fn(x[i:i + rows], out[i:i + rows])
    if full < n:
        tail = x.new_full((rows,) + tuple(x.shape[1:]), pad)
        tail[:n - full] = x[full:]
        out[full:] = fn(tail, x.new_empty((rows, width)))[:n - full]
    return out


# Rows a call of the f32 MLP's input-gradient products (``mlp_apply``'s backward).
# On a CUDA tensor cuBLAS picks the kernel of ``g @ w.T`` by the row count, and with
# it the order of each row's sum: a point's cotangent at the hash features had other
# bits in a mesh rank's 1,048,576 points than in the window's 2,097,152. The blocks
# are one shape a call, the last padded with zeros.
MLP_GRAD_ROWS = 65536


class _RowBlockedProduct(torch.autograd.Function):
    """``x @ w``, with its input gradient ``g @ w.T`` in blocks of MLP_GRAD_ROWS
    rows and its weight gradient ``x.T @ g`` as one product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            wt = w.t()
            gx = in_row_blocks(lambda b, o: torch.matmul(b, wt, out=o), g, MLP_GRAD_ROWS,
                               w.shape[0])
        if ctx.needs_input_grad[1]:
            gw = x.t() @ g
        return gx, gw


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP in f32, biases where the params have them (the JAX package's
    ``_apply_mlp`` at ``compute_dtype`` float32). A point's gradient has the same
    bits whatever else its batch holds: each input-gradient product that sums
    terms (more than one output column) runs in blocks of MLP_GRAD_ROWS rows."""
    n = sum(1 for k in params if k.startswith("w"))
    h = x
    for i in range(n):
        w = params[f"w{i}"]
        h = _RowBlockedProduct.apply(h, w) if w.shape[1] > 1 else h @ w
        if f"b{i}" in params:
            h = h + params[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def sigma_mlp_engages(mlp: Dict[str, torch.Tensor], cfg: FieldConfig,
                      device: torch.device) -> bool:
    """Whether the hash head's f32 MLP on ``device`` takes the kernel pair of
    ``ops/sigma_mlp.py``: on a CUDA device under ``sigma_kernel: fused``, for a
    hash encoding in float32, with one hidden ReLU layer and one output column
    and no biases (upstream's default_nerf_hash.yaml). Such a head whose widths
    the kernels do not take raises there (``sigma_mlp.check_operands``) rather
    than falling back. Heads of another function (biases, more layers or
    outputs), ``sigma_kernel: plain`` and the CPU keep ``mlp_apply``."""
    if (device.type != "cuda" or cfg.sigma_kernel != "fused" or cfg.encoding_sigma != "hash"
            or cfg.compute_dtype != torch.float32 or set(mlp) != {"w0", "w1"}):
        return False
    w0, w1 = mlp["w0"], mlp["w1"]
    return w0.dim() == 2 and tuple(w1.shape) == (w0.shape[-1], 1)


def hash_sigma_mlp(mlp: Dict[str, torch.Tensor], feats: torch.Tensor,
                   cfg: FieldConfig) -> torch.Tensor:
    """The hash head's f32 MLP on (N, D) features: the kernel pair where
    ``sigma_mlp_engages`` (raising on widths it does not take), else
    ``mlp_apply``."""
    if sigma_mlp_engages(mlp, cfg, feats.device):
        return sigma_mlp_ops.sigma_mlp(mlp, feats)
    return mlp_apply(mlp, feats)


def query_sigma(params: Dict[str, Any], pos: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """Density head. pos: (N, 3) in [-1, 1]. Returns (N, 1) raw sigma (f32). A
    hash head's ``table_sum`` beside its ``table`` (a ``FixedPointSum``, here and
    in ``query_intensity``) takes the table's gradient in fixed point."""
    if cfg.sigma_kernel not in ("fused", "plain"):
        raise ValueError(f"sigma_kernel must be 'fused' or 'plain', got {cfg.sigma_kernel!r}")
    pos01 = (pos + 1.0) * 0.5
    if cfg.encoding_sigma != "fourier":
        feats = hash_encode(params["sigma"]["table"], pos01, cfg.pos_encoding_sigma,
                            cfg.hash_encode_dtype, plain=cfg.sigma_kernel == "plain",
                            sink=params["sigma"].get("table_sum"))
        if cfg.compute_dtype == torch.float32:  # both of the JAX package's MLP backwards
            return hash_sigma_mlp(params["sigma"]["mlp"], feats, cfg)
        return field_mlp(params["sigma"]["mlp"], feats, cfg)
    if cfg.fused_fourier:
        return fourier_sigma_fused(
            params["sigma"]["mlp"],
            pos01,
            fourier_bmat(cfg.fourier_sigma, pos.device),
            compute_dtype=cfg.compute_dtype,
            plain=cfg.sigma_kernel == "plain",
        )
    return field_mlp(params["sigma"]["mlp"], encode_fourier(pos01, cfg.fourier_sigma, cfg), cfg)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round float32 values to ``dtype`` and hold them in float32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


class _MLPFunction(torch.autograd.Function):
    """The JAX package's ``mlp_apply_vjp`` in ``dtype`` for a ReLU MLP, with
    biases or without: the input, weights, hidden products, biases and hidden
    activations rounded to ``dtype``, the last layer in f32; backward with
    cotangents rounded to ``dtype`` (the ReLU mask from the saved activations)
    and f32 weight and bias gradients. Values are held in float32: a product of
    two bf16 values is exact there, so a float32 matmul is the bf16 product with
    f32 accumulation up to the order of summation. In float32 it is plain
    autograd's arithmetic."""

    @staticmethod
    def forward(ctx, x, dtype, n, *wbs):
        ws, bs = wbs[:n], wbs[n:]
        h = _round(x, dtype)
        acts = [h]
        for i, w in enumerate(ws):
            h = h @ _round(w, dtype)
            if i < n - 1:
                h = _round(h, dtype)
                if bs:
                    h = _round(h + _round(bs[i], dtype), dtype)
                h = torch.relu(h)
                acts.append(h)
            elif bs:
                h = h + bs[i]
        ctx.save_for_backward(*acts, *ws)
        ctx.dtype, ctx.bias = dtype, bool(bs)
        return h

    @staticmethod
    def backward(ctx, g):
        dtype = ctx.dtype
        saved = ctx.saved_tensors
        n = len(saved) // 2
        acts, ws = saved[:n], saved[n:]
        dws: List[Optional[torch.Tensor]] = [None] * n
        dbs: List[Optional[torch.Tensor]] = [None] * n if ctx.bias else []
        gz = gh = _round(g, dtype)
        for i in range(n - 1, -1, -1):
            dws[i] = acts[i].t() @ gz
            if ctx.bias:
                dbs[i] = gz.sum(dim=0)
            gh = _round(gz @ _round(ws[i], dtype).t(), dtype)
            if i > 0:
                gz = torch.where(acts[i] > 0, gh, torch.zeros((), dtype=gh.dtype, device=gh.device))
        return (gh, None, None, *dws, *dbs)


def _layers(params: Dict[str, torch.Tensor]) -> tuple:
    """The MLP's weights in order, and its biases (none if it has none)."""
    n = sum(1 for k in params if k.startswith("w"))
    ws = [params[f"w{i}"] for i in range(n)]
    bs = [params[f"b{i}"] for i in range(n)] if "b0" in params else []
    return ws, bs


def mlp_apply_vjp(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """ReLU MLP in ``dtype`` with the JAX package's custom VJP
    (``_MLPFunction``). Returns the last layer in f32."""
    ws, bs = _layers(params)
    return _MLPFunction.apply(x, dtype, len(ws), *ws, *bs)


def mlp_apply_autograd(params: Dict[str, torch.Tensor], x: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's ``_apply_mlp`` under ``mlp_grad: xla``: the ReLU MLP on
    ``dtype`` tensors (the hidden products and activations written in
    ``dtype``, the last product of ``dtype`` values in f32) and autograd's
    backward through them, whose weight gradients are products in ``dtype`` too.
    Returns the last layer in f32."""
    ws, bs = _layers(params)
    h = x.to(dtype)
    for i, w in enumerate(ws):
        last = i == len(ws) - 1
        h = h.float() @ w.to(dtype).float() if last else h @ w.to(dtype)
        if bs:
            h = h + bs[i].to(h.dtype)
        if not last:
            h = torch.relu(h)
    return h


def field_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: "FieldConfig") -> torch.Tensor:
    """The JAX package's ``_mlp``: the custom VJP (``mlp_apply_vjp``), or under
    ``mlp_grad: xla`` in a compute dtype other than f32 plain autograd
    (``mlp_apply_autograd``); in f32 the two are one function."""
    if cfg.mlp_grad == "xla" and cfg.compute_dtype != torch.float32:
        return mlp_apply_autograd(params, x, cfg.compute_dtype)
    return mlp_apply_vjp(params, x, cfg.compute_dtype)


def _fourier_proj(pos01: torch.Tensor, bmat: torch.Tensor) -> torch.Tensor:
    # Three rounded products and two rounded sums, in the fused kernel's order.
    return pos01[:, 0:1] * bmat[0] + pos01[:, 1:2] * bmat[1] + pos01[:, 2:3] * bmat[2]


class _FourierEncodeFunction(torch.autograd.Function):
    """The JAX package's ``fourier_encode_vjp``: sin/cos of the f32 phase,
    emitted and saved in ``dtype``; backward dproj = g_sin cos - g_cos sin in
    ``dtype``, dpos = dproj B^T (f32 accumulation) + g_pts."""

    @staticmethod
    def forward(ctx, pos01, bmat, dtype, include_input):
        proj = _fourier_proj(pos01, bmat)
        feats = [_round(torch.sin(proj), dtype), _round(torch.cos(proj), dtype)]
        if include_input:
            feats.append(_round(pos01, dtype))
        out = torch.cat(feats, dim=-1)
        ctx.save_for_backward(out, bmat)
        ctx.meta = (dtype, include_input)
        return out

    @staticmethod
    def backward(ctx, g):
        out, bmat = ctx.saved_tensors
        dtype, include_input = ctx.meta
        f = bmat.shape[1]
        g = _round(g, dtype)
        dproj = _round(_round(g[:, :f] * out[:, f:2 * f], dtype)
                       - _round(g[:, f:2 * f] * out[:, :f], dtype), dtype)
        dpos = dproj @ _round(bmat, dtype).t()
        if include_input:
            dpos = dpos + g[:, 2 * f:]
        return dpos, None, None, None


def fourier_encode(pos01: torch.Tensor, cfg: FourierConfig, dtype: torch.dtype) -> torch.Tensor:
    """(N, 3) in [0, 1] -> (N, 2F [+3]) Fourier features in ``dtype``, with the
    JAX package's custom VJP (``fourier_encode_vjp``)."""
    return _FourierEncodeFunction.apply(pos01, fourier_bmat(cfg, pos01.device), dtype,
                                        cfg.include_input)


def fourier_encode_autograd(pos01: torch.Tensor, cfg: FourierConfig) -> torch.Tensor:
    """The JAX package's ``fourier_encode`` (``encode_impl: xla``): f32 features
    and plain autograd."""
    proj = _fourier_proj(pos01, fourier_bmat(cfg, pos01.device))
    feats = [torch.sin(proj), torch.cos(proj)] + ([pos01] if cfg.include_input else [])
    return torch.cat(feats, dim=-1)


def encode_fourier(pos01: torch.Tensor, fcfg: FourierConfig, cfg: "FieldConfig") -> torch.Tensor:
    """A Fourier head's features by its ``encode_impl``."""
    if fcfg.encode_impl == "xla":
        return fourier_encode_autograd(pos01, fcfg)
    return fourier_encode(pos01, fcfg, cfg.compute_dtype)


def query_intensity(params: Dict[str, Any], pos: torch.Tensor, dirs: torch.Tensor,
                    cfg: FieldConfig) -> torch.Tensor:
    """Intensity head. pos, dirs: (N, 3) in [-1, 1]. Returns (N, C) colours in
    (0, 1). The hash table is encoded in the training encode's dtype when the
    sigma head is a hash grid too (the JAX package passes its training encode
    to both tables then), else in f32 (its plain ``hash_encode``)."""
    pos01 = (pos + 1.0) * 0.5
    if cfg.encoding_intensity == "fourier":
        h_x = encode_fourier(pos01, cfg.fourier_intensity, cfg)
    else:
        dtype = cfg.hash_encode_dtype if cfg.encoding_sigma != "fourier" else torch.float32
        h_x = hash_encode(params["intensity"]["table"], pos01, cfg.pos_encoding_intensity,
                          dtype, plain=cfg.sigma_kernel == "plain",
                          sink=params["intensity"].get("table_sum"))
    if cfg.enable_view_dependence:
        h_d = sh_encode((dirs + 1.0) * 0.5, cfg.sh_degree)
        h_x = torch.cat([h_x, h_d], dim=-1)
    return torch.sigmoid(field_mlp(params["intensity"]["mlp"], h_x, cfg))


def query_field(params: Dict[str, Any], pos: torch.Tensor, dirs: Optional[torch.Tensor],
                cfg: FieldConfig, sigma_only: bool = False,
                detach_sigma: bool = True) -> torch.Tensor:
    """Field query. pos, dirs: (N, 3) in [-1, 1] (dirs: unit view directions).
    Returns (N, 1) raw sigma if ``sigma_only``, else (N, C + 1) [colour.., sigma];
    sigma's NaN/inf clamped to the compute dtype's range. ``detach_sigma`` (with
    colours) stops gradients into the sigma parameters."""
    sigma_params = params
    if detach_sigma and not sigma_only:
        sigma_params = {"sigma": {"mlp": {k: v.detach() for k, v in params["sigma"]["mlp"].items()},
                                  **({"table": params["sigma"]["table"].detach()}
                                     if "table" in params["sigma"] else {})}}
    sigma = query_sigma(sigma_params, pos, cfg)
    finfo = torch.finfo(cfg.compute_dtype)
    sigma = torch.nan_to_num(sigma, posinf=finfo.max, neginf=finfo.min)
    if sigma_only:
        return sigma
    return torch.cat([query_intensity(params, pos, dirs, cfg), sigma], dim=-1)
