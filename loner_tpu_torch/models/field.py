"""The neural scene field: the sigma head, hash-grid or Fourier.

Counterpart of ``loner_tpu/models/field.py``. The field is a function of a
parameter dict; freezing a head is a gradient mask in the optimizer. Inputs
arrive in [-1, 1]^3 (world cube) and are mapped to [0, 1].

Two sigma heads:
- ``hash`` (the reference's, cfg/nerf_config/default_nerf_hash.yaml): the
  multiresolution hash encoding of ``models/hash_encoding.py`` (the hand-written
  CUDA kernel pair on CUDA tensors, its plain version on the CPU) feeding a
  bias-free ReLU MLP of plain ``torch`` matmuls, as the JAX package computes it
  outside any kernel;
- ``fourier``: the fused Fourier-feature + MLP function of
  ``ops/fourier_mlp.py`` (the JAX package's ``sigma_kernel: pallas`` path).
The intensity parameters are initialised and carried, not used: the camera
branch is not ported yet.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from loner_tpu_torch.models.hash_encoding import HashEncodingConfig, hash_encode, init_hash_table
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

    @property
    def output_dim(self) -> int:
        return 2 * self.n_freqs + (3 if self.include_input else 0)

    @staticmethod
    def from_settings(cfg: dict) -> "FourierConfig":
        return FourierConfig(
            n_freqs=int(cfg.get("n_freqs", 64)),
            scale=float(cfg.get("scale", 6.0)),
            include_input=bool(cfg.get("include_input", True)),
            seed=int(cfg.get("seed", 1234)),
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

    @staticmethod
    def from_settings(nerf_cfg: dict, num_colors: int = 3,
                      compute_dtype: torch.dtype = torch.float32) -> "FieldConfig":
        """Build from the nerf config dict (cfg/nerf_config/*.yaml). The JAX
        package's ``sigma_kernel`` choice does not apply: the port has one path
        for each sigma head."""
        encoding = str(nerf_cfg.get("encoding_sigma", "hash"))
        if encoding not in ("hash", "fourier"):
            raise ValueError(f"unknown encoding_sigma {encoding!r}")
        encoding_intensity = str(nerf_cfg.get("encoding_intensity", "hash"))
        if encoding_intensity not in ("hash", "fourier"):
            raise ValueError(f"unknown encoding_intensity {encoding_intensity!r}")
        sigma_net = nerf_cfg["sigma_network"]
        if "compute_dtype" in nerf_cfg:
            compute_dtype = torch.bfloat16 if "bf" in str(nerf_cfg["compute_dtype"]) else torch.float32
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


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP in f32, biases where the params have them (the JAX package's
    ``_apply_mlp`` at ``compute_dtype`` float32)."""
    n = sum(1 for k in params if k.startswith("w"))
    h = x
    for i in range(n):
        h = h @ params[f"w{i}"]
        if f"b{i}" in params:
            h = h + params[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def query_sigma(params: Dict[str, Any], pos: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """Density head. pos: (N, 3) in [-1, 1]. Returns (N, 1) raw sigma (f32)."""
    if cfg.sigma_kernel not in ("fused", "plain"):
        raise ValueError(f"sigma_kernel must be 'fused' or 'plain', got {cfg.sigma_kernel!r}")
    pos01 = (pos + 1.0) * 0.5
    if cfg.encoding_sigma != "fourier":
        if cfg.compute_dtype != torch.float32:
            raise NotImplementedError("the hash field's MLP runs in float32: no config in cfg/ "
                                      "sets another compute_dtype for it")
        feats = hash_encode(params["sigma"]["table"], pos01, cfg.pos_encoding_sigma,
                            cfg.hash_encode_dtype, plain=cfg.sigma_kernel == "plain")
        return mlp_apply(params["sigma"]["mlp"], feats)
    if not cfg.fourier_sigma.include_input:
        raise NotImplementedError("the port's Fourier sigma head is the fused MLP with "
                                  "include_input")
    return fourier_sigma_fused(
        params["sigma"]["mlp"],
        pos01,
        fourier_bmat(cfg.fourier_sigma, pos.device),
        compute_dtype=cfg.compute_dtype,
        plain=cfg.sigma_kernel == "plain",
    )


def query_field(params: Dict[str, Any], pos: torch.Tensor, dirs: Optional[torch.Tensor],
                cfg: FieldConfig, sigma_only: bool = False) -> torch.Tensor:
    """Field query. Only ``sigma_only=True`` is ported: returns (N, 1) raw
    sigma with NaN/inf clamped to the compute dtype's range."""
    if not sigma_only:
        raise NotImplementedError("the intensity head is not ported yet")
    sigma = query_sigma(params, pos, cfg)
    finfo = torch.finfo(cfg.compute_dtype)
    return torch.nan_to_num(sigma, posinf=finfo.max, neginf=finfo.min)
