"""The neural scene field, Fourier sigma branch.

Counterpart of ``loner_tpu/models/field.py``. The field is a function of a
parameter dict; freezing a head is a gradient mask in the optimizer. Inputs
arrive in [-1, 1]^3 (world cube) and are mapped to [0, 1].

The sigma head is the fused Fourier-feature + MLP function of
``ops/fourier_mlp.py`` (the JAX package's ``sigma_kernel: pallas`` path): the
hand-written CUDA kernels on CUDA tensors, their plain version on the CPU.
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

from loner_tpu_torch.ops.fourier_mlp import fourier_sigma_fused

BMAT_FIXTURE = Path(__file__).resolve().parent / "fourier_bmats.npz"


@dataclass(frozen=True)
class HashEncodingConfig:
    """Hash-grid encoding settings (config only: the hash field is not ported)."""

    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 18
    base_resolution: int = 16
    per_level_scale: float = 2.0

    @staticmethod
    def from_settings(cfg: dict) -> "HashEncodingConfig":
        return HashEncodingConfig(
            n_levels=int(cfg.get("n_levels", 16)),
            n_features_per_level=int(cfg.get("n_features_per_level", 2)),
            log2_hashmap_size=int(cfg.get("log2_hashmap_size", 18)),
            base_resolution=int(cfg.get("base_resolution", 16)),
            per_level_scale=float(cfg.get("per_level_scale", 2.0)),
        )

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def total_table_size(self) -> int:
        res = np.floor(
            self.base_resolution * self.per_level_scale ** np.arange(self.n_levels)
        ).astype(np.int64)
        return int(np.minimum((res + 1) ** 3, 2 ** self.log2_hashmap_size).sum())


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
    encoding_sigma: str = "hash"  # the port has "fourier" only
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

    @property
    def sigma_input_dim(self) -> int:
        return self.fourier_sigma.output_dim

    @property
    def intensity_pos_dim(self) -> int:
        if self.encoding_intensity == "fourier":
            return self.fourier_intensity.output_dim
        return self.pos_encoding_intensity.output_dim

    @staticmethod
    def from_settings(nerf_cfg: dict, num_colors: int = 3,
                      compute_dtype: torch.dtype = torch.float32) -> "FieldConfig":
        """Build from the nerf config dict (cfg/nerf_config/*.yaml). The JAX
        package's ``sigma_kernel`` choice does not apply: the port has one
        sigma path."""
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
    """{"sigma": {"mlp": ...}, "intensity": {"mlp": ..., ["table": ...]}}."""
    if cfg.encoding_sigma != "fourier":
        raise NotImplementedError("the port has the Fourier sigma field only")
    intensity_in = cfg.intensity_pos_dim + (
        cfg.sh_degree ** 2 if cfg.enable_view_dependence else 0
    )
    intensity: Dict[str, Any] = {
        "mlp": _init_mlp(generator, intensity_in, cfg.intensity_mlp, False, device)
    }
    if cfg.encoding_intensity != "fourier":
        size = (cfg.pos_encoding_intensity.total_table_size,
                cfg.pos_encoding_intensity.n_features_per_level)
        u = torch.rand(size, generator=generator, device=device)
        intensity["table"] = u * 2e-4 - 1e-4
    return {
        "sigma": {"mlp": _init_mlp(generator, cfg.sigma_input_dim, cfg.sigma_mlp,
                                   cfg.sigma_mlp_bias, device)},
        "intensity": intensity,
    }


def query_sigma(params: Dict[str, Any], pos: torch.Tensor, cfg: FieldConfig) -> torch.Tensor:
    """Density head. pos: (N, 3) in [-1, 1]. Returns (N, 1) raw sigma (f32)."""
    if cfg.encoding_sigma != "fourier" or not cfg.fourier_sigma.include_input:
        raise NotImplementedError(
            "the port's sigma head is the fused Fourier MLP with include_input"
        )
    if cfg.sigma_kernel not in ("fused", "plain"):
        raise ValueError(f"sigma_kernel must be 'fused' or 'plain', got {cfg.sigma_kernel!r}")
    pos01 = (pos + 1.0) * 0.5
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
