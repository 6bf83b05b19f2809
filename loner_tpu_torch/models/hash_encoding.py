"""Multiresolution hash-grid encoding (Instant-NGP), the reference's sigma field.

Counterpart of ``loner_tpu/models/hash_encoding.py``:

  * L levels of 3D grids of resolution ``floor(base * scale^l)``;
  * a level whose (res + 1)^3 vertices fit ``2^log2_hashmap_size`` entries is
    indexed densely, a finer one by the xor-of-primes spatial hash;
  * F features per level, trilinearly interpolated at the 8 cell corners;
  * all levels' tables concatenated into one (T, F) f32 table.

Inputs are in [0, 1]^3 and clip. ``hash_encode`` is the hand-written kernel pair
of ``ops/hash_grid.py`` on a CUDA tensor and its plain version on a CPU tensor,
in f32 (every test render) or in the training encode's bf16.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from loner_tpu_torch.ops import hash_grid


@dataclass(frozen=True)
class HashEncodingConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 18
    base_resolution: int = 16
    per_level_scale: float = 2.0  # tcnn's HashGrid default growth factor

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

    def level_resolutions(self) -> np.ndarray:
        return np.floor(
            self.base_resolution * self.per_level_scale ** np.arange(self.n_levels)
        ).astype(np.int64)

    def level_dense(self) -> np.ndarray:
        """Levels indexed densely: (res + 1)^3 vertices fit the table."""
        return (self.level_resolutions() + 1) ** 3 <= 2 ** self.log2_hashmap_size

    def level_table_sizes(self) -> np.ndarray:
        """Entries per level: dense (res + 1)^3 when it fits, else 2^log2."""
        dense = (self.level_resolutions() + 1) ** 3
        return np.minimum(dense, 2 ** self.log2_hashmap_size).astype(np.int64)

    def level_offsets(self) -> np.ndarray:
        """Start offsets of each level inside the concatenated table (L + 1)."""
        return np.concatenate([[0], np.cumsum(self.level_table_sizes())])

    @property
    def total_table_size(self) -> int:
        return int(self.level_table_sizes().sum())


def init_hash_table(generator: torch.Generator, cfg: HashEncodingConfig,
                    device: torch.device) -> torch.Tensor:
    """(T, F) f32 table, uniform in [-1e-4, 1e-4] (tcnn's init)."""
    u = torch.rand((cfg.total_table_size, cfg.n_features_per_level), generator=generator,
                   device=device)
    return u * 2e-4 - 1e-4


# Corner indices (N, L, 8) int64 into the concatenated table and trilinear weights
# (N, L, 8) f32, corner 4 ix + 2 iy + iz: the plain version's geometry.
hash_corner_indices = hash_grid.corner_indices
# (table, pos01, cfg, dtype=float32, plain=False, sink=None) -> (N, L F) f32
# features: gathered and trilinearly summed in ``dtype`` (float32, the JAX
# package's ``hash_encode``; bfloat16, its ``hash_encode_vjp`` in bf16); the table
# gradient a fixed-point sum converted to f32 (or added to ``sink``), the
# closed-form position gradient.
hash_encode = hash_grid.hash_encode
