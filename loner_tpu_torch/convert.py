"""Convert parameters between the JAX package's numpy trees and the port's.

The JAX package's params are nested dicts of arrays (``np.asarray`` of each
leaf gives the numpy form, which is what its checkpoints hold). The port keeps
the same nesting and names, as float32 torch tensors on a device:

  field:    {"sigma": {"mlp": {w0, b0, ...}, ["table"]}, "intensity": {"mlp": {...}, ["table"]}}
  proposal: {"bmat", "w0", "w1", ...}
  OGM grid: (V, V, V) logits
  twists:   (W, 6)

``*_from_jax`` go from numpy trees to the port; ``*_to_jax`` go back, to numpy
trees a JAX-package checkpoint holds.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)


def _tree(d: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: _tree(v, device) if isinstance(v, dict) else _tensor(v, device)
            for k, v in d.items()}


def field_params_from_jax(params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Field params: the sigma head (MLP and, for the hash field, its table) and the
    intensity head (MLP and hash table)."""
    if set(params) != {"sigma", "intensity"} or "mlp" not in params["sigma"]:
        raise ValueError(f"not a field param tree: top-level keys {sorted(params)}")
    return _tree(params, device)


def proposal_params_from_jax(params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Proposal params: ``bmat`` and the weights ``w0 .. wL``."""
    if "bmat" not in params or "w0" not in params:
        raise ValueError(f"not a proposal param tree: keys {sorted(params)}")
    return _tree(params, device)


def occ_grid_from_jax(grid, device: torch.device) -> torch.Tensor:
    """The OGM logit grid: a (V, V, V) array."""
    t = _tensor(grid, device)
    if t.dim() != 3 or len(set(t.shape)) != 1:
        raise ValueError(f"an occupancy grid is (V, V, V), got {tuple(t.shape)}")
    return t


def occ_state_from_jax(state, device: torch.device):
    """A checkpoint's ``occ_model_state_dict``: proposal params (a dict) or the
    OGM grid (an array)."""
    if isinstance(state, dict):
        return proposal_params_from_jax(state, device)
    return occ_grid_from_jax(state, device)


def twists_from_jax(twists, device: torch.device) -> torch.Tensor:
    t = _tensor(twists, device)
    if t.dim() != 2 or t.shape[1] != 6:
        raise ValueError(f"twists must be (W, 6), got {tuple(t.shape)}")
    return t


def tree_to_numpy(tree):
    """Nested dicts (and lists) of tensors -> the same nesting of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()  # a copy: never aliases a live param
    return tree


def field_params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's field params as the JAX package's numpy tree."""
    if set(params) != {"sigma", "intensity"} or "mlp" not in params["sigma"]:
        raise ValueError(f"not a field param tree: top-level keys {sorted(params)}")
    return tree_to_numpy(params)


def proposal_params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's proposal params as the JAX package's numpy tree."""
    if "bmat" not in params or "w0" not in params:
        raise ValueError(f"not a proposal param tree: keys {sorted(params)}")
    return tree_to_numpy(params)


def occ_grid_to_jax(grid: torch.Tensor) -> np.ndarray:
    """The port's OGM grid as the JAX package's (V, V, V) f32 array."""
    if grid.dim() != 3 or len(set(grid.shape)) != 1:
        raise ValueError(f"an occupancy grid is (V, V, V), got {tuple(grid.shape)}")
    return tree_to_numpy(grid)
