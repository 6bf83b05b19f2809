"""Convert the JAX package's parameters, given as numpy arrays, to the port's.

The JAX package's params are nested dicts of arrays (``np.asarray`` of each
leaf gives the numpy form). The port keeps the same nesting and names, as
float32 torch tensors on a device:

  field:    {"sigma": {"mlp": {w0, b0, ...}}, "intensity": {"mlp": {...}, ["table"]}}
  proposal: {"bmat", "w0", "w1", ...}
  twists:   (W, 6)
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
    """Field params: the sigma MLP and the intensity head (MLP and hash table)."""
    if set(params) != {"sigma", "intensity"} or "mlp" not in params["sigma"]:
        raise ValueError(f"not a field param tree: top-level keys {sorted(params)}")
    if "table" in params["sigma"]:
        raise NotImplementedError("the hash sigma field is not ported")
    return _tree(params, device)


def proposal_params_from_jax(params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Proposal params: ``bmat`` and the weights ``w0 .. wL``."""
    if "bmat" not in params or "w0" not in params:
        raise ValueError(f"not a proposal param tree: keys {sorted(params)}")
    return _tree(params, device)


def twists_from_jax(twists, device: torch.device) -> torch.Tensor:
    t = _tensor(twists, device)
    if t.dim() != 2 or t.shape[1] != 6:
        raise ValueError(f"twists must be (W, 6), got {tuple(t.shape)}")
    return t
