"""Checkpoint files of the mapper.

Counterpart of the checkpoint part of ``loner_tpu/mapping/mapper.py``: a
checkpoint is a pickled dict of numpy arrays under the reference's ``.tar``
names, in ``Mapper.build_ckpt``'s schema, so either package reads what the
other wrote. The ``Mapper`` thread itself is not ported yet.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

from loner_tpu_torch.common.world_cube import WorldCube
from loner_tpu_torch.convert import (  # noqa: F401  (tree_to_numpy: the public name)
    field_params_to_jax,
    proposal_params_to_jax,
    tree_to_numpy,
)


def save_checkpoint(path: str, ckpt: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def build_ckpt(field_params: Dict[str, Any], occ_state: Optional[Dict[str, Any]],
               poses: List[dict], world_cube: WorldCube, global_step: int) -> dict:
    """A full checkpoint from the port's state. ``poses`` are keyframe pose
    states (``timestamp``, ``lidar_pose`` twist, ...); ``occ_state`` is the
    proposal params, or None for the uniform sampler."""
    ckpt = {
        "global_step": int(global_step),
        "network_state_dict": field_params_to_jax(field_params),
        "poses": poses,
        "world_cube": world_cube.as_dict(),
    }
    if occ_state is not None:
        ckpt["occ_model_state_dict"] = proposal_params_to_jax(occ_state)
    return ckpt
