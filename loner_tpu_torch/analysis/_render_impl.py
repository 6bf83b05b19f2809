"""Chunk renderer shared by the offline analysis tools.

Counterpart of ``loner_tpu/analysis/_render_impl.py``. PyTorch runs eagerly, so
there is no executable to cache: the sampler and the render options are built
once per (model, options) and cached on the loaded model instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from loner_tpu_torch.models.rendering import make_sampler, render_rays


def get_chunk_renderer(
    model,
    n_samples: int,
    ret_var: bool,
    use_occ: bool,
    sigma_only: bool = True,
    ret_peak: bool = False,
):
    """A (rays, field_params, occ) -> outputs function, cached on the
    LoadedModel; call it under ``torch.inference_mode()``. ``ret_peak`` adds
    per-ray peak-depth consistency |z at argmax(w) - depth|, computed on the
    device. ``sigma_only=False`` also composites the intensity head's colour
    (``rgb``), through ``raw2outputs``: the fused compositor is sigma-only."""
    key = (n_samples, ret_var, use_occ, sigma_only, ret_peak)
    cache = model.render_cache
    if key in cache:
        return cache[key]

    sampler = make_sampler(model.occ_grid if use_occ else None,
                           n_ctrl=trained_n_ctrl(model.settings))
    field_cfg = model.field_cfg
    compositor = model.compositor

    def render_chunk(rays, field_params, occ):
        out = render_rays(
            rays, field_params, field_cfg, sampler, n_samples, perturb=0.0,
            occ_state=occ, ret_var=ret_var, compositor=compositor, sigma_only=sigma_only,
        )
        if ret_peak:
            idx = torch.argmax(out["weights"], dim=-1, keepdim=True)
            z_peak = torch.gather(out["z_vals"], 1, idx)[:, 0]
            out["peak_depth_consistency"] = torch.abs(z_peak - out["depth"])
        return out

    cache[key] = render_chunk
    return render_chunk


def configured_compositor(settings) -> str:
    """Test-render compositor choice (model_config.model.render.compositor:
    xla | pallas). "pallas" takes the fused compositor (ops/composite.py);
    "xla" is the default."""
    try:
        render = settings.mapper.optimizer.model_config.model.render
        return str(dict(render).get("compositor", "xla"))
    except (AttributeError, KeyError, TypeError, ValueError):
        return "xla"


def trained_n_ctrl(settings) -> Optional[int]:
    """The proposal control resolution the model was trained with
    (mapper.optimizer.model_config.model.occ_model.prop_n_ctrl)."""
    try:
        occ = settings.mapper.optimizer.model_config.model.occ_model
        return int(dict(occ).get("prop_n_ctrl", 0)) or None
    except (AttributeError, KeyError, TypeError, ValueError):
        return None
