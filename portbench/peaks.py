"""The yardstick's peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the least time of a piece of work.

``bound_s`` is the larger of its operations over the peak of their type and its
bytes (each input read once, each output written once) over the HBM rate.
f32-accurate work either runs on the CUDA cores or as three TF32 products on the
tensor cores; its least time is the lesser of the two (``f32_bound_s``), so a
share stays at or below 100% whichever unit a kernel uses.
"""
from __future__ import annotations

import re
from typing import Callable, Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def f32_bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    t_cuda, t_tensor = flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS
    return bound_s(flops, nbytes, peak_flops=flops / min(t_cuda, t_tensor) if flops else 1.0)


def kernels(names: Iterable[str]) -> Callable[[str], bool]:
    """A matcher of device operations by whole kernel names: ``fwd_kernel``
    matches ``(anonymous namespace)::fwd_kernel<256>(...)`` and not
    ``hash_fwd_kernel``."""
    pattern = re.compile("|".join(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])"
                                  for n in names))
    return lambda name: pattern.search(name) is not None


def per_iteration_s(ctx: dict, names: Iterable[str]):
    """Device seconds per traced iteration of the kernels ``names`` (None
    without a trace or when none of them ran)."""
    tr = ctx.get("trace")
    if tr is None or not ctx.get("traced_iterations"):
        return None
    t = tr.device_s(kernels(names))
    return t / ctx["traced_iterations"] if t > 0 else None


def rank_points(ctx: dict) -> float:
    """Field points a traced rank evaluates an iteration: the window's, over
    the ranks of a mesh."""
    return ctx["points_per_iteration"] / ctx.get("chips", 1)
