"""Real spherical-harmonics direction encoding (degree <= 4).

Counterpart of ``loner_tpu/models/sh_encoding.py``: the intensity head's view
encoding. Directions arrive in [0, 1]^3 and are mapped back to [-1, 1]; the
polynomials are the hard-coded expansion of tiny-cuda-nn / instant-ngp, in the
JAX package's order of operations.
"""
from __future__ import annotations

import torch


def sh_encode(dirs01: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """(N, 3) directions in [0, 1] -> (N, degree^2) SH basis values."""
    if not 1 <= degree <= 4:
        raise ValueError(f"degree must be in [1, 4], got {degree}")
    d = dirs01 * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)
