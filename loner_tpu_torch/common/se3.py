"""SO(3)/SE(3) math in PyTorch.

Counterpart of ``loner_tpu/common/se3.py``. All functions are batch-friendly
(leading dims broadcast) and autograd-safe: the masked Taylor branches keep NaN
gradients away from the identity rotation.

Pose convention: a twist is ``[t_x, t_y, t_z, r_x, r_y, r_z]``, the raw
translation and an axis-angle rotation vector (not the se(3) exponential
coordinates).
"""
from __future__ import annotations

import torch

_SMALL = 1e-8


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    # Made on the device (no host-to-device copy, which would synchronise).
    row = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return row.expand(top.shape[:-2] + (1, 4))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3). Grad-safe at 0."""
    theta2 = torch.sum(aa * aa, dim=-1)[..., None, None]
    small = theta2 < _SMALL
    # Masked sqrt so the gradient of sqrt at 0 never appears in either branch.
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    k = skew(aa)
    # k @ k == v v^T - (v.v) I in closed form.
    vvt = aa[..., :, None] * aa[..., None, :]
    eye = _eye_like(aa, k.shape)
    k2 = vvt - theta2 * eye
    return eye + a * k + b * k2


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit quaternion [w, x, y, z], branchless
    (Shepperd's method: all four candidates, the best one selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    keys = [m00 + m11 + m22, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22]
    raws = [
        torch.stack([1.0 + keys[0], m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + keys[1], m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + keys[2], m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + keys[3]], dim=-1),
    ]
    scaled = []
    for raw, key in zip(raws, keys):
        d = torch.clamp(1.0 + key, min=1e-12)[..., None]
        scaled.append(raw / (2.0 * torch.sqrt(d)))
    idx = torch.argmax(torch.stack(keys, dim=-1), dim=-1)
    stacked = torch.stack(scaled, dim=-2)  # (..., candidate, 4)
    gather_idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(stacked, -2, gather_idx)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w,x,y,z] -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w,x,y,z] -> (..., 3) axis-angle."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < _SMALL
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    angle = 2.0 * torch.atan2(vn[..., 0], w)[..., None]
    # For small |v|, angle/|v| -> 2/w (Taylor).
    scale = torch.where(small, 2.0 / torch.clamp(w[..., None], min=1e-6), angle / vn)
    return v * scale


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) [w,x,y,z]."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < _SMALL
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, aa * sinc_half], dim=-1)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def twist_to_matrix(twist: torch.Tensor) -> torch.Tensor:
    """[t(3), axis-angle(3)] (..., 6) -> (..., 4, 4) homogeneous transform."""
    rot = axis_angle_to_matrix(twist[..., 3:])
    top = torch.cat([rot, twist[..., :3, None]], dim=-1)  # (..., 3, 4)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def matrix_to_twist(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [t, axis-angle]."""
    return torch.cat([m[..., :3, 3], matrix_to_axis_angle(m[..., :3, :3])], dim=-1)


def transform_inverse(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    r_inv = m[..., :3, :3].transpose(-1, -2)
    top = torch.cat([r_inv, -r_inv @ m[..., :3, 3:]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) (or batched) transform to (..., 3) points."""
    return pts @ m[..., :3, :3].transpose(-1, -2) + m[..., :3, 3]


def interpolate_transforms(
    t_start: torch.Tensor, t_end: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """Pose interpolation: lerp translation, slerp rotation in the relative
    frame R_start @ exp(alpha * log(R_start^T R_end)).

    t_start, t_end: (4, 4); alpha: (N,). Returns (N, 4, 4).
    """
    alpha = alpha[..., None]
    trans = t_start[:3, 3] + (t_end[:3, 3] - t_start[:3, 3]) * alpha
    r_start = t_start[:3, :3]
    rel_aa = matrix_to_axis_angle(r_start.T @ t_end[:3, :3])
    rots = r_start @ axis_angle_to_matrix(rel_aa * alpha)
    top = torch.cat([rots, trans[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


# ---------------------------------------------------------------------------
# 3x3 linear algebra without host synchronisation
# ---------------------------------------------------------------------------
# torch.linalg.svd and torch.linalg.eigh check their error codes on the host,
# which synchronises a CUDA device with the CPU. The tracker's ICP runs many of
# these small problems inside one pipelined dispatch, so it takes the closed
# forms below instead: elementwise ops, any batch shape, no host round trip.

_POLAR_ITERS = 8


def det3(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (...) determinant."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _cofactor3(m: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix, det(m) * m^-T: rows r1 x r2, r2 x r0, r0 x r1."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)], dim=-2)


def symmetric3_smallest_eigvec(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    matrices, as ``torch.linalg.eigh(a)[1][..., 0]`` up to sign.

    The eigenvalue comes from the trigonometric closed form; the vector is the
    longest cross product of two rows of ``a - lambda I``. Where those rows
    span one line only (a double smallest eigenvalue), any vector orthogonal to
    it is an eigenvector; where ``a`` is a multiple of I, every vector is, and
    ``[1, 0, 0]`` is returned, as eigh does. Use float64 for accuracy."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * (a01 ** 2 + a02 ** 2 + a12 ** 2)
    p = torch.sqrt(p2 / 6.0)
    p_safe = torch.where(p > 0, p, torch.ones_like(p))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / p_safe[..., None, None]
    r = torch.clamp(det3(b) / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)

    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = torch.linalg.norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1, keepdim=True)
    v = torch.gather(cands, -2, best[..., None].expand(best.shape + (3,)))[..., 0, :]
    v_norm = torch.gather(norms, -1, best)

    # Rank <= 1: a vector orthogonal to the longest row, built with the axis
    # least aligned with it.
    row_norms = torch.linalg.norm(m, dim=-1)
    top = torch.argmax(row_norms, dim=-1, keepdim=True)
    row = torch.gather(m, -2, top[..., None].expand(top.shape + (3,)))[..., 0, :]
    axis = torch.nn.functional.one_hot(torch.argmin(row.abs(), dim=-1), 3).to(a.dtype)
    ortho = torch.linalg.cross(row, axis)
    row_max = torch.gather(row_norms, -1, top)
    rank2 = v_norm > 1e-10 * row_max ** 2
    v = torch.where(rank2, v / torch.where(rank2, v_norm, torch.ones_like(v_norm)),
                    ortho / torch.linalg.norm(ortho, dim=-1, keepdim=True).clamp_min(1e-300))
    scalar = row_max <= 1e-12 * torch.clamp(q.abs()[..., None], min=1e-300)
    return torch.where(scalar | (row_max == 0), eye[0].expand(v.shape), v)


def orthonormalize_transform(t_mat: torch.Tensor) -> torch.Tensor:
    """Nearest SE(3) element (Frobenius): the rotation block projected onto
    SO(3) as ``U diag(1, 1, det(U V^T)) V^T`` of its SVD, the translation kept.

    Counterpart of ``loner_tpu/tracking/icp.py::orthonormalize_transform``,
    without an SVD: the scaled Newton iteration ``X <- (g X + X^-T / g) / 2``
    converges to the orthogonal polar factor ``U V^T``; where that has
    determinant -1, the reflection along the right singular vector of the
    smallest singular value turns it into the rotation. Computed in float64,
    returned in the input's dtype. (..., 4, 4) -> (..., 4, 4)."""
    r = t_mat[..., :3, :3].to(torch.float64)
    x = r
    for _ in range(_POLAR_ITERS):
        x_inv_t = _cofactor3(x) / det3(x)[..., None, None]
        g = torch.sqrt(torch.linalg.norm(x_inv_t, dim=(-2, -1))
                       / torch.linalg.norm(x, dim=(-2, -1)))[..., None, None]
        x = 0.5 * (g * x + x_inv_t / g)
    v = symmetric3_smallest_eigvec(r.transpose(-1, -2) @ r)
    flipped = x - 2.0 * (x @ v[..., :, None]) * v[..., None, :]
    rot = torch.where((det3(x) < 0)[..., None, None], flipped, x).to(t_mat.dtype)
    top = torch.cat([rot, t_mat[..., :3, 3:]], dim=-1)
    return torch.cat([top, t_mat[..., 3:, :]], dim=-2)
