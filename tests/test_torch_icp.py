"""The PyTorch port's ICP (loner_tpu_torch/tracking/icp.py) against the JAX
package's (loner_tpu/tracking/icp.py), on the CPU.

- ``pad_cloud``: bit-equal.
- ``orthonormalize_transform``: within 1e-6 of JAX's SVD projection.
- ``estimate_normals``: |dot| >= 1 - 1e-5 against JAX's on a tie-free cloud
  (random points on planar patches, so no two neighbour distances tie and
  every neighbourhood has one normal).
- ``registration_icp`` and ``run_icp_schedule``: box-room scans of 1500-5120
  points under a known motion; transform entries within 1e-4 (translation in
  m, rotation entries), fitness and inlier RMSE within 1e-5.
- The row-blocked distance path against the single tile, with the budgets
  made small; and the transform unchanged when the caller lowers the float32
  matmul precision (every ICP product runs in float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from loner_tpu.common.pose import Pose as JPose
from loner_tpu.datasets.synthetic import BoxRoomScene, VirtualLidar, make_scan
from loner_tpu.tracking import icp as jicp
from loner_tpu_torch.common import se3
from loner_tpu_torch.tracking import icp as ticp

torch.set_num_threads(1)

SCHEDULE = [{"threshold": 1.5, "max_iterations": 10}, {"threshold": 0.125, "max_iterations": 10}]
TRANSFORM_TOL = 1e-4
STAT_TOL = 1e-5


def _scan_pair(seed: int, n: int, noise: float = 0.003):
    """A box-room scan (target) and the same scan seen from a moved sensor
    with range noise (source); returns (source, target, true source->target)."""
    rng = np.random.default_rng(seed)
    mat = np.eye(4)
    mat[:3, :3] = Rotation.from_euler("z", rng.uniform(-np.pi, np.pi)).as_matrix()
    mat[:3, 3] = [rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5), 0.5]
    lidar = VirtualLidar(num_channels=32, num_columns=256, max_range=20.0)
    scan = make_scan(BoxRoomScene(), lidar, JPose(mat), t_start=0.0)
    tgt = (scan.ray_directions * scan.distances).T
    tgt = tgt[np.linspace(0, tgt.shape[0] - 1, min(n, tgt.shape[0])).astype(int)]
    t_true = np.eye(4)
    t_true[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.03, 3)).as_matrix()
    t_true[:3, 3] = rng.normal(0, 0.1, 3)
    inv = np.linalg.inv(t_true)
    src = tgt @ inv[:3, :3].T + inv[:3, 3] + rng.normal(0, noise, tgt.shape)
    return src.astype(np.float32), tgt.astype(np.float32), t_true


def _planar_patches(n: int, seed: int = 0) -> np.ndarray:
    """Random points on four separated planar patches (one tilted), with
    1 mm of noise: tie-free, and every 30-neighbourhood lies on one plane."""
    rng = np.random.default_rng(seed)
    per = n // 4
    u, v = rng.uniform(0, 3, (2, 4, per))
    patches = [
        np.stack([u[0], v[0], np.full(per, -2.0)], -1),
        np.stack([np.full(per, 8.0), u[1] - 6, v[1]], -1),
        np.stack([u[2] - 9, np.full(per, 6.0), v[2] - 1], -1),
        np.stack([u[3] + 2, v[3] - 4, 0.3 * u[3] + 0.2 * v[3] + 1], -1),
    ]
    pts = np.concatenate(patches)
    return (pts + rng.normal(0, 1e-3, pts.shape)).astype(np.float32)


def _check_result(res_t, res_j):
    np.testing.assert_allclose(res_t.transformation.numpy(), np.asarray(res_j.transformation),
                               atol=TRANSFORM_TOL)
    assert abs(float(res_t.fitness) - float(res_j.fitness)) <= STAT_TOL
    assert abs(float(res_t.inlier_rmse) - float(res_j.inlier_rmse)) <= STAT_TOL


@pytest.mark.parametrize("n,size", [(100, 128), (300, 128), (0, 16), (128, 128)])
def test_pad_cloud_is_bit_equal(n, size):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    out_t, valid_t = ticp.pad_cloud(pts, size)
    out_j, valid_j = jicp.pad_cloud(pts, size)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(valid_t, valid_j)


def test_orthonormalize_transform_matches_jax():
    rng = np.random.default_rng(0)
    for i in range(20):
        mat = np.eye(4, dtype=np.float32)
        rot = Rotation.from_rotvec(rng.normal(0, 1.0, 3)).as_matrix()
        # Inflated rotations, as composed float32 increments leave them, and
        # general matrices (one with det < 0).
        scale = 1e-3 if i < 10 else 0.3
        m = rot + rng.normal(0, scale, (3, 3))
        if i == 19:
            m = m @ np.diag([1.0, 1.0, -1.0])
        mat[:3, :3] = m
        mat[:3, 3] = rng.normal(size=3)
        out_t = se3.orthonormalize_transform(torch.from_numpy(mat)).numpy()
        out_j = np.asarray(jicp.orthonormalize_transform(jnp.asarray(mat)))
        np.testing.assert_allclose(out_t, out_j, atol=1e-6, err_msg=f"case {i}")
        np.testing.assert_allclose(np.linalg.det(out_t[:3, :3].astype(np.float64)), 1.0, atol=1e-5)


def test_estimate_normals_matches_jax_up_to_sign():
    pts = _planar_patches(2000)
    padded, valid = ticp.pad_cloud(pts, 2048)
    n_t = ticp.estimate_normals(torch.from_numpy(padded), torch.from_numpy(valid)).numpy()
    n_j = np.asarray(jicp.estimate_normals(jnp.asarray(padded), jnp.asarray(valid)))
    dots = np.abs(np.sum(n_t * n_j, axis=-1))[valid]
    assert dots.min() >= 1.0 - 1e-5, np.sort(dots)[:5]
    np.testing.assert_allclose(np.linalg.norm(n_t[valid], axis=-1), 1.0, atol=1e-6)


def test_registration_icp_matches_jax():
    src, tgt, _ = _scan_pair(1, 2048)
    s, sv = ticp.pad_cloud(src, 2048)
    t, tv = ticp.pad_cloud(tgt, 2048)
    normals = np.asarray(jicp.estimate_normals(jnp.asarray(t), jnp.asarray(tv)))
    init = np.eye(4, dtype=np.float32)
    res_j = jicp.registration_icp(jnp.asarray(s), jnp.asarray(t), jnp.asarray(normals),
                                  jnp.asarray(sv), jnp.asarray(tv), 1.5, jnp.asarray(init),
                                  max_iterations=10)
    res_t = ticp.registration_icp(*(torch.from_numpy(np.array(x)) for x in (s, t, normals, sv, tv)),
                                  1.5,
                                  torch.from_numpy(init), max_iterations=10)
    _check_result(res_t, res_j)


@pytest.mark.parametrize("n,pad,seed", [(1500, 1536, 2), (5000, 5120, 3)])
def test_run_icp_schedule_matches_jax(n, pad, seed):
    src, tgt, t_true = _scan_pair(seed, n)
    init = np.eye(4)
    init[:3, 3] = [0.05, 0.0, 0.0]
    res_t = ticp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=pad, init=init)
    res_j = jicp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=pad, init=init)
    _check_result(res_t, res_j)
    assert res_t.transformation.device.type == "cpu"
    np.testing.assert_allclose(res_t.transformation.numpy(), t_true, atol=0.02)
    if n <= 1500:  # (one 5120-point schedule takes seconds on one CPU core)
        # A chained device-tensor init, as the pipelined tracker passes it.
        chained = ticp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=pad,
                                        init=res_t.transformation)
        np.testing.assert_allclose(chained.transformation.numpy(),
                                   res_t.transformation.numpy(), atol=TRANSFORM_TOL)


def test_row_blocked_path_matches_single_tile(monkeypatch):
    src, tgt, _ = _scan_pair(4, 1000)
    s, sv = ticp.pad_cloud(src, 1000)
    t, tv = ticp.pad_cloud(tgt, 1000)
    args = [torch.from_numpy(x) for x in (s, t, sv, tv)]
    single_normals = ticp.estimate_normals(args[1], args[3])
    single = ticp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=1000)
    monkeypatch.setattr(ticp, "_SINGLE_TILE_ELEMS", 1 << 16)
    monkeypatch.setattr(ticp, "_BLOCK_BUDGET_ELEMS", 1 << 15)
    assert ticp._row_block(1000, 1000) == 256  # 4 blocks, the last one ragged
    blocked_normals = ticp.estimate_normals(args[1], args[3])
    blocked = ticp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=1000)
    np.testing.assert_array_equal(blocked_normals.numpy(), single_normals.numpy())
    np.testing.assert_allclose(blocked.transformation.numpy(), single.transformation.numpy(),
                               atol=1e-6)
    assert float(blocked.fitness) == float(single.fitness)


def test_transform_ignores_the_callers_matmul_precision():
    src, tgt, _ = _scan_pair(5, 1500)
    highest = ticp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=1536)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        medium = ticp.run_icp_schedule(src, tgt, SCHEDULE, pad_size=1536)
    finally:
        torch.set_float32_matmul_precision(before)
    np.testing.assert_array_equal(medium.transformation.numpy(), highest.transformation.numpy())
