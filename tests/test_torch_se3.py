"""The PyTorch port's SE(3) math against the JAX package's, values and
gradients, at small and large angles.

Tolerance: float32 on both sides; the formulas are the same, so they agree to
a few ulps (atol 1e-6 on O(1) values, 1e-5 on gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.common import se3 as jse3
from loner_tpu_torch.common import se3 as tse3

torch.set_num_threads(1)

ATOL, GRAD_ATOL = 1e-6, 1e-5

# Rotation-vector magnitudes: the Taylor branch (< 1e-4), small, large, near pi.
ANGLES = [1e-5, 0.1, 1.5, 3.1]


def _rotvecs(angle: float, n: int = 16, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return (axes * angle).astype(np.float32)


def _twists(angle: float, n: int = 16) -> np.ndarray:
    rng = np.random.default_rng(1)
    return np.concatenate(
        [rng.normal(size=(n, 3)).astype(np.float32), _rotvecs(angle, n)], axis=1
    )


def _value_and_vjp(jfn, tfn, x: np.ndarray):
    """Outputs of both, and the gradient of <out, c> for a fixed cotangent c."""
    out_j, vjp = jax.vjp(jfn, jnp.asarray(x))
    c = np.random.default_rng(2).normal(size=out_j.shape).astype(np.float32)
    (g_j,) = vjp(jnp.asarray(c))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tfn(xt)
    (out_t * torch.tensor(c)).sum().backward()
    return np.asarray(out_j), out_t.detach().numpy(), np.asarray(g_j), xt.grad.numpy()


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize(
    "name", ["axis_angle_to_matrix", "axis_angle_to_quaternion", "skew"]
)
def test_rotvec_functions_match(name, angle):
    oj, ot, gj, gt = _value_and_vjp(getattr(jse3, name), getattr(tse3, name), _rotvecs(angle))
    np.testing.assert_allclose(ot, oj, atol=ATOL)
    np.testing.assert_allclose(gt, gj, atol=GRAD_ATOL)


@pytest.mark.parametrize("angle", ANGLES)
def test_twist_to_matrix_values_and_twist_gradients(angle):
    oj, ot, gj, gt = _value_and_vjp(jse3.twist_to_matrix, tse3.twist_to_matrix, _twists(angle))
    np.testing.assert_allclose(ot, oj, atol=ATOL)
    np.testing.assert_allclose(gt, gj, atol=GRAD_ATOL)


@pytest.mark.parametrize("angle", ANGLES)
def test_matrix_round_trips_match(angle):
    mats = np.asarray(jse3.twist_to_matrix(jnp.asarray(_twists(angle))))
    for name in ("matrix_to_twist", "transform_inverse"):
        oj = np.asarray(getattr(jse3, name)(jnp.asarray(mats)))
        ot = getattr(tse3, name)(torch.tensor(mats)).numpy()
        np.testing.assert_allclose(ot, oj, atol=2e-6, err_msg=name)
    rots = mats[:, :3, :3]
    np.testing.assert_allclose(
        tse3.matrix_to_quaternion(torch.tensor(rots)).numpy(),
        np.asarray(jse3.matrix_to_quaternion(jnp.asarray(rots))), atol=2e-6,
    )
    q = np.asarray(jse3.matrix_to_quaternion(jnp.asarray(rots)))
    for name in ("quaternion_to_matrix", "quaternion_to_axis_angle"):
        oj = np.asarray(getattr(jse3, name)(jnp.asarray(q)))
        ot = getattr(tse3, name)(torch.tensor(q)).numpy()
        np.testing.assert_allclose(ot, oj, atol=2e-6, err_msg=name)


def test_transform_points_and_interpolation_match():
    mats = np.asarray(jse3.twist_to_matrix(jnp.asarray(_twists(0.7, 2))))
    pts = np.random.default_rng(3).normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.transform_points(torch.tensor(mats[0]), torch.tensor(pts)).numpy(),
        np.asarray(jse3.transform_points(jnp.asarray(mats[0]), jnp.asarray(pts))), atol=2e-6,
    )
    alpha = np.linspace(0.0, 1.0, 7, dtype=np.float32)
    np.testing.assert_allclose(
        tse3.interpolate_transforms(
            torch.tensor(mats[0]), torch.tensor(mats[1]), torch.tensor(alpha)
        ).numpy(),
        np.asarray(jse3.interpolate_transforms(
            jnp.asarray(mats[0]), jnp.asarray(mats[1]), jnp.asarray(alpha)
        )),
        atol=2e-6,
    )
