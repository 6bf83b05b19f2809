"""The port's fused compositor against the JAX package's, on CPU.

The plain version (``ops/composite.py::composite_plain``, what a CPU tensor
runs) against ``composite_rays(..., interpret=True)`` on the cases of
``tests/test_pallas_ops.py``, at its tolerances: depth and opacity rtol/atol
2e-4, weights rtol 5e-3 atol 2e-4, variance rtol 1e-3 atol 2e-4 (the Pallas
kernel's log-space scan against a cumprod). A ray count that is not a multiple
of 256, which the Pallas kernel does not take, against JAX's ``raw2outputs``
(f32, same ops: atol 2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.models.rendering import raw2outputs
from loner_tpu.ops.pallas.composite import composite_rays as j_composite
from loner_tpu_torch.ops import composite as tc

torch.set_num_threads(1)

TOL = {"depth": (2e-4, 2e-4), "opacity": (2e-4, 2e-4), "weights": (5e-3, 2e-4),
       "variance": (1e-3, 2e-4)}  # (rtol, atol), tests/test_pallas_ops.py:31-34


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _random_case(b, s, mean, seed):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.05, 0.9, (b, s)).astype(np.float32), axis=1)
    sigma = rng.normal(mean, 3.0, (b, s)).astype(np.float32)
    far = np.full((b,), 0.95, np.float32)
    dnorm = rng.uniform(0.5, 1.5, b).astype(np.float32)
    return z, sigma, far, dnorm


@pytest.mark.parametrize("softplus,mean,seed,s", [
    (False, 2.0, 0, 128), (True, 0.0, 3, 128), (True, 0.0, 4, 1)])
def test_plain_matches_the_pallas_kernel(softplus, mean, seed, s):
    z, sigma, far, dnorm = _random_case(256, s, mean, seed)
    ref = j_composite(*map(jnp.asarray, (z, sigma, far, dnorm)), interpret=True,
                      softplus=softplus)
    out = tc.composite_plain(*_t(z, sigma, far, dnorm), softplus=softplus)
    for name, got, want in zip(("depth", "opacity", "variance", "weights"), out, ref):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_plain_empty_and_opaque_match_the_pallas_kernel():
    b, s = 256, 128
    z = np.tile(np.linspace(0.1, 0.8, s, dtype=np.float32), (b, 1))
    sigma = np.zeros((b, s), np.float32)
    sigma[: b // 2, s // 2] = 1e8  # first half: hard wall mid-ray
    far = np.full((b,), 0.9, np.float32)
    dnorm = np.ones((b,), np.float32)
    ref = j_composite(*map(jnp.asarray, (z, sigma, far, dnorm)), interpret=True)
    depth, opacity, var, weights = tc.composite_plain(*_t(z, sigma, far, dnorm))
    for name, got, want in zip(("depth", "opacity", "variance", "weights"),
                               (depth, opacity, var, weights), ref):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(depth[: b // 2].numpy(), z[0, s // 2], atol=1e-3)
    np.testing.assert_allclose(opacity[: b // 2].numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(depth[b // 2 :].numpy(), 0.9, atol=1e-4)  # far residual
    np.testing.assert_allclose(opacity[b // 2 :].numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("softplus", [False, True])
def test_any_ray_count_matches_raw2outputs(softplus):
    b, s = 300, 96  # 300 is not a multiple of the Pallas kernel's 256-ray tile
    z, sigma, far, dnorm = _random_case(b, s, 1.0, 5)
    rays_d = np.stack([dnorm, np.zeros(b), np.zeros(b)], 1).astype(np.float32)
    ref = raw2outputs(jnp.asarray(sigma)[..., None], jnp.asarray(z), jnp.asarray(rays_d),
                      sigma_only=True, far=jnp.asarray(far)[:, None], ret_var=True,
                      softplus=softplus)
    out = tc.composite_rays(*_t(z, sigma, far, dnorm), softplus=softplus)
    for name, got in zip(("depth", "opacity", "variance", "weights"), out):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[name]), atol=2e-5, err_msg=name)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    z, sigma, far, dnorm = _t(*_random_case(40, 33, 1.0, 6))
    before = tc.counts.composite_launches
    out = tc.composite_rays(z, sigma, far, dnorm, softplus=True)
    for got, want in zip(out, tc.composite_plain(z, sigma, far, dnorm, softplus=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tc.counts.composite_launches == before


def test_kernel_operand_checks():
    z, sigma, far, dnorm = _t(*_random_case(8, 16, 1.0, 7))
    assert tc.check_operands(z, sigma, far, dnorm) == (8, 16)
    bad = [
        (z.double(), sigma, far, dnorm),  # dtype
        (z, sigma[:, :8], far, dnorm),  # shape
        (z, sigma, far[:4], dnorm),
        (z.t().contiguous().t(), sigma, far, dnorm),  # not contiguous
        (z, sigma.clone().requires_grad_(True), far, dnorm),  # the kernel has no backward
    ]
    for args, match in zip(bad, ("float32", "float32", "far", "contiguous", "forward only")):
        with pytest.raises(ValueError, match=match):
            tc.check_operands(*args)
    with torch.no_grad():  # a gradient is not asked for under no_grad
        tc.check_operands(z, sigma.clone().requires_grad_(True), far, dnorm)
