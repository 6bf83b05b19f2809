"""The PyTorch port's sampling and compositing against the JAX package's, on
the same random numbers: JAX draws them from its keys, the port takes them as
tensors. float32 throughout; tolerance 1e-5 on O(1) values (summation order),
gradients 1e-4 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.models import field as jfield
from loner_tpu.models import rendering as jr
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
from loner_tpu.models.proposal import ProposalConfig as JProp, init_proposal_params
from loner_tpu_torch import convert
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models import rendering as tr

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _close(actual, expected, atol=1e-5, rtol=0.0, msg=""):
    np.testing.assert_allclose(
        actual.detach().numpy() if isinstance(actual, torch.Tensor) else actual,
        np.asarray(expected), atol=atol, rtol=rtol, err_msg=msg,
    )


def _rays(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = np.full((n,), 1.0 / 12.0)
    far = rng.uniform(0.5, 0.8, n)
    return np.asarray(jr.pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                                   jnp.asarray(far)), np.float32)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_on_the_same_uniforms(det):
    rng = np.random.default_rng(1)
    n, nb, q = 24, 15, 40
    bins = np.sort(rng.uniform(0.1, 0.9, (n, nb + 1)), axis=1).astype(np.float32)
    weights = rng.uniform(0, 1, (n, nb)).astype(np.float32)
    weights[:4] = 0.0  # all-zero rows: the eps floor alone shapes the CDF
    key = jax.random.key(3)
    ref = jr.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), q, det=det)
    u = None if det else torch.tensor(np.asarray(jax.random.uniform(key, (n, q))))
    out = tr.sample_pdf(torch.tensor(bins), torch.tensor(weights), q, u=u)
    _close(out, ref, atol=2e-6)


def test_sample_pdf_top_edge_maps_to_last_bin():
    bins = torch.tensor([[0.0, 0.5, 1.0]])
    out = tr.sample_pdf(bins, torch.tensor([[1.0, 1.0]]), 3, u=torch.tensor([[0.0, 0.5, 1.0]]))
    np.testing.assert_allclose(out.numpy(), [[0.0, 0.5, 1.0]], atol=1e-6)


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_uniform_sampler_matches(perturb):
    rays = _rays(16)
    key = jax.random.key(4)
    ref = jr.UniformRaySampler().get_samples(key, jnp.asarray(rays), 32, perturb)
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (16, 32))))
    out = tr.UniformRaySampler().get_samples(torch.tensor(rays), 32, perturb, None, jitter)
    _close(out, ref)


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_proposal_sampler_matches_values_and_ray_gradients(perturb):
    rays = _rays(16, seed=2)
    prop = init_proposal_params(jax.random.key(5), JProp(n_freqs=4, n_neurons=16))
    prop_t = convert.proposal_params_from_jax(jax.tree.map(np.asarray, prop), CPU)
    key = jax.random.key(6)
    c = np.random.default_rng(7).normal(size=(16, 32)).astype(np.float32)
    sampler_j = jr.ProposalRaySampler(n_ctrl=9)

    def f_j(r):
        return (sampler_j.get_samples(key, r, 32, perturb, prop) * c).sum()

    z_j = sampler_j.get_samples(key, jnp.asarray(rays), 32, perturb, prop)
    g_j = jax.grad(f_j)(jnp.asarray(rays))

    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (16, 32))))
    rays_t = torch.tensor(rays, requires_grad=True)
    z_t = tr.ProposalRaySampler(n_ctrl=9).get_samples(rays_t, 32, perturb, prop_t, jitter)
    (z_t * torch.tensor(c)).sum().backward()
    _close(z_t, z_j)
    assert torch.all(z_t[:, 1:] >= z_t[:, :-1])
    # Only near/far carry gradient (the occupancy CDF is detached).
    _close(rays_t.grad, g_j, atol=1e-4)
    assert float(rays_t.grad[:, :9].abs().max()) == 0.0


@pytest.mark.parametrize("softplus", [False, True])
def test_raw2outputs_matches_values_and_gradients(softplus):
    rng = np.random.default_rng(8)
    n, s = 16, 24
    raw = rng.normal(1.0, 3.0, (n, s, 1)).astype(np.float32)
    z = np.sort(rng.uniform(0.05, 0.9, (n, s)), axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    far = np.full((n, 1), 0.95, np.float32)
    key = jax.random.key(9)

    def f_j(raw_, z_):
        out = jr.raw2outputs(raw_, z_, jnp.asarray(d), key=key, raw_noise_std=1.0,
                             sigma_only=True, softplus=softplus, far=jnp.asarray(far),
                             ret_var=True)
        return out["depth"].sum() + out["variance"].sum() + out["weights"].std(), out

    (_, out_j), (g_raw, g_z) = jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(raw), jnp.asarray(z))
    noise = torch.tensor(np.asarray(jax.random.normal(key, (n, s))))
    raw_t = torch.tensor(raw, requires_grad=True)
    z_t = torch.tensor(z, requires_grad=True)
    out_t = tr.raw2outputs(raw_t, z_t, torch.tensor(d), noise=noise, raw_noise_std=1.0,
                           softplus=softplus, far=torch.tensor(far), ret_var=True)
    (out_t["depth"].sum() + out_t["variance"].sum() + out_t["weights"].std()).backward()
    for k in ("depth", "weights", "opacity", "variance"):
        _close(out_t[k], out_j[k], atol=2e-5, msg=k)
    for got, ref in ((raw_t.grad, g_raw), (z_t.grad, g_z)):
        scale = max(float(np.abs(np.asarray(ref)).max()), 1.0)
        _close(got / scale, np.asarray(ref) / scale, atol=1e-4)


def test_render_rays_matches_with_the_fused_sigma_path():
    """render_rays through the proposal sampler and the Fourier sigma field;
    JAX runs its fused Pallas kernel in interpret mode."""
    jcfg = jfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=jfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=jfield.MLPConfig(n_neurons=32, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=jnp.float32,
        sigma_kernel="pallas", pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10),
    )
    tcfg = tfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=tfield.MLPConfig(n_neurons=32, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=torch.float32,
    )
    params = jfield.init_field_params(jax.random.key(0), jcfg)
    prop = init_proposal_params(jax.random.key(5), JProp(n_freqs=4, n_neurons=16))
    params_t = convert.field_params_from_jax(jax.tree.map(np.asarray, params), CPU)
    prop_t = convert.proposal_params_from_jax(jax.tree.map(np.asarray, prop), CPU)
    rays = _rays(16, seed=3)
    key = jax.random.key(10)
    out_j = jr.render_rays(key, jnp.asarray(rays), params, jcfg, jr.ProposalRaySampler(9), 32,
                           perturb=1.0, raw_noise_std=1.0, occ_grid=prop, ret_var=True,
                           point_chunk=0)
    k_sample, k_noise = jax.random.split(key)
    out_t = tr.render_rays(
        torch.tensor(rays), params_t, tcfg, tr.ProposalRaySampler(9), 32, perturb=1.0,
        raw_noise_std=1.0, occ_state=prop_t, ret_var=True,
        jitter=torch.tensor(np.asarray(jax.random.uniform(k_sample, (16, 32)))),
        noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (16, 32)))),
    )
    for k in ("z_vals", "points", "depth", "weights", "opacity", "variance"):
        _close(out_t[k], out_j[k], atol=2e-5, msg=k)
