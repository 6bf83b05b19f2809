"""The PyTorch port's loss terms against the JAX package's: the truncated
Gaussian targets, the occupancy pseudo-gradient, the Gaussian divergences, and
``compute_lidar_loss`` values and gradients on the same rays and draws.
float32; tolerance 1e-5 relative on values, 1e-4 of scale on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.mapping import loss as jloss
from loner_tpu.models import field as jfield
from loner_tpu.models import losses as jl
from loner_tpu.models import rendering as jr
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
from loner_tpu.models.proposal import ProposalConfig as JProp, init_proposal_params
from loner_tpu_torch import convert
from loner_tpu_torch.mapping import loss as tloss
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models import losses as tl
from loner_tpu_torch.models import rendering as tr

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("eps_kind", ["scalar", "per_ray"])
def test_weights_gt_logits_grad_and_divergences_match(eps_kind):
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(1.0, 9.0, (12, 40)), axis=1).astype(np.float32)
    gt = rng.uniform(2.0, 8.0, (12, 1)).astype(np.float32)
    eps = 0.7 if eps_kind == "scalar" else rng.uniform(0.5, 2.0, (12, 1)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.get_weights_gt(torch.tensor(z), torch.tensor(gt), eps if eps_kind == "scalar"
                              else torch.tensor(eps))),
        np.asarray(jl.get_weights_gt(jnp.asarray(z), jnp.asarray(gt), jnp.asarray(eps))),
        rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_array_equal(
        _np(tl.get_logits_grad(torch.tensor(z), torch.tensor(gt))),
        np.asarray(jl.get_logits_grad(jnp.asarray(z), jnp.asarray(gt))),
    )
    m1, s1, m2, s2 = (rng.uniform(0.2, 3.0, 32).astype(np.float32) for _ in range(4))
    for name in ("kl_divergence_gaussian", "js_divergence_gaussian"):
        np.testing.assert_allclose(
            _np(getattr(tl, name)(*(torch.tensor(a) for a in (m1, s1, m2, s2)))),
            np.asarray(getattr(jl, name)(*(jnp.asarray(a) for a in (m1, s1, m2, s2)))),
            rtol=1e-5, err_msg=name,
        )


def _setup():
    jcfg = jfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=jfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=jfield.MLPConfig(n_neurons=32, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=jnp.float32,
        sigma_kernel="xla", pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10),
    )
    tcfg = tfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=tfield.MLPConfig(n_neurons=32, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True, compute_dtype=torch.float32,
    )
    params = jfield.init_field_params(jax.random.key(0), jcfg)
    prop = init_proposal_params(jax.random.key(5), JProp(n_freqs=4, n_neurons=16))
    rng = np.random.default_rng(1)
    n = 24
    o = rng.uniform(-0.1, 0.1, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = np.minimum(rng.uniform(0.4, 0.8, n), 10.0 / 12.0)
    rays = np.asarray(jr.pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 1 / 12.0),
                                   jnp.asarray(far)), np.float32)
    depths = rng.uniform(0.15, 0.7, n).astype(np.float32)
    depths[:3] = 0.95  # beyond far: transparent rays
    valid = np.ones(n, bool)
    valid[-2:] = False
    return jcfg, tcfg, params, prop, rays, depths, valid


@pytest.mark.parametrize(
    "strategy,selection",
    [("PROPOSAL", "L1_JS"), ("PROPOSAL", "L1_LOS"), ("UNIFORM", "L2_JS"), ("UNIFORM", "L2_LOS")],
)
def test_compute_lidar_loss_matches_values_and_gradients(strategy, selection):
    jcfg, tcfg, params, prop, rays, depths, valid = _setup()
    lcfg_j = jloss.LossConfig(loss_selection=selection)
    lcfg_t = tloss.LossConfig(loss_selection=selection)
    use_prop = strategy == "PROPOSAL"
    sampler_j = jr.ProposalRaySampler(9) if use_prop else jr.UniformRaySampler()
    sampler_t = tr.ProposalRaySampler(9) if use_prop else tr.UniformRaySampler()
    key = jax.random.key(2)
    scale = 12.0

    def f_j(p, r):
        return jloss.compute_lidar_loss(
            key, r, jnp.asarray(depths), jnp.asarray(valid), p, jcfg, sampler_j,
            prop if use_prop else None, lcfg_j, jnp.asarray(scale), 32, 1.0, 1.0,
            jnp.asarray(3.0), jnp.asarray(7.0), point_chunk=0,
        )

    (loss_j, aux_j), (g_p, g_r) = jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(rays))

    k_sample, k_noise = jax.random.split(key)
    params_t = convert.field_params_from_jax(jax.tree.map(np.asarray, params), CPU)
    mlp_t = {k: v.requires_grad_(True) for k, v in params_t["sigma"]["mlp"].items()}
    rays_t = torch.tensor(rays, requires_grad=True)
    loss_t, aux_t = tloss.compute_lidar_loss(
        rays_t, torch.tensor(depths), torch.tensor(valid), params_t, tcfg, sampler_t,
        convert.proposal_params_from_jax(jax.tree.map(np.asarray, prop), CPU) if use_prop else None,
        lcfg_t, torch.tensor(scale), 32, 1.0, 1.0, 3.0, 7.0,
        jitter=torch.tensor(np.asarray(jax.random.uniform(k_sample, (24, 32)))),
        noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (24, 32)))),
    )
    loss_t.backward()

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    for k in ("depth_loss", "los_loss", "opacity_loss", "depth_eps", "js_score", "z_m"):
        np.testing.assert_allclose(_np(aux_t[k]), np.asarray(aux_j[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(aux_t["opaque"]), np.asarray(aux_j["opaque"]))
    for k, v in mlp_t.items():
        ref = np.asarray(g_p["sigma"]["mlp"][k])
        s = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(v.grad.numpy() / s, ref / s, atol=1e-4, err_msg=k)
    s = max(np.abs(np.asarray(g_r)).max(), 1.0)
    np.testing.assert_allclose(rays_t.grad.numpy() / s, np.asarray(g_r) / s, atol=1e-4)
