"""The PyTorch port's mapping iteration against the JAX package's.

- ``sample_and_build_rays``: rays, depths, masks and twist gradients on the
  same uniforms (f32, 1e-6 on cube coordinates, 1e-5 of scale on gradients).
- The whole step: 3 iterations of ``run_phase`` against JAX's
  ``make_phase_runner`` (W = 2, 16 rays, 32 samples, 8 frequencies, 32 x 2 MLP,
  f32; JAX's sigma head is its fused Pallas kernel in interpret mode). The port
  gets the draws JAX made, re-derived from its per-step keys. Tolerances: loss
  trajectory rtol 2e-5, parameters and twists atol 5e-6 (three Adam steps of
  lr <= 5e-3 on f32 gradients that differ in summation order).
- The import boundary: the port runs a step with jax, optax and yaml unimportable
  and pulls in nothing of ``loner_tpu``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.mapping import optimizer as jopt
from loner_tpu.mapping import rays as jrays
from loner_tpu.models import field as jfield
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
from loner_tpu.models.proposal import ProposalConfig as JProp, init_proposal_params
from loner_tpu_torch import convert
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models.proposal import ProposalConfig as TProp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
W, N_LIDAR, S, ITERS = 2, 8, 32, 3


def _scans(w: int, n: int = 100, seed: int = 0):
    rng = np.random.default_rng(seed)
    dirs, depths = [], []
    for _ in range(w):
        d = rng.normal(size=(3, n))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        dirs.append(d.astype(np.float32))
        depths.append(rng.uniform(1.5, 9.5, n).astype(np.float32))
    twists = rng.normal(0, 0.02, (w, 6)).astype(np.float32)
    return dirs, depths, twists


@pytest.mark.parametrize("n_scans", [2, 1])
def test_window_buffers_and_rays_match(n_scans):
    dirs, depths, twists = _scans(n_scans, n=50)
    twists = np.concatenate([twists, np.asarray([[0.7, -0.2, 0.1, 0.3, -1.2, 0.4]], np.float32)])
    twists = np.resize(twists, (3, 6)).astype(np.float32)
    bj = jrays.build_window_buffers(dirs, depths, [None] * n_scans, 3, sky_pad=16)
    bt = trays.build_window_buffers(dirs, depths, [None] * n_scans, 3, sky_pad=16, device=CPU)
    for name in ("dirs", "depths", "counts", "sky_dirs", "sky_counts", "slot_valid"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)))

    key = jax.random.key(4)
    shift = np.asarray([0.3, -0.1, 0.2], np.float32)
    c = np.random.default_rng(5).normal(size=(3 * 16, 11)).astype(np.float32)

    def f_j(tw):
        rays, depths_cube, valid = jrays.sample_and_build_rays(
            key, bj, tw, jnp.asarray(12.0), jnp.asarray(shift), (1.0, 10.0), 16, 0)
        return (rays * c).sum(), (rays, depths_cube, valid)

    (_, (rays_j, dc_j, valid_j)), g_j = jax.value_and_grad(f_j, has_aux=True)(jnp.asarray(twists))
    u = torch.tensor(np.asarray(jax.random.uniform(jax.random.split(key)[0], (3, 16))))
    tw = torch.tensor(twists, requires_grad=True)
    rays_t, dc_t, valid_t = trays.sample_and_build_rays(
        bt, tw, torch.tensor(12.0), torch.tensor(shift), (1.0, 10.0), 16, 0, u=u)
    (rays_t * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(rays_t.detach().numpy(), np.asarray(rays_j), atol=1e-6)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), atol=1e-7)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    scale = max(np.abs(np.asarray(g_j)).max(), 1.0)
    np.testing.assert_allclose(tw.grad.numpy() / scale, np.asarray(g_j) / scale, atol=1e-5)
    with pytest.raises(NotImplementedError):
        trays.sample_and_build_rays(bt, tw, 12.0, torch.tensor(shift), (1.0, 10.0), 16, 4, u=u)


def _configs(strategy: str, lr_gamma: float):
    common = dict(
        n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S, ray_range=(1.0, 10.0),
        samples_strategy=strategy, lr_sigma=0.005, lr_gamma=lr_gamma, prop_n_ctrl=9,
        prop_train_subsample=4,
    )
    cfg_j = jopt.OptimizerConfig(**common, window_size=W, point_chunk=0, steps_per_dispatch=1,
                                 proposal=JProp(n_freqs=4, n_neurons=16))
    cfg_t = topt.OptimizerConfig(**common, proposal=TProp(n_freqs=4, n_neurons=16))
    field = dict(encoding_sigma="fourier", density_activation="softplus", sigma_mlp_bias=True)
    fcfg_j = jfield.FieldConfig(
        fourier_sigma=jfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=jfield.MLPConfig(32, 2, 1), compute_dtype=jnp.float32, sigma_kernel="pallas",
        pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10), **field,
    )
    fcfg_t = tfield.FieldConfig(
        fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=tfield.MLPConfig(32, 2, 1), compute_dtype=torch.float32,
        pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
        **field,
    )
    return cfg_j, cfg_t, fcfg_j, fcfg_t


def _jax_draws(key, n_iters: int):
    """The draws of JAX's single-step programs (steps_per_dispatch = 1), from
    the same key splits as make_phase_runner, sample_and_build_rays,
    render_rays and the samplers."""
    draws = []
    for i in range(n_iters):
        k_step = jax.random.fold_in(jax.random.fold_in(key, i), 1)
        k_rays, _, k_render = jax.random.split(k_step, 3)
        k_lidar, _ = jax.random.split(k_rays)
        k_sample, k_noise = jax.random.split(k_render)
        draws.append(topt.StepDraws(
            ray_u=torch.tensor(np.asarray(jax.random.uniform(k_lidar, (W, N_LIDAR)))),
            jitter=torch.tensor(np.asarray(jax.random.uniform(k_sample, (W * N_LIDAR, S)))),
            noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (W * N_LIDAR, S)))),
        ))
    return draws


@pytest.mark.parametrize(
    "strategy,lr_gamma,pose_mask",
    [("PROPOSAL", 1.0, (1.0, 1.0)), ("UNIFORM", 0.9, (0.0, 1.0))],
)
def test_run_phase_matches_jax_over_three_iterations(strategy, lr_gamma, pose_mask):
    cfg_j, cfg_t, fcfg_j, fcfg_t = _configs(strategy, lr_gamma)
    dirs, depths, twists = _scans(W)
    params = jfield.init_field_params(jax.random.key(0), fcfg_j)
    params["sigma"]["mlp"] = {  # non-zero biases, so their gradients are checked
        k: v + 0.05 * jax.random.normal(jax.random.key(7), v.shape) if k.startswith("b") else v
        for k, v in params["sigma"]["mlp"].items()
    }
    prop = init_proposal_params(jax.random.key(5), cfg_j.proposal)
    params_np, prop_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, prop)
    key = jax.random.key(1)
    mask = np.asarray(pose_mask, np.float32)

    bj = jrays.build_window_buffers(dirs, depths, [None] * W, W)
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, jopt.PhaseSettings(num_iterations=ITERS), W,
                                   bj.dirs.shape[1], bj.sky_dirs.shape[1])
    field_j, prop_j, tw_j, losses_j, eps_j = run_j(
        params, prop if strategy == "PROPOSAL" else None, jnp.asarray(twists), bj,
        jnp.asarray(mask), jnp.asarray(12.0, jnp.float32), jnp.zeros(3), 0, key,
        num_iterations=ITERS,
    )

    bt = trays.build_window_buffers(dirs, depths, [None] * W, W, device=CPU)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(num_iterations=ITERS), W,
                                   bt.dirs.shape[1], bt.sky_dirs.shape[1], CPU)
    field_t, prop_t, tw_t, losses_t, eps_t = run_t(
        convert.field_params_from_jax(params_np, CPU),
        convert.proposal_params_from_jax(prop_np, CPU) if strategy == "PROPOSAL" else None,
        convert.twists_from_jax(twists, CPU), bt, torch.tensor(mask), torch.tensor(12.0),
        torch.zeros(3), 0, None, num_iterations=ITERS, draws=_jax_draws(key, ITERS),
    )

    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=5e-6)
    assert np.abs(tw_t.numpy() - twists)[1].max() > 1e-4  # the unmasked pose moved
    np.testing.assert_array_equal(tw_t.numpy()[mask == 0], twists[mask == 0])
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v),
                                   atol=5e-6, err_msg=k)
        assert np.abs(np.asarray(v) - params_np["sigma"]["mlp"][k]).max() > 1e-3
    if strategy == "PROPOSAL":
        for k, v in prop_j.items():
            np.testing.assert_allclose(prop_t[k].numpy(), np.asarray(v), atol=5e-6, err_msg=k)
        np.testing.assert_array_equal(prop_t["bmat"].numpy(), prop_np["bmat"])


def test_make_phase_runner_rejects_what_is_not_ported():
    _, cfg_t, _, fcfg_t = _configs("PROPOSAL", 1.0)
    args = (W, 4096, 4096, CPU)
    with pytest.raises(NotImplementedError):
        topt.make_phase_runner(topt.OptimizerConfig(), fcfg_t, topt.PhaseSettings(), *args)
    with pytest.raises(NotImplementedError):
        topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(freeze_rgb_mlp=False), *args)
    with pytest.raises(NotImplementedError):
        topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(), *args, extras_mode="ray")


def test_optimizer_config_from_settings_reads_the_flagship_yaml():
    import yaml

    model = yaml.safe_load((REPO / "cfg/model_config/tpu_native_model_config.yaml").read_text()
                           .replace('!include "../nerf_config/tpu_fourier.yaml"', "null"))
    opt = {"num_samples": {"lidar": 512, "sky": 0}, "rays_selection": {"strategy": "RANDOM"},
           "samples_selection": {"strategy": "PROPOSAL"}}
    cfg = topt.OptimizerConfig.from_settings(opt, model)
    assert (cfg.prop_n_ctrl, cfg.prop_train_subsample, cfg.lr_sigma) == (33, 8, 0.005)
    assert cfg.proposal == TProp(n_freqs=16, scale=3.0, n_neurons=64, n_hidden_layers=2)
    nerf = yaml.safe_load((REPO / "cfg/nerf_config/tpu_fourier.yaml").read_text())
    fcfg = tfield.FieldConfig.from_settings(nerf)
    assert fcfg.compute_dtype == torch.bfloat16 and fcfg.sigma_mlp_bias
    assert (fcfg.fourier_sigma.n_freqs, fcfg.sigma_mlp.n_neurons) == (48, 256)
    assert fcfg.density_activation == "softplus" and fcfg.sigma_kernel == "fused"


def test_port_runs_a_step_without_jax_optax_yaml_or_loner_tpu():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = sys.modules["optax"] = sys.modules["yaml"] = None
        import numpy as np
        import torch
        import loner_tpu_torch
        from loner_tpu_torch import convert  # noqa: F401
        from loner_tpu_torch.mapping.optimizer import (
            OptimizerConfig, PhaseSettings, make_phase_runner)
        from loner_tpu_torch.mapping.rays import build_window_buffers
        from loner_tpu_torch.models.field import (
            FieldConfig, FourierConfig, MLPConfig, init_field_params)
        from loner_tpu_torch.models.proposal import ProposalConfig, init_proposal_params

        dev = torch.device("cpu")
        cfg = OptimizerConfig(n_lidar_samples=8, n_sky_samples=0, n_samples_per_ray=16,
                              samples_strategy="PROPOSAL", prop_n_ctrl=5,
                              proposal=ProposalConfig(n_freqs=8, n_neurons=16))
        fcfg = FieldConfig(encoding_sigma="fourier", fourier_sigma=FourierConfig(n_freqs=8),
                           sigma_mlp=MLPConfig(32, 2, 1), sigma_mlp_bias=True,
                           density_activation="softplus", compute_dtype=torch.bfloat16)
        rng = np.random.default_rng(0)
        d = rng.normal(size=(3, 64)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        buf = build_window_buffers([d, d], [np.full(64, 4.0, np.float32)] * 2, [None, None], 2)
        gen = torch.Generator().manual_seed(0)
        run = make_phase_runner(cfg, fcfg, PhaseSettings(), 2, 4096, 4096, dev)
        out = run(init_field_params(gen, fcfg, dev), init_proposal_params(gen, cfg.proposal, dev),
                  torch.zeros(2, 6), buf, torch.ones(2), 12.0, torch.zeros(3), 0, gen,
                  num_iterations=1)
        assert torch.isfinite(out[3]).all() and out[3].shape == (1,)
        bad = sorted(m for m in sys.modules
                     if m == "loner_tpu" or m.startswith("loner_tpu."))
        assert not bad, bad
        assert all(sys.modules[m] is None for m in ("jax", "optax", "yaml"))
        print("boundary ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "boundary ok" in proc.stdout, proc.stdout + proc.stderr
