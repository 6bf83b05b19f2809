"""The PyTorch port's mapping iteration against the JAX package's.

- ``sample_and_build_rays``: rays, depths, masks and twist gradients on the
  same uniforms (f32, 1e-6 on cube coordinates, 1e-5 of scale on gradients).
- The whole step: 3 iterations of ``run_phase`` against JAX's
  ``make_phase_runner`` (W = 2, 16 rays, 32 samples, 8 frequencies, 32 x 2 MLP,
  f32; JAX's sigma head is its fused Pallas kernel in interpret mode). The port
  gets the draws JAX made, re-derived from its per-step keys. Tolerances: loss
  trajectory rtol 2e-5, parameters and twists atol 5e-6 (three Adam steps of
  lr <= 5e-3 on f32 gradients that differ in summation order).
- The reference's configuration at small size: OGM sampler + hash sigma field
  (box_room_tiny's 6 x 2 grid at 2^14, 12 -> 16 -> 1 ReLU MLP, no biases), three
  iterations from global step 9 so that the second one updates the grid, with
  the f32 training encode (vjp_f32) and with bf16 (vjp_bf16). Losses rtol 2e-5
  and twists atol 5e-6 as above; the grid atol 5e-5 (an SGD step of lr 0.5 on
  sums of -2.5 / +0.25 margin gradients times trilinear weights, scattered in
  another order; measured 1.2e-5); the MLP atol 5e-5 and the
  table 99.9% of entries within 5e-6, every one within 5% of the learning rate:
  Adam's first steps are about lr sign(g), so a weight or entry whose gradient
  is a near-cancelling sum of a few points' terms (near Adam's eps, 1e-8) moves
  by a different fraction of lr in each package (measured: 24 of 172,148
  entries past 5e-6, at most 2.7e-4). The same phase with frozen poses (the
  W=1 bootstrap's kind), at the same tolerances, twists unchanged in both: the
  port's hash backward then runs without its dpos half.
- The import boundary: the port runs a step, renders a map cloud from a
  checkpoint it wrote, and runs a tiny single-threaded SLAM trial through
  ``run_trial`` (at chip_smoke.py's settings, cut down), resumes it in place,
  scores a map and its sky floaters, each with the Fourier field and proposal
  sampler and with the hash field and OGM sampler, with jax, optax, yaml (and
  matplotlib) unimportable, and pulls in nothing of ``loner_tpu``; so do the
  ingest (bag generator, reader, converter, host ops, calibration) and the
  runner's sweep, repeat, lite and synthetic flags.
"""
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
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
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig as THash
from loner_tpu_torch.models.proposal import ProposalConfig as TProp
from loner_tpu_torch.ops import hash_grid as thash_grid

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
    # Sky rays on buffers without sky directions: appended after each slot's
    # LiDAR rays, all masked out, the LiDAR rays unchanged.
    rays_s, _, valid_s = trays.sample_and_build_rays(
        bt, tw, torch.tensor(12.0), torch.tensor(shift), (1.0, 10.0), 16, 4, u=u,
        sky_u=torch.rand(3, 4))
    assert rays_s.shape == (3 * 20, 11) and not valid_s.view(3, 20)[:, 16:].any()
    np.testing.assert_array_equal(rays_s.detach().view(3, 20, 11)[:, :16].numpy(),
                                  rays_t.detach().view(3, 16, 11).numpy())


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


TINY_HASH = dict(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5)  # box_room_tiny.yaml


def _hash_configs(encode_impl: str):
    """OGM + hash field, the reference's model at box_room_tiny's grid widths."""
    common = dict(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                  ray_range=(1.0, 10.0), samples_strategy="OGM", lr_sigma=0.01,
                  occ_voxel_size=16, occ_lr=0.5, occ_update_every=10, encode_impl=encode_impl)
    cfg_j = jopt.OptimizerConfig(**common, window_size=W, point_chunk=0, steps_per_dispatch=1)
    cfg_t = topt.OptimizerConfig(**common)
    fcfg_j = jfield.FieldConfig(pos_encoding_sigma=JHash(**TINY_HASH),
                                sigma_mlp=jfield.MLPConfig(16, 1, 1),
                                pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10))
    fcfg_t = tfield.FieldConfig(pos_encoding_sigma=THash(**TINY_HASH),
                                sigma_mlp=tfield.MLPConfig(16, 1, 1),
                                pos_encoding_intensity=THash(n_levels=2, log2_hashmap_size=10))
    return cfg_j, cfg_t, fcfg_j, fcfg_t


def jax_step_draws(k_step, w: int, n_lidar: int, s: int, ogm: bool = False, n_sky: int = 0):
    """One iteration's draws from JAX's step key, by the key splits of the loss,
    sample_and_build_rays (LiDAR and sky uniforms), render_rays and the samplers
    (the OGM sampler splits its key into the stratified jitter's and the
    importance uniforms')."""
    k_rays, _, k_render = jax.random.split(k_step, 3)
    k_lidar, k_sky = jax.random.split(k_rays)
    k_sample, k_noise = jax.random.split(k_render)
    b = w * (n_lidar + n_sky)
    draws = topt.StepDraws(
        ray_u=torch.tensor(np.asarray(jax.random.uniform(k_lidar, (w, n_lidar)))),
        noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (b, s)))),
    )
    if n_sky:
        draws.sky_u = torch.tensor(np.asarray(jax.random.uniform(k_sky, (w, n_sky))))
    if ogm:
        k_uniform, k_pdf = jax.random.split(k_sample)
        draws.jitter = torch.tensor(np.asarray(jax.random.uniform(k_uniform, (b, s // 2))))
        draws.pdf_u = torch.tensor(np.asarray(jax.random.uniform(k_pdf, (b, s // 2))))
    else:
        draws.jitter = torch.tensor(np.asarray(jax.random.uniform(k_sample, (b, s))))
    return draws


def _jax_draws(key, n_iters: int, ogm: bool = False):
    """The draws of JAX's single-step programs (steps_per_dispatch = 1)."""
    return [jax_step_draws(jax.random.fold_in(jax.random.fold_in(key, i), 1), W, N_LIDAR, S, ogm)
            for i in range(n_iters)]


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


def _ogm_hash_phases(encode_impl: str, freeze_poses: bool):
    """Both packages' OGM + hash phase over ITERS iterations from global step 9, on
    the same draws: (twists in, params in, grid in, JAX's results, the port's)."""
    cfg_j, cfg_t, fcfg_j, fcfg_t = _hash_configs(encode_impl)
    dirs, depths, twists = _scans(W, seed=3)
    params = jfield.init_field_params(jax.random.key(2), fcfg_j)
    params_np = jax.tree.map(np.asarray, params)
    grid = np.asarray(jax.random.normal(jax.random.key(8), (16, 16, 16))) * 0.1
    key, step0 = jax.random.key(9), 9  # global steps 9, 10, 11: the grid moves at 10

    bj = jrays.build_window_buffers(dirs, depths, [None] * W, W)
    phase_j = jopt.PhaseSettings(num_iterations=ITERS, freeze_poses=freeze_poses)
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, phase_j, W, bj.dirs.shape[1],
                                   bj.sky_dirs.shape[1])
    out_j = run_j(params, jnp.asarray(grid), jnp.asarray(twists), bj, jnp.ones(W),
                  jnp.asarray(12.0, jnp.float32), jnp.zeros(3), step0, key, num_iterations=ITERS)

    bt = trays.build_window_buffers(dirs, depths, [None] * W, W, device=CPU)
    phase_t = topt.PhaseSettings(num_iterations=ITERS, freeze_poses=freeze_poses)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, phase_t, W, bt.dirs.shape[1],
                                   bt.sky_dirs.shape[1], CPU)
    out_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.occ_grid_from_jax(grid, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), step0, None, num_iterations=ITERS, draws=_jax_draws(key, ITERS, True))
    return twists, params_np, grid, out_j, out_t, cfg_t.lr_sigma


def _assert_ogm_hash_phases_match(params_np, grid, out_j, out_t, lr_sigma):
    """Losses, twists, MLP, table and grid of the two packages' phases, within the
    module docstring's tolerances."""
    field_j, grid_j, tw_j, losses_j, eps_j = out_j
    field_t, grid_t, tw_t, losses_t, eps_t = out_t
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=5e-6)
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v), atol=5e-5,
                                   err_msg=k)
    table_j = np.asarray(field_j["sigma"]["table"])
    diff = np.abs(field_t["sigma"]["table"].numpy() - table_j)
    assert np.quantile(diff, 0.999) <= 5e-6 and diff.max() <= 0.05 * lr_sigma, diff.max()
    assert np.abs(table_j - params_np["sigma"]["table"]).max() > 1e-3
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), atol=5e-5)
    assert np.abs(np.asarray(grid_j) - grid).max() > 1e-3  # the update at step 10
    np.testing.assert_array_equal(field_t["intensity"]["table"].numpy(),
                                  params_np["intensity"]["table"])


@pytest.mark.parametrize("encode_impl", ["vjp_f32", "vjp_bf16"])
def test_run_phase_at_ogm_and_hash_matches_jax(encode_impl):
    twists, params_np, grid, out_j, out_t, lr_sigma = _ogm_hash_phases(encode_impl, False)
    _assert_ogm_hash_phases_match(params_np, grid, out_j, out_t, lr_sigma)
    assert np.abs(out_t[2].numpy() - twists).max() > 1e-4


@pytest.mark.parametrize("encode_impl", ["vjp_f32", "vjp_bf16"])
def test_frozen_pose_phase_at_ogm_and_hash_matches_jax_without_dpos(encode_impl, monkeypatch):
    """The W=1 bootstrap's kind of phase: poses frozen. The port builds its rays
    from detached twists, so the hash backward runs without its dpos half; the
    results still match JAX's, which masks the twist gradient instead."""
    asked = []
    plain_bwd = thash_grid.hash_encode_bwd_plain

    def recording_bwd(*args, need_dpos=True, **kwargs):
        asked.append(need_dpos)
        return plain_bwd(*args, need_dpos=need_dpos, **kwargs)

    monkeypatch.setattr(thash_grid, "hash_encode_bwd_plain", recording_bwd)
    twists, params_np, grid, out_j, out_t, lr_sigma = _ogm_hash_phases(encode_impl, True)
    assert asked == [False] * ITERS
    _assert_ogm_hash_phases_match(params_np, grid, out_j, out_t, lr_sigma)
    np.testing.assert_array_equal(out_t[2].numpy(), twists)
    np.testing.assert_array_equal(np.asarray(out_j[2]), twists)


def test_make_phase_runner_rejects_what_is_not_ported():
    _, cfg_t, _, fcfg_t = _configs("PROPOSAL", 1.0)
    args = (W, 4096, 4096, CPU)
    # The default configuration is the reference's: OGM sampler, hash field.
    assert topt.OptimizerConfig().samples_strategy == "OGM"
    assert topt.make_phase_runner(topt.OptimizerConfig(), tfield.FieldConfig(),
                                  topt.PhaseSettings(), *args) is not None
    with pytest.raises(RuntimeError, match="encode_impl"):
        topt.make_phase_runner(topt.OptimizerConfig(encode_impl="pallas"), tfield.FieldConfig(),
                               topt.PhaseSettings(), *args)
    # The intensity head is ported: a phase that trains it builds, and without
    # camera samples it has no camera branch.
    runner = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(freeze_rgb_mlp=False), *args)
    assert not runner.use_camera
    # The per-iteration debug record is ported (formerly refused): a "ray" runner
    # runs and hands one record a dispatch to its sink; an unknown mode raises.
    uniform = replace(cfg_t, samples_strategy="UNIFORM")
    runner = topt.make_phase_runner(uniform, fcfg_t, topt.PhaseSettings(), *args,
                                    extras_mode="ray")
    dirs, depths, twists = _scans(W)
    buf = trays.build_window_buffers(dirs, depths, [None] * W, W)
    gen = torch.Generator().manual_seed(0)
    log = []
    out = runner(tfield.init_field_params(gen, fcfg_t, CPU), None, torch.from_numpy(twists),
                 buf, torch.ones(W), 12.0, torch.zeros(3), 0, gen, num_iterations=2, extras_log=log)
    assert torch.isfinite(out[3]).all() and len(log) == 2
    assert log[0]["rays"].shape == (1, W * N_LIDAR, 11) and log[0]["valid"].dtype == bool
    with pytest.raises(ValueError, match="extras_mode"):
        topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(), *args, extras_mode="all")


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
        # The reference's model: OGM sampler, hash sigma field, bf16 training encode.
        from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
        from loner_tpu_torch.models.occupancy_grid import init_occ_grid
        cfg = OptimizerConfig(n_lidar_samples=8, n_sky_samples=0, n_samples_per_ray=16,
                              samples_strategy="OGM", occ_voxel_size=8, occ_update_every=1)
        fcfg = FieldConfig(pos_encoding_sigma=HashEncodingConfig(n_levels=4,
                                                                 log2_hashmap_size=10),
                           sigma_mlp=MLPConfig(16, 1, 1),
                           pos_encoding_intensity=HashEncodingConfig(n_levels=2,
                                                                     log2_hashmap_size=10))
        run = make_phase_runner(cfg, fcfg, PhaseSettings(), 2, 4096, 4096, dev)
        params = init_field_params(gen, fcfg, dev)
        out = run(params, init_occ_grid(8, dev), torch.zeros(2, 6), buf, torch.ones(2), 12.0,
                  torch.zeros(3), 0, gen, num_iterations=1)
        assert torch.isfinite(out[3]).all() and out[1].abs().max() > 0
        assert not torch.equal(out[0]["sigma"]["table"], params["sigma"]["table"])
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


def test_port_renders_without_jax_optax_yaml_matplotlib_or_loner_tpu(tmp_path):
    script = textwrap.dedent("""
        import os, pickle, sys
        for m in ("jax", "optax", "yaml", "matplotlib"):
            sys.modules[m] = None
        import numpy as np
        import torch
        from loner_tpu_torch.analysis.renderer import render_dataset_frame, spherical_ray_directions
        from loner_tpu_torch.analysis.render_utils import load_experiment
        from loner_tpu_torch.analysis.renderer_lidar import render_full_map
        from loner_tpu_torch.common.pose import Pose
        from loner_tpu_torch.common.world_cube import WorldCube
        from loner_tpu_torch.mapping.mapper import build_ckpt, save_checkpoint
        from loner_tpu_torch.models.field import FieldConfig, init_field_params
        from loner_tpu_torch.models.proposal import ProposalConfig, init_proposal_params

        log_dir = sys.argv[1]
        nerf = {"encoding_sigma": "fourier", "compute_dtype": "bfloat16",
                "fourier_sigma": {"n_freqs": 8}, "sigma_network": {"n_neurons": 32,
                "n_hidden_layers": 2}, "intensity_network": {"n_neurons": 16,
                "n_hidden_layers": 1}, "pos_encoding_intensity": {"n_levels": 2,
                "log2_hashmap_size": 10}}
        model = {"data": {"ray_range": [1, 10]}, "model": {"nerf_config": nerf,
                 "num_colors": 3, "render": {"compositor": "pallas"},
                 "occ_model": {"prop_n_ctrl": 5}}}
        cube = WorldCube(12.0, np.zeros(3))
        os.makedirs(os.path.join(log_dir, "checkpoints"))
        with open(os.path.join(log_dir, "full_config.pkl"), "wb") as f:
            pickle.dump({"mapper": {"optimizer": {"model_config": model}},
                         "world_cube": cube.as_dict()}, f)
        dev = torch.device("cpu")
        gen = torch.Generator().manual_seed(0)
        params = init_field_params(gen, FieldConfig.from_settings(nerf), dev)
        prop = init_proposal_params(gen, ProposalConfig(n_freqs=8, n_neurons=16), dev)
        twist = Pose.from_twist(np.array([0.5, 0.0, 0.2, 0.0, 0.0, 0.3])).to_twist()
        poses = [{"timestamp": 0.0, "lidar_pose": twist}]
        save_checkpoint(os.path.join(log_dir, "checkpoints", "final.tar"),
                        build_ckpt(params, prop, poses, cube, 1))
        cloud = render_full_map(log_dir, num_channels=4, num_columns=8, n_samples=16,
                                var_threshold=1e6, device="cpu")
        # The reference's model: hash sigma field and an OGM grid checkpoint.
        hash_dir = os.path.join(log_dir, "hash")
        os.makedirs(os.path.join(hash_dir, "checkpoints"))
        hash_nerf = {"sigma_network": {"n_neurons": 16, "n_hidden_layers": 1},
                     "pos_encoding_sigma": {"n_levels": 4, "log2_hashmap_size": 10},
                     "intensity_network": {"n_neurons": 16, "n_hidden_layers": 1},
                     "pos_encoding_intensity": {"n_levels": 2, "log2_hashmap_size": 10}}
        with open(os.path.join(hash_dir, "full_config.pkl"), "wb") as f:
            pickle.dump({"mapper": {"optimizer": {"model_config": {
                "data": {"ray_range": [1, 10]},
                "model": {"nerf_config": hash_nerf, "num_colors": 3, "render": {}}}}},
                "world_cube": cube.as_dict()}, f)
        hash_params = init_field_params(gen, FieldConfig.from_settings(hash_nerf), dev)
        save_checkpoint(os.path.join(hash_dir, "checkpoints", "final.tar"),
                        build_ckpt(hash_params, torch.rand(8, 8, 8, generator=gen), poses, cube, 1))
        hash_cloud = render_full_map(hash_dir, num_channels=4, num_columns=8, n_samples=16,
                                     var_threshold=1e6, device="cpu")
        assert hash_cloud.shape[1] == 3 and np.isfinite(hash_cloud).all()
        assert load_experiment(hash_dir, device="cpu").occ_grid.shape == (8, 8, 8)
        assert cloud.shape[1] == 3 and cloud.shape[0] > 0 and np.isfinite(cloud).all()
        model = load_experiment(log_dir, device="cpu")
        frame = render_dataset_frame(model, np.eye(4), spherical_ray_directions(8, 4), (4, 8),
                                     n_samples=16)
        assert np.isfinite(frame["depth"]).all()
        bad = sorted(m for m in sys.modules
                     if m == "loner_tpu" or m.startswith("loner_tpu."))
        assert not bad, bad
        assert all(sys.modules[m] is None for m in ("jax", "optax", "yaml", "matplotlib"))
        print("render boundary ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path / "exp")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "render boundary ok" in proc.stdout, (
        proc.stdout + proc.stderr)


def test_port_runs_slam_without_jax_optax_yaml_or_loner_tpu(tmp_path):
    script = textwrap.dedent("""
        import importlib.abc, os, sys
        BLOCKED = ("jax", "optax", "yaml", "matplotlib")

        class Absent(importlib.abc.MetaPathFinder):
            # As on a machine without them (sys.modules[m] = None would trip
            # scipy's own probe for jax arrays).
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is not installed")
                return None

        sys.meta_path.insert(0, Absent())
        import torch
        import chip_smoke
        from loner_tpu_torch.common.settings import Settings
        from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
        from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence
        from loner_tpu_torch.run_loner import run_trial

        torch.set_num_threads(1)
        root = sys.argv[1]
        scans, poses, ts, _, _ = generate_sequence(
            num_scans=12, lidar=VirtualLidar(num_channels=16, num_columns=64), rate_hz=5.0)
        writer = ScanStreamWriter(os.path.join(root, "ds"))
        for s in scans:
            writer.add_scan(s)
        writer.write_gt(poses, ts)
        # The smoke test's flagship settings, single-threaded and cut to a CPU size.
        settings = Settings(chip_smoke.flagship_slam_settings(os.path.join(root, "out")))
        settings.augment({
            "system": {"single_threaded": True},
            "tracker": {"frame_synthesis": {"frame_decimation_rate_hz": 2.5},
                        "icp": {"downsample": {"target_uniform_point_count": 500}}},
            "mapper": {
                "keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 1.0}},
                                     "window_selection": {"window_size": 2}},
                "optimizer": {
                    "num_samples": {"lidar": 16},
                    "keyframe_schedule": [
                        {"num_keyframes": 1, "iteration_schedule": [
                            {"num_iterations": 3, "freeze_poses": True}]},
                        {"num_keyframes": -1, "iteration_schedule": [{"num_iterations": 2}]}],
                    "model_config": {"model": {
                        "render": {"N_samples_train": 16},
                        "nerf_config": {"fourier_sigma": {"n_freqs": 8},
                                        "sigma_network": {"n_neurons": 32}},
                        "occ_model": {"prop_n_ctrl": 5,
                                      "proposal": {"n_freqs": 8, "n_neurons": 16}}}}}},
        })
        log_dir = run_trial(settings, os.path.join(root, "ds"), experiment_name="boundary",
                            device="cpu")
        for f in ("checkpoints/final.tar", "trajectory/estimated_trajectory.txt",
                  "full_config.yaml", "world_cube.yaml", "runtime.txt"):
            assert os.path.exists(os.path.join(log_dir, f)), f
        # Mid-run resume (runtime/resume.py) of that run, in place.
        assert run_trial(settings, os.path.join(root, "ds"), resume_from=log_dir,
                         device="cpu") == log_dir
        # The smoke test's reference settings (hash sigma field, OGM), cut the same way.
        settings = Settings(chip_smoke.box_room_settings(os.path.join(root, "out")))
        settings.augment({
            "system": {"single_threaded": True},
            "tracker": {"frame_synthesis": {"frame_decimation_rate_hz": 2.5,
                                            "decimate_on_load": False},
                        "icp": {"downsample": {"target_uniform_point_count": 500}}},
            "mapper": {
                "keyframe_manager": {"keyframe_selection": {"temporal": {"time_diff_seconds": 1.0}},
                                     "window_selection": {"window_size": 2}},
                "optimizer": {
                    "num_samples": {"lidar": 16},
                    "keyframe_schedule": [
                        {"num_keyframes": 1, "iteration_schedule": [
                            {"num_iterations": 3, "freeze_poses": True}]},
                        {"num_keyframes": -1, "iteration_schedule": [{"num_iterations": 2}]}],
                    "model_config": {"model": {
                        "render": {"N_samples_train": 16},
                        "occ_model": {"voxel_size": 8},
                        "nerf_config": {"pos_encoding_sigma": {"n_levels": 4,
                                                               "log2_hashmap_size": 10},
                                        "pos_encoding_intensity": {"n_levels": 2,
                                                                   "log2_hashmap_size": 10}}}}}},
        })
        log_dir = run_trial(settings, os.path.join(root, "ds"), experiment_name="boundary_hash",
                            device="cpu")
        assert os.path.exists(os.path.join(log_dir, "checkpoints", "final.tar"))
        # The map-quality path on that run, cut to a CPU size: GT map, map cloud,
        # masked GT, F-score, L1, mesh, regression record.
        import functools
        from loner_tpu_torch.analysis import (
            create_lidar_map, eval_map_quality, evaluate_lidar_map, l1_breakdown, mesh_to_pcd,
            mesher, metrics_pipeline)
        evaluate_lidar_map.ICP_SCHEDULE = [{"threshold": 0.5, "max_iterations": 1}]
        mesher.build_weight_grid = functools.partial(
            mesher.build_weight_grid, n_samples=16, num_channels=4, num_columns=16, chunk=64)
        gt_map = create_lidar_map.build_gt_map(os.path.join(root, "ds"))
        eval_map_quality.render_full_map = functools.partial(
            eval_map_quality.render_full_map, num_channels=4, num_columns=16, n_samples=16)
        eval_map_quality.compute_l1_depth = functools.partial(
            eval_map_quality.compute_l1_depth, num_frames=2, rays_per_frame=32, n_samples=16)
        out = eval_map_quality.eval_map_quality(log_dir, gt_map, device="cpu", var_threshold=1e6)
        assert out["l1"]["num_rays"] > 0 and 0.0 <= out["statistics"]["f_score"] <= 1.0
        from loner_tpu_torch.analysis.sky_floaters import sky_floaters
        floaters = sky_floaters(log_dir, gt_map, n_probe_rays=16, device="cpu")
        assert 0.0 <= floaters["mean_sky_opacity"] <= 1.0
        split = l1_breakdown.l1_breakdown(log_dir, device="cpu", num_frames=2,
                                          rays_per_frame=32, n_samples=16)
        assert split["num_rays"] == out["l1"]["num_rays"]
        mesher.get_mesh(log_dir, resolution=16, level=1e-3, skip_step=1, device="cpu")
        mesh_to_pcd.read_ply(os.path.join(log_dir, "meshing", "mesh.ply"))
        record = metrics_pipeline.write_regression_file(log_dir)
        assert {"ate_rmse", "map_f_score", "l1_mean"} <= set(record["trials"]["."])
        bad = sorted(m for m in sys.modules
                     if m == "loner_tpu" or m.startswith("loner_tpu."))
        assert not bad, bad
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("slam boundary ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "slam boundary ok" in proc.stdout, (
        proc.stdout + proc.stderr)


def test_port_runs_a_camera_trial_without_jax_optax_yaml_or_loner_tpu(tmp_path):
    """The camera branch at the import boundary: ``box_room_camera.yaml`` read
    from cfg/ by the port's YAML reader, a tiny single-threaded camera trial, its
    mid-run resume (keyframes re-matched to their images) and ``compute_psnr``,
    with jax, optax and yaml unimportable."""
    script = textwrap.dedent("""
        import importlib.abc, os, sys
        BLOCKED = ("jax", "optax", "yaml", "matplotlib")

        class Absent(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is not installed")
                return None

        sys.meta_path.insert(0, Absent())
        import torch
        from loner_tpu_torch.analysis.compute_psnr import compute_psnr
        from loner_tpu_torch.common.settings import load_config
        from loner_tpu_torch.datasets import synthetic as syn
        from loner_tpu_torch.run_loner import run_trial

        torch.set_num_threads(1)
        root = sys.argv[1]
        scans, poses, ts, scene, _ = syn.generate_sequence(
            num_scans=12, lidar=syn.VirtualLidar(num_channels=16, num_columns=64), rate_hz=5.0)
        ds = syn.write_sequence(os.path.join(root, "ds"), scans, poses, ts, scene=scene,
                                camera=syn.VirtualCamera())
        settings, _ = load_config("cfg/synthetic/box_room_camera.yaml")
        settings.augment({
            "system": {"log_dir_prefix": os.path.join(root, "out") + "/"},
            "mapper": {"log_level": "VERBOSE", "optimizer": {
                "num_samples": {"lidar": 16, "camera": 16},
                "keyframe_schedule": [
                    {"num_keyframes": 1, "iteration_schedule": [
                        {"num_iterations": 3, "freeze_poses": True, "freeze_rgb_mlp": False}]},
                    {"num_keyframes": -1, "iteration_schedule": [
                        {"num_iterations": 2, "freeze_rgb_mlp": False}]}],
                "model_config": {"model": {
                    "render": {"N_samples_train": 16},
                    "nerf_config": {"fourier_sigma": {"n_freqs": 8},
                                    "sigma_network": {"n_neurons": 32},
                                    "intensity_network": {"n_neurons": 16}},
                    "occ_model": {"proposal": {"n_freqs": 8, "n_neurons": 16}}}}}},
        })
        log_dir = run_trial(settings, ds, experiment_name="camera", duration=1.2, device="cpu")
        assert run_trial(settings, ds, resume_from=log_dir, device="cpu") == log_dir
        result = compute_psnr(log_dir, num_images=2, n_samples=16, device="cpu")
        assert os.path.exists(os.path.join(log_dir, "metrics", "psnr.yaml"))
        assert result["num_images"] >= 1
        bad = sorted(m for m in sys.modules
                     if m == "loner_tpu" or m.startswith("loner_tpu."))
        assert not bad, bad
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("camera boundary ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "camera boundary ok" in proc.stdout, (
        proc.stdout + proc.stderr)


def test_port_ingests_a_bag_and_sweeps_without_jax_optax_yaml_or_loner_tpu(tmp_path):
    """The ingest and the runner's sweeps at the import boundary: the port's bag
    generator, reader and converter (its C++ host ops built and called), the
    OpenCV calibration reader, the drill's metrics pipeline, and
    ``generate_options`` and ``run_loner.main``'s sweep, repeat, lite and
    synthetic flags (run_trial recorded), with jax, optax and yaml unimportable."""
    script = textwrap.dedent("""
        import importlib.abc, os, sys
        BLOCKED = ("jax", "optax", "yaml", "matplotlib")

        class Absent(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is not installed")
                return None

        sys.meta_path.insert(0, Absent())
        import numpy as np
        from loner_tpu_torch import convert_rosbag, real_data_drill, run_loner
        from loner_tpu_torch.common.settings import generate_options
        from loner_tpu_torch.datasets import synthetic_bag
        from loner_tpu_torch.datasets.calibration import FusionPortableCalibration
        from loner_tpu_torch.datasets.rosbag_reader import Bag, bag_topics
        from loner_tpu_torch.datasets.scan_stream import ScanStreamReader
        from loner_tpu_torch.ops import scan_ops

        root = sys.argv[1]
        bag = os.path.join(root, "x.bag")
        synthetic_bag.main([bag, "--duration", "0.4", "--rate", "5", "--channels", "8",
                            "--columns", "32", "--timestamp_mode", "epoch_f64"])
        assert bag_topics(bag)["/tf"] == "tf2_msgs/TFMessage"
        with Bag(bag) as b:
            assert len(list(b.read_messages(["/os_cloud_node/points"]))) == 2
        real_data_drill.convert(bag, os.path.join(root, "ds"))
        scan = ScanStreamReader(os.path.join(root, "ds")).read_scan(1)
        assert len(scan) > 200 and scan.timestamps[0] > 1.7e9
        pts = (scan.ray_directions * scan.distances).T
        assert scan_ops.voxel_downsample(pts, 0.5).shape[1] == 3
        assert scan_ops.fov_mask(scan.ray_directions, [[0, 180]]).any()
        os.makedirs(os.path.join(root, "calib"))
        with open(os.path.join(root, "calib", "frame_left.yaml"), "w") as f:
            f.write("%YAML:1.0\\n---\\nimage_width: 64\\nimage_height: 48\\n"
                    "camera_matrix: !!opencv-matrix\\n   rows: 3\\n   cols: 3\\n   dt: d\\n"
                    "   data: [ 40., 0., 32.,\\n       0., 40., 24., 0., 0., 1. ]\\n"
                    "distortion_coefficients: !!opencv-matrix\\n   rows: 1\\n   cols: 5\\n"
                    "   dt: d\\n   data: [ -2.8e-01, 7.3e-02, 0., 0., 0. ]\\n")
        cal = FusionPortableCalibration(root, 0.5)
        assert cal.left_cam_intrinsic["k"][0, 0] == 20.0 and cal.left_cam_intrinsic["width"] == 32
        options, desc = generate_options("cfg/synthetic/box_room.yaml", "cfg/ablation_study.yaml")
        assert len(options) == len(desc) == 13
        calls = []
        run_loner.run_trial = lambda s, d, **kw: calls.append((s, d, kw))
        run_loner.main(["ds", "cfg/synthetic/box_room.yaml", "--overrides",
                        "cfg/kf_selection_ablation.yaml", "--num_repeats", "2", "--lite"])
        assert [kw["trial_idx"] for _, _, kw in calls] == [0, 1] * 5
        os.chdir(root)
        run_loner.main(["synthetic", os.path.join(os.environ["REPO"], "cfg/synthetic/box_room.yaml"),
                        "--synthetic_scans", "2"])
        assert calls[-1][1] == "./outputs/synthetic_dataset_2"
        assert len(ScanStreamReader(calls[-1][1])) == 2
        bad = sorted(m for m in sys.modules
                     if m == "loner_tpu" or m.startswith("loner_tpu."))
        assert not bad, bad
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("ingest boundary ok")
    """)
    env = dict(os.environ, REPO=str(REPO),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "ingest boundary ok" in proc.stdout, (
        proc.stdout + proc.stderr)


def test_port_runs_debug_dumps_and_offline_tools_without_jax_yaml_matplotlib_pil_or_cv2(
        tmp_path):
    """The debug dumps and the offline tools at the import boundary: a tiny
    single-threaded SLAM trial with every debug flag on (frame clouds, ray
    clouds, loss CSVs, store_ray, draw_samples, draw_rays_eps), then
    ``render_flythrough`` on its checkpoint (frames, video), ``plot_poses``,
    ``visualize_loss`` and ``write_mjpeg_avi``, with jax, optax, yaml,
    matplotlib, PIL and cv2 unimportable."""
    script = textwrap.dedent("""
        import importlib.abc, os, sys
        BLOCKED = ("jax", "optax", "yaml", "matplotlib", "PIL", "cv2")

        class Absent(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is not installed")
                return None

        sys.meta_path.insert(0, Absent())
        import numpy as np
        import torch
        import chip_smoke
        from loner_tpu_torch.analysis.plot_poses import plot_poses
        from loner_tpu_torch.analysis.raster_plot import read_plot
        from loner_tpu_torch.analysis.renderer import render_flythrough
        from loner_tpu_torch.analysis.video import read_avi_frame_count, write_mjpeg_avi
        from loner_tpu_torch.common.settings import Settings
        from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
        from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence
        from loner_tpu_torch.run_loner import run_trial
        from loner_tpu_torch.runtime.debug_artifacts import visualize_loss

        torch.set_num_threads(1)
        root = sys.argv[1]
        scans, poses, ts, _, _ = generate_sequence(
            num_scans=12, lidar=VirtualLidar(num_channels=16, num_columns=64), rate_hz=5.0)
        writer = ScanStreamWriter(os.path.join(root, "ds"))
        for s in scans:
            writer.add_scan(s)
        writer.write_gt(poses, ts)
        settings = Settings(chip_smoke.debug_slam_settings(os.path.join(root, "out")))
        settings.augment(chip_smoke.CPU_SLAM_CUT)
        log_dir = run_trial(settings, os.path.join(root, "ds"), experiment_name="debug",
                            device="cpu")
        found = chip_smoke.check_debug_dumps(log_dir)
        assert found["frames"] >= 2 and found["keyframes"] >= 2, found
        out = render_flythrough(log_dir, width=16, height=8, steps_between=2, spin_every=1,
                                spin_steps=2, n_samples=16, device="cpu")
        n = len(open(os.path.join(out, "frames.txt")).read().split())
        assert read_avi_frame_count(os.path.join(out, "flythrough.avi")) == (n, (8, 16), 10)
        _, meta = read_plot(plot_poses(log_dir))
        assert [s["label"] for s in meta["Series"]] == ["ground truth", "tracked", "optimized"]
        z = np.linspace(1, 9, 32)[None]
        visualize_loss(z, np.full((1, 32), 0.1), np.full((1, 32), 0.2), 5.0, 1.0, 0.5, log_dir, 3)
        frames = [np.full((16, 16, 3), 40 * i, np.uint8) for i in range(3)]
        assert read_avi_frame_count(write_mjpeg_avi(os.path.join(root, "v.avi"), frames)) == (
            3, (16, 16), 10)
        bad = sorted(m for m in sys.modules
                     if m == "loner_tpu" or m.startswith("loner_tpu."))
        assert not bad, bad
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("debug boundary ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "debug boundary ok" in proc.stdout, (
        proc.stdout + proc.stderr)
