"""Sky-ray supervision in the PyTorch port against the JAX package, on the CPU.

- ``sample_and_build_rays`` with sky rays on JAX's own draws (the LiDAR and the
  sky uniforms of ``jax.random.split(k_rays)``): rays, depths and validity to
  the tolerances of ``tests/test_torch_step.py`` (1e-6 on cube coordinates),
  the twist gradient to 1e-5 of its scale; the sky rays' part of the twist
  gradient is exactly zero in the port (they are built from detached poses).
- Three iterations of ``make_phase_runner`` with ``enable_sky`` against JAX's,
  on JAX's draws, at PROPOSAL + Fourier and at OGM + hash (both as in
  ``tests/test_torch_step.py``, with 4 sky rays a slot): at PROPOSAL + Fourier
  losses rtol 2e-5, twists and weights at that file's tolerances; at OGM + hash
  one iteration's gradients to rounding (the entries only sky rays reach also
  against their own magnitude), one iteration through Adam at that file's
  tolerances (the table per entry by Adam's response to rounding), then three
  at the tolerances that test states (Adam turns rounding of gradients near
  its eps into larger steps, which later iterations carry on).
- The skylight check of ``tests/test_sky_supervision.py`` on the port: one
  skylight keyframe fitted 300 iterations with and without sky rays; along
  the extracted sky directions inside the opening the mean opacity with sky
  rays is below 0.6 x the one without, and below 0.35.
- ``analysis/sky_floaters.py`` against ``examples/scripts/sky_floater_metric.py``
  on one experiment directory and one saved map cloud: the floater count equal,
  the opacities to 2e-5 relative (f32, the two packages' Fourier phase in
  another order, as in ``tests/test_torch_render.py``).
"""
import os
import runpy
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from loner_tpu.mapping import optimizer as jopt
from loner_tpu.mapping import rays as jrays
from loner_tpu.models import field as jfield
from loner_tpu.models.proposal import init_proposal_params
from loner_tpu_torch import convert
from loner_tpu_torch.common.frame import Frame
from loner_tpu_torch.common.json_yaml import read_json_yaml
from loner_tpu_torch.common.pose import Pose
from loner_tpu_torch.datasets.synthetic import BoxRoomScene, VirtualLidar, make_scan
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.mapping.keyframe import KeyFrame
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig as THash
from loner_tpu_torch.models.rendering import UniformRaySampler, pack_rays, render_rays
from loner_tpu_torch.tracking.tracker import Tracker

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_step import (  # noqa: E402
    ITERS, N_LIDAR, S, W, _configs, _hash_configs, _scans,
    jax_step_draws,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N_SKY = 4


def _sky_dirs(w: int, n: int = 40, seed: int = 1):
    """Upward unit directions per slot; the last slot has none."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(w):
        if i == w - 1:
            out.append(None)
            continue
        d = rng.normal(size=(3, n))
        d[2] = np.abs(d[2]) + 0.5
        out.append((d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32))
    return out


@pytest.mark.parametrize("n_scans", [3, 2])
def test_sample_and_build_rays_with_sky_matches_jax(n_scans):
    dirs, depths, twists = _scans(n_scans, n=50)
    sky = _sky_dirs(n_scans)
    twists = np.resize(twists, (3, 6)).astype(np.float32)
    bj = jrays.build_window_buffers(dirs, depths, sky, 3, sky_pad=64)
    bt = trays.build_window_buffers(dirs, depths, sky, 3, sky_pad=64, device=CPU)
    for name in ("sky_dirs", "sky_counts", "slot_valid"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)))

    key = jax.random.key(4)
    shift = np.asarray([0.3, -0.1, 0.2], np.float32)
    n = 16 + N_SKY
    c = np.random.default_rng(5).normal(size=(3 * n, 11)).astype(np.float32)

    def f_j(tw):
        rays, depths_cube, valid = jrays.sample_and_build_rays(
            key, bj, tw, jnp.asarray(12.0), jnp.asarray(shift), (1.0, 10.0), 16, N_SKY)
        return (rays * c).sum(), (rays, depths_cube, valid)

    (_, (rays_j, dc_j, valid_j)), g_j = jax.value_and_grad(f_j, has_aux=True)(jnp.asarray(twists))
    k_lidar, k_sky = jax.random.split(key)
    u = torch.tensor(np.asarray(jax.random.uniform(k_lidar, (3, 16))))
    sky_u = torch.tensor(np.asarray(jax.random.uniform(k_sky, (3, N_SKY))))

    def port(weights):
        tw = torch.tensor(twists, requires_grad=True)
        rays, dc, valid = trays.sample_and_build_rays(
            bt, tw, torch.tensor(12.0), torch.tensor(shift), (1.0, 10.0), 16, N_SKY, u=u,
            sky_u=sky_u)
        (rays * torch.tensor(weights)).sum().backward()
        return rays.detach(), dc, valid, tw.grad

    rays_t, dc_t, valid_t, g_t = port(c)
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), atol=1e-6)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), atol=1e-7)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    scale = max(np.abs(np.asarray(g_j)).max(), 1.0)
    np.testing.assert_allclose(g_t.numpy() / scale, np.asarray(g_j) / scale, atol=1e-5)

    is_sky = np.tile(np.arange(n) >= 16, 3)
    valid = valid_t.numpy()
    assert valid[is_sky].any() and not valid[is_sky].reshape(3, N_SKY)[n_scans - 1:].any()
    np.testing.assert_array_equal(dc_t.numpy()[is_sky], np.float32(11.0) / np.float32(12.0))
    # Sky rays add nothing to the twist gradient.
    only_sky = np.where(is_sky[:, None], c, 0.0).astype(np.float32)
    assert not port(only_sky)[3].any()
    only_lidar = np.where(is_sky[:, None], 0.0, c).astype(np.float32)
    np.testing.assert_array_equal(port(only_lidar)[3].numpy(), g_t.numpy())


def _sky_window(seed: int):
    dirs, depths, twists = _scans(W, seed=seed)
    sky = _sky_dirs(W + 1)[:W]  # every slot has sky directions
    return dirs, depths, sky, twists


def _sky_draws(key, ogm: bool):
    return [jax_step_draws(jax.random.fold_in(jax.random.fold_in(key, i), 1), W, N_LIDAR, S,
                           ogm, n_sky=N_SKY) for i in range(ITERS)]


def _with_sky(cfg_j, cfg_t):
    return (replace(cfg_j, enable_sky=True, n_sky_samples=N_SKY),
            replace(cfg_t, enable_sky=True, n_sky_samples=N_SKY))


def test_draws_with_sky_keep_the_sky_off_draws():
    """Sky-off configurations draw what they drew before sky rays were ported;
    with sky rays on, the per-ray draws cover W * (n_lidar + n_sky) rays."""
    _, cfg, _, _ = _configs("PROPOSAL", 1.0)
    off = topt.draw_step(torch.Generator().manual_seed(3), cfg, W, CPU)
    assert off.sky_u is None and off.noise.shape == (W * N_LIDAR, S)
    sky_cfg = replace(cfg, enable_sky=True, n_sky_samples=N_SKY)
    on = topt.draw_step(torch.Generator().manual_seed(3), sky_cfg, W, CPU)
    assert on.sky_u.shape == (W, N_SKY) and on.noise.shape == (W * (N_LIDAR + N_SKY), S)
    torch.testing.assert_close(on.ray_u, off.ray_u, rtol=0, atol=0)
    # sky_u comes after every LiDAR draw; only the camera branch's come after it.
    sky_at = topt.DRAW_FIELDS.index("sky_u")
    assert topt.DRAW_FIELDS[:sky_at] == ("ray_u", "jitter", "noise", "pdf_u")
    assert all(name.startswith("cam_") for name in topt.DRAW_FIELDS[sky_at + 1:])


def test_run_phase_with_sky_at_proposal_and_fourier_matches_jax():
    cfg_j, cfg_t, fcfg_j, fcfg_t = _configs("PROPOSAL", 1.0)
    cfg_j, cfg_t = _with_sky(cfg_j, cfg_t)
    dirs, depths, sky, twists = _sky_window(0)
    params = jfield.init_field_params(jax.random.key(0), fcfg_j)
    prop = init_proposal_params(jax.random.key(5), cfg_j.proposal)
    params_np, prop_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, prop)
    key = jax.random.key(1)

    bj = jrays.build_window_buffers(dirs, depths, sky, W)
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, jopt.PhaseSettings(num_iterations=ITERS), W,
                                   bj.dirs.shape[1], bj.sky_dirs.shape[1])
    field_j, prop_j, tw_j, losses_j, eps_j = run_j(
        params, prop, jnp.asarray(twists), bj, jnp.ones(W), jnp.asarray(12.0, jnp.float32),
        jnp.zeros(3), 0, key, num_iterations=ITERS)

    bt = trays.build_window_buffers(dirs, depths, sky, W, device=CPU)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(num_iterations=ITERS), W,
                                   bt.dirs.shape[1], bt.sky_dirs.shape[1], CPU)
    field_t, prop_t, tw_t, losses_t, eps_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.proposal_params_from_jax(prop_np, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), 0, None, num_iterations=ITERS, draws=_sky_draws(key, False))

    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=5e-6)
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v),
                                   atol=5e-6, err_msg=k)
    for k, v in prop_j.items():
        np.testing.assert_allclose(prop_t[k].numpy(), np.asarray(v), atol=5e-6, err_msg=k)


def _sky_hash_setup():
    cfg_j, cfg_t, fcfg_j, fcfg_t = _hash_configs("vjp_f32")
    cfg_j, cfg_t = _with_sky(cfg_j, cfg_t)
    dirs, depths, sky, twists = _sky_window(3)
    params = jfield.init_field_params(jax.random.key(2), fcfg_j)
    grid = np.asarray(jax.random.normal(jax.random.key(8), (16, 16, 16))) * 0.1
    bj = jrays.build_window_buffers(dirs, depths, sky, W)
    bt = trays.build_window_buffers(dirs, depths, sky, W, device=CPU)
    return cfg_j, cfg_t, fcfg_j, fcfg_t, twists, params, grid, bj, bt


def _port_sky_gradients(cfg_t, fcfg_t, params, grid, twists, bt, draws):
    """The port's loss and its gradients (hash table, MLP leaves by name, twists)
    for one iteration on ``draws``."""
    sigma = convert.field_params_from_jax(jax.tree.map(np.asarray, params), CPU)["sigma"]
    names = sorted(sigma["mlp"])
    leaves = [sigma["table"]] + [sigma["mlp"][k] for k in names]
    tw = torch.tensor(twists, requires_grad=True)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = topt.iteration_loss(
        cfg_t, topt.training_field_cfg(cfg_t, fcfg_t), sigma, convert.occ_grid_from_jax(grid, CPU),
        tw, {}, bt, torch.tensor(12.0), torch.zeros(3), draws)
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves + [tw])]
    return float(loss.detach()), grads[0], dict(zip(names, grads[1:-1])), grads[-1]


def _lidar_reached(cfg_t, fcfg_t, params, grid, twists, bt, draws):
    """Table entries that the LiDAR rays reach: those with a gradient when the
    same draws run with no sky directions in any slot (sky rays all invalid)."""
    no_sky = replace(bt, sky_counts=torch.zeros_like(bt.sky_counts))
    return _port_sky_gradients(cfg_t, fcfg_t, params, grid, twists, no_sky, draws)[1] != 0


def test_sky_iteration_gradients_at_ogm_and_hash_match_jax():
    """One iteration's loss and its gradients with sky rays, OGM sampler and hash
    field, on JAX's draws. Every table and MLP entry to 1e-5 of the largest
    (f32 sums in another order; measured 1.6e-6 for the table, 5.5e-6 for the
    MLP), the twists to 1e-4 (a cancelling sum: measured 5.3e-5, 3.3e-5
    without sky rays). The table entries that only sky rays reach are also held
    to their own magnitude: where the gradient is at least 1e-6 of the largest,
    the same sign and 2e-2 relative (measured 7.4e-3). Below that the sums
    cancel (T_end / (1 - alpha) on rays whose opacity rounds to 1) and only the
    absolute bound holds."""
    from loner_tpu.mapping.loss import compute_lidar_loss
    from loner_tpu.models.hash_encoding import hash_encode_train
    from loner_tpu.models.rendering import OccGridRaySampler

    cfg_j, cfg_t, fcfg_j, fcfg_t, twists, params, grid, bj, bt = _sky_hash_setup()
    key = jax.random.key(9)
    k_rays, _, k_render = jax.random.split(key, 3)
    encode = hash_encode_train(compute_dtype=jnp.float32, residual_dtype=jnp.float32)

    def loss_j(table, mlp, tw):
        rays, depths_cube, valid = jrays.sample_and_build_rays(
            k_rays, bj, tw, jnp.asarray(12.0), jnp.zeros(3), cfg_j.ray_range, N_LIDAR, N_SKY)
        p = {**params, "sigma": {"table": table, "mlp": mlp}}
        return compute_lidar_loss(
            k_render, rays, depths_cube, valid, p, fcfg_j, OccGridRaySampler(),
            jnp.asarray(grid), cfg_j.loss, jnp.asarray(12.0), S, cfg_j.perturb,
            cfg_j.raw_noise_std, 0.0, 0.0, encode_fn=encode, point_chunk=0,
            remat_blocks=False)[0]

    loss_jv, (table_j, mlp_j, tw_j) = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        params["sigma"]["table"], params["sigma"]["mlp"], jnp.asarray(twists))
    draws = jax_step_draws(key, W, N_LIDAR, S, True, n_sky=N_SKY)
    loss_t, table_t, mlp_t, tw_t = _port_sky_gradients(cfg_t, fcfg_t, params, grid, twists, bt,
                                                       draws)

    assert loss_t == pytest.approx(float(loss_jv), rel=2e-6)
    table_j = np.asarray(table_j)
    scale = np.abs(table_j).max()
    np.testing.assert_allclose(table_t, table_j, atol=1e-5 * scale)
    for k, v in mlp_j.items():
        v = np.asarray(v)
        np.testing.assert_allclose(mlp_t[k], v, atol=1e-5 * np.abs(v).max(), err_msg=k)
    tw_j = np.asarray(tw_j)
    np.testing.assert_allclose(tw_t, tw_j, atol=1e-4 * np.abs(tw_j).max())

    sky_only = (table_t != 0) & ~_lidar_reached(cfg_t, fcfg_t, params, grid, twists, bt, draws)
    held = sky_only & (np.abs(table_j) >= 1e-6 * scale)
    assert held.sum() > 1000 and np.abs(table_j[sky_only]).max() > 0.1 * scale
    np.testing.assert_array_equal(np.sign(table_t[held]), np.sign(table_j[held]))
    np.testing.assert_allclose(table_t[held], table_j[held], rtol=2e-2)


def test_one_sky_iteration_at_ogm_and_hash_matches_jax_through_adam():
    """One iteration of the phase runner (gradients, Adam, no grid update at
    step 9) with sky rays at OGM + hash, on JAX's draws: losses, depth_eps,
    twists, MLP and grid at the tolerances of ``tests/test_torch_step.py``. The
    table per entry: Adam's first step is lr g / (|g| + 1e-8), so where |g| is
    near 1e-8 a gradient's rounding becomes a larger step difference. Each entry
    is held to 5e-6 plus the step difference that a gradient error of 1e-5 of
    the largest gradient (the bound above) allows it, lr 1e-5 max|g| / (|g| +
    1e-8); that is below 1e-5 wherever |g| is above 2e-8 of the largest."""
    cfg_j, cfg_t, fcfg_j, fcfg_t, twists, params, grid, bj, bt = _sky_hash_setup()
    params_np = jax.tree.map(np.asarray, params)
    key, step0 = jax.random.key(9), 9
    draws = _sky_draws(key, True)[:1]
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, jopt.PhaseSettings(num_iterations=1), W,
                                   bj.dirs.shape[1], bj.sky_dirs.shape[1])
    field_j, grid_j, tw_j, losses_j, eps_j = run_j(
        params, jnp.asarray(grid), jnp.asarray(twists), bj, jnp.ones(W),
        jnp.asarray(12.0, jnp.float32), jnp.zeros(3), step0, key, num_iterations=1)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(num_iterations=1), W,
                                   bt.dirs.shape[1], bt.sky_dirs.shape[1], CPU)
    field_t, grid_t, tw_t, losses_t, eps_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.occ_grid_from_jax(grid, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), step0, None, num_iterations=1, draws=draws)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=5e-6)
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v), atol=5e-5,
                                   err_msg=k)
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), atol=5e-5)

    g = _port_sky_gradients(cfg_t, fcfg_t, params, grid, twists, bt, draws[0])[1]
    table_j = np.asarray(field_j["sigma"]["table"])
    diff = np.abs(field_t["sigma"]["table"].numpy() - table_j)
    bound = 5e-6 + cfg_t.lr_sigma * 1e-5 * np.abs(g).max() / (np.abs(g) + 1e-8)
    assert (diff <= bound).all(), np.max(diff / bound)
    moved = np.abs(table_j - params_np["sigma"]["table"]) > 1e-3
    sky_only = (g != 0) & ~_lidar_reached(cfg_t, fcfg_t, params, grid, twists, bt, draws[0])
    assert (moved & sky_only).sum() > 1000  # sky rays move the table
    assert np.abs(tw_t.numpy() - twists).max() > 1e-4


def test_run_phase_with_sky_at_ogm_and_hash_matches_jax():
    """Three iterations from global step 9 (the grid moves at 10). After the
    first iteration the table already differs by the Adam steps of entries
    whose gradient is near 1e-8 (up to 0.28 lr, held above), and those feed
    every later iteration: the MLP and table then differ by more than a
    gradient's rounding. Losses and the grid at the step tests' tolerances;
    depth_eps 1e-4 relative, the twists 1e-4, the MLP 5e-3 and the table's
    0.99 quantile 2.5e-4 (measured after three iterations: 3.7e-5, 4.0e-5,
    2.2e-3, 7.1e-5, where an entry moves up to 3 lr = 0.03)."""
    cfg_j, cfg_t, fcfg_j, fcfg_t, twists, params, grid, bj, bt = _sky_hash_setup()
    params_np = jax.tree.map(np.asarray, params)
    key, step0 = jax.random.key(9), 9
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, jopt.PhaseSettings(num_iterations=ITERS), W,
                                   bj.dirs.shape[1], bj.sky_dirs.shape[1])
    field_j, grid_j, tw_j, losses_j, eps_j = run_j(
        params, jnp.asarray(grid), jnp.asarray(twists), bj, jnp.ones(W),
        jnp.asarray(12.0, jnp.float32), jnp.zeros(3), step0, key, num_iterations=ITERS)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(num_iterations=ITERS), W,
                                   bt.dirs.shape[1], bt.sky_dirs.shape[1], CPU)
    field_t, grid_t, tw_t, losses_t, eps_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.occ_grid_from_jax(grid, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), step0, None, num_iterations=ITERS, draws=_sky_draws(key, True))
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=1e-4)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=1e-4)
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v), atol=5e-3,
                                   err_msg=k)
    table_j = np.asarray(field_j["sigma"]["table"])
    diff = np.abs(field_t["sigma"]["table"].numpy() - table_j)
    assert np.quantile(diff, 0.99) <= 2.5e-4, np.quantile(diff, 0.99)
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), atol=5e-5)
    assert np.abs(np.asarray(grid_j) - grid).max() > 1e-3  # the update at step 10
    assert np.abs(tw_t.numpy() - twists).max() > 1e-4


def _skylight_frame():
    """The skylight room of tests/test_sky_supervision.py: a 4 x 3 m opening in
    the ceiling, so the sky directions lie inside the spherical image."""
    scene = BoxRoomScene(top_opening=(np.array([-2.0, -1.5]), np.array([2.0, 1.5])))
    lidar = VirtualLidar(num_channels=48, num_columns=256, vertical_fov_deg=(-30.0, 80.0),
                         max_range=40.0)
    pose = np.eye(4)
    pose[:3, 3] = [0.0, 0.0, 0.5]
    frame = Frame(make_scan(scene, lidar, Pose(pose), 0.0, seed=0))
    frame._lidar_pose = Pose(pose)
    Tracker.compute_sky_rays(object.__new__(Tracker), frame)
    return frame


def _skylight_opacity(enable_sky: bool, iters: int = 300) -> float:
    frame = _skylight_frame()
    cfg = topt.OptimizerConfig(
        n_lidar_samples=256, n_sky_samples=64, n_samples_per_ray=64, window_size=1,
        ray_range=(0.3, 18.0), samples_strategy="UNIFORM", enable_sky=enable_sky,
        raw_noise_std=0.0)
    field_cfg = tfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=tfield.FourierConfig(n_freqs=32, scale=8.0),
        sigma_mlp=tfield.MLPConfig(n_neurons=64, n_hidden_layers=2, output_dim=1),
        density_activation="softplus", sigma_mlp_bias=True,
        pos_encoding_intensity=THash(n_levels=2, log2_hashmap_size=10))
    schedule = [{"num_keyframes": -1, "iteration_schedule": [
        {"num_iterations": iters, "freeze_poses": True, "freeze_sigma_mlp": False,
         "freeze_rgb_mlp": True}]}]
    world_scale = 10.0
    opt = topt.Optimizer(cfg, field_cfg, world_scale, np.zeros(3, np.float32), schedule, CPU,
                         seed=3)
    opt.iterate_optimizer([KeyFrame(frame)])

    sky = frame.lidar_points.sky_rays
    elev = 90.0 - np.rad2deg(np.arctan2(np.sqrt(sky[0] ** 2 + sky[1] ** 2), sky[2]))
    sel = elev > 50.0
    assert sel.sum() > 10, f"only {sel.sum()} interior sky directions"
    d = torch.from_numpy(sky[:, sel].T.astype(np.float32))
    n = d.shape[0]
    o = torch.tensor([0.0, 0.0, 0.5]).expand(n, 3) / world_scale
    rays = pack_rays(o, d, torch.full((n,), 0.3 / world_scale),
                     torch.full((n,), 18.0 / world_scale))
    with torch.no_grad():
        out = render_rays(rays, opt.state.field_params, field_cfg, UniformRaySampler(),
                          n_samples=128)
    return float(out["opacity"].mean())


def test_sky_supervision_reduces_sky_opacity():
    with_sky, without = _skylight_opacity(True), _skylight_opacity(False)
    assert with_sky < without * 0.6, (with_sky, without)
    assert with_sky < 0.35, with_sky


def test_sky_floaters_matches_the_jax_script(tmp_path, monkeypatch):
    from test_torch_render import _jax_experiment

    from loner_tpu_torch.analysis import sky_floaters
    from loner_tpu_torch.analysis.renderer_lidar import write_pcd

    from loner_tpu.mapping.mapper import load_checkpoint, save_checkpoint

    log_dir = _jax_experiment(tmp_path / "exp", "float32", "xla")
    # A thinner field than the random one, so the opacities compared lie inside
    # (0, 1): the last sample's bin is 1e10 long, so with softplus density a ray
    # is transparent only where that sample's raw sigma is below about -23.
    ckpt_path = str(log_dir / "checkpoints" / "final.tar")
    ckpt = load_checkpoint(ckpt_path)
    mlp = ckpt["network_state_dict"]["sigma"]["mlp"]
    last = max(k for k in mlp if k.startswith("b"))
    mlp[last] = mlp[last] - 25.0
    save_checkpoint(ckpt_path, ckpt)
    rng = np.random.default_rng(2)
    gt = rng.uniform(-3.0, 3.0, (200, 3)).astype(np.float32)
    gt_path = str(tmp_path / "gt.pcd")
    write_pcd(gt, gt_path)
    cloud = rng.uniform(-3.0, 5.0, (500, 3)).astype(np.float32)
    os.makedirs(log_dir / "lidar_renders")
    np.save(log_dir / "lidar_renders" / "render_full_0.05.npy", cloud)
    metrics = log_dir / "metrics" / "sky_floaters.yaml"

    args = [str(log_dir), "--gt_map", gt_path, "--n_probe_rays", "64"]
    monkeypatch.setattr(sys, "argv", ["sky_floater_metric.py", *args, "--cpu"])
    runpy.run_path(str(REPO / "examples/scripts/sky_floater_metric.py"), run_name="__main__")
    want = yaml.safe_load(metrics.read_text())
    metrics.unlink()
    monkeypatch.setattr(sys, "argv", ["sky_floaters", *args, "--device", "cpu"])
    sky_floaters.main()
    got = read_json_yaml(str(metrics))

    assert got.keys() == want.keys()
    for k in ("num_map_points", "num_floater_points", "num_probe_rays"):
        assert got[k] == want[k], k
    assert 0 < got["num_floater_points"] < got["num_map_points"]
    for k in ("z_top", "floater_fraction"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    for k in ("mean_sky_opacity", "p90_sky_opacity"):
        assert got[k] == pytest.approx(want[k], rel=2e-5), k
    assert 0.05 < got["mean_sky_opacity"] < 0.95, got
