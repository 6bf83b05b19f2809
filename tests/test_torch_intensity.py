"""The port's intensity head and camera supervision against the JAX package's.

Small widths: a Fourier sigma head (8 frequencies, 32 x 2, biases, softplus;
JAX's sigma head is its fused Pallas kernel in interpret mode, the port's the
plain version of its fused kernel), an intensity head of 16 x 2 on Fourier
features (seed 4321, 8 frequencies) or a hash table (2 levels at 2^10), with
the SH(4) view encoding or without.

- ``query_field(sigma_only=False)``: colours and sigma, and the gradients of
  the intensity MLP, the intensity table, the sigma parameters (``detach_sigma``
  False; exactly zero when True) and the positions. f32: atol 1e-5 on the
  outputs, 5e-5 of each gradient's scale (summation order). bf16 (the Fourier
  intensity encode with its custom VJP and the MLP's bf16 cotangents, as
  ``box_room_tpu_camera_r5.yaml`` computes): outputs 2e-3, gradients 2e-2 of
  their scale, 99% of entries within 2e-3 (a bf16 ulp at 1 is 7.8e-3, and f32
  sums in another order flip roundings of activations and cotangents).
- ``raw2outputs`` with colours, on a black and a white background: 1e-6.
- ``compute_camera_loss`` on JAX's draws (proposal and OGM samplers): the loss
  rtol 1e-5, rgb 1e-6, gradients 5e-5 of scale.
- Three ``run_phase`` iterations with ``freeze_rgb_mlp: False`` and camera
  samples against JAX's ``make_phase_runner`` on JAX's draws, for both
  intensity encodings, at the step tests' tolerances: losses rtol 2e-5; twists
  and sigma MLP atol 5e-6; the intensity MLP atol 5e-6 except the weights of at
  most one hidden unit, within 2.5% of lr_rgb (measured 1.8%: from the second
  iteration on, a ReLU whose pre-activation is ~0 at a sample can take the
  other side of zero in the other package, and that unit's gradient is then a
  sum over other points, which Adam turns into a step near lr); the intensity table
  99.9% of entries within 5e-6 and every one within 5% of lr_rgb (Adam's
  first steps are about lr sign(g): an entry whose gradient is a rounding-level
  sum moves by a different fraction of lr in each package).
- The ports of ``tests/test_intensity_training.py``'s cases: a frozen intensity
  head stays bit-identical; camera samples on a run without camera geometry
  build no camera branch; the camera knobs parse.
- ``convert``: both intensity encodings round-trip, and a checkpoint written by
  the JAX package renders the same intensity image in the port (f32 rtol 2e-5).
- A tiny single-threaded camera SLAM run of the port from
  ``box_room_camera.yaml`` (reduced scans, widths and iterations): its trained
  intensity head differs from the initial one, ``compute_psnr`` writes
  ``metrics/psnr.yaml``, and the JAX package's ``load_experiment`` renders the
  port's checkpoint to the same intensity image (atol 1e-4).
- The Fourier sigma field's bf16 parity at the courtyard's width (K = 195).
"""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.analysis import render_utils as jru
from loner_tpu.analysis import renderer as jr
from loner_tpu.mapping import loss as jloss
from loner_tpu.mapping import optimizer as jopt
from loner_tpu.mapping import rays as jrays
from loner_tpu.models import field as jfield
from loner_tpu.models import rendering as jrend
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
from loner_tpu.models.proposal import ProposalConfig as JProp, init_proposal_params
from loner_tpu.ops.pallas.fourier_mlp import fourier_sigma_fused as j_fused
from loner_tpu_torch import convert
from loner_tpu_torch.analysis import render_utils as tru
from loner_tpu_torch.analysis import renderer as tr
from loner_tpu_torch.analysis.compute_psnr import compute_psnr
from loner_tpu_torch.common import camera as tcam
from loner_tpu_torch.common.json_yaml import read_json_yaml
from loner_tpu_torch.common.settings import load_config
from loner_tpu_torch.datasets import synthetic as tsyn
from loner_tpu_torch.mapping import loss as tloss
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.mapping.keyframe import KeyFrame
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models import rendering as trend
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig as THash
from loner_tpu_torch.models.proposal import ProposalConfig as TProp
from loner_tpu_torch.ops import fourier_mlp as tfm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
W, N_LIDAR, N_CAM, S, ITERS = 2, 8, 8, 16, 3
HW = (6, 8)


def _field_cfgs(intensity: str, dtype: str = "float32", view: bool = True):
    jdt, tdt = DT[dtype]
    common = dict(encoding_sigma="fourier", density_activation="softplus", sigma_mlp_bias=True,
                  encoding_intensity=intensity, enable_view_dependence=view)
    jcfg = jfield.FieldConfig(
        fourier_sigma=jfield.FourierConfig(n_freqs=8, scale=6.0),
        fourier_intensity=jfield.FourierConfig(n_freqs=8, scale=6.0, seed=4321),
        sigma_mlp=jfield.MLPConfig(32, 2, 1), intensity_mlp=jfield.MLPConfig(16, 2, 3),
        pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10),
        compute_dtype=jdt, sigma_kernel="pallas", **common)
    tcfg = tfield.FieldConfig(
        fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        fourier_intensity=tfield.FourierConfig(n_freqs=8, scale=6.0, seed=4321),
        sigma_mlp=tfield.MLPConfig(32, 2, 1), intensity_mlp=tfield.MLPConfig(16, 2, 3),
        pos_encoding_intensity=THash(n_levels=2, log2_hashmap_size=10),
        compute_dtype=tdt, **common)
    return jcfg, tcfg


def _params(jcfg, seed: int = 0):
    """JAX-initialised params with non-zero sigma biases and a hash table whose
    entries are O(1) (tcnn's init of 1e-4 would hide its gradients)."""
    params = jfield.init_field_params(jax.random.key(seed), jcfg)
    params["sigma"]["mlp"] = {
        k: v + 0.05 * jax.random.normal(jax.random.key(7), v.shape) if k.startswith("b") else v
        for k, v in params["sigma"]["mlp"].items()}
    if "table" in params["intensity"]:
        params["intensity"]["table"] = jax.random.uniform(
            jax.random.key(9), params["intensity"]["table"].shape, minval=-1.0, maxval=1.0)
    return params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_grads(g_t: dict, g_j: dict, atol: float, frac: float = 1.0) -> None:
    for name, ref in _leaves(g_j).items():
        ref = np.asarray(ref, np.float32)
        got = g_t[name]
        got = np.zeros_like(ref) if got is None else got.numpy()
        scale = max(np.abs(ref).max(), 1e-6)
        diff = np.abs(got - ref) / scale
        assert np.quantile(diff, frac) <= atol if frac < 1.0 else diff.max() <= atol, (
            name, diff.max())


@pytest.mark.parametrize("intensity,dtype,view", [
    ("fourier", "float32", True), ("fourier", "float32", False), ("fourier", "bfloat16", True),
    ("hash", "float32", True), ("hash", "float32", False)])
@pytest.mark.parametrize("detach_sigma", [False, True])
def test_query_field_with_intensity_matches_jax(intensity, dtype, view, detach_sigma):
    jcfg, tcfg = _field_cfgs(intensity, dtype, view)
    params = _params(jcfg)
    rng = np.random.default_rng(3)
    n = 300
    pos = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = rng.normal(size=(n, 4)).astype(np.float32)

    def f_j(p, x):
        out = jfield.query_field(p, x, jnp.asarray(dirs), jcfg, sigma_only=False,
                                 detach_sigma=detach_sigma)
        return (out * c).sum(), out

    (_, out_j), (g_j, gx_j) = jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(pos))
    params_t = convert.field_params_from_jax(_np(params), CPU)
    leaves = _leaves(params_t)
    for v in leaves.values():
        v.requires_grad_(True)
    pos_t = torch.tensor(pos, requires_grad=True)
    out_t = tfield.query_field(params_t, pos_t, torch.from_numpy(dirs), tcfg, sigma_only=False,
                               detach_sigma=detach_sigma)
    (out_t * torch.from_numpy(c)).sum().backward()

    assert out_t.shape == (n, 4)
    fwd_atol, g_atol, frac = (1e-5, 5e-5, 1.0) if dtype == "float32" else (2e-3, 2e-3, 0.99)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j, np.float32),
                               atol=fwd_atol)
    grads = {k: v.grad for k, v in leaves.items()}
    _assert_grads(grads, g_j, g_atol, frac)
    if dtype != "float32":
        _assert_grads(grads, g_j, 2e-2)
    for k, v in leaves.items():
        if k.startswith("sigma/"):
            assert (v.grad is None or not v.grad.any()) == detach_sigma, k
        else:
            assert v.grad is not None and v.grad.abs().max() > 0, k
    ref = np.asarray(gx_j)
    scale = max(np.abs(ref).max(), 1.0)
    tol = 5e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(pos_t.grad.numpy() / scale, ref / scale, atol=tol)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_with_colours_matches_jax(white_bkgd):
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(20, 12, 4)).astype(np.float32)
    raw[..., :3] = 1.0 / (1.0 + np.exp(-raw[..., :3]))
    z = np.sort(rng.uniform(0.1, 1.0, (20, 12)), axis=-1).astype(np.float32)
    rays_d = rng.normal(size=(20, 3)).astype(np.float32)
    far = np.full((20, 1), 1.2, np.float32)
    out_j = jrend.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rays_d),
                              white_bkgd=white_bkgd, sigma_only=False, softplus=True,
                              far=jnp.asarray(far), ret_var=True)
    out_t = trend.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                              torch.from_numpy(rays_d), white_bkgd=white_bkgd, sigma_only=False,
                              softplus=True, far=torch.from_numpy(far), ret_var=True)
    for k in ("rgb", "depth", "opacity", "variance", "weights"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=1e-6, err_msg=k)


def _camera_inputs(seed: int = 5):
    rng = np.random.default_rng(seed)
    cam_dirs, _, _ = tcam.get_ray_directions(*HW, np.array([[6.0, 0, 4], [0, 6.0, 3], [0, 0, 1]]))
    l2c = tsyn.VirtualCamera().lidar_to_camera().matrix.astype(np.float32)
    images = [rng.uniform(size=HW + (3,)).astype(np.float32) for _ in range(W)]
    return cam_dirs, l2c, images


@pytest.mark.parametrize("strategy", ["PROPOSAL", "OGM"])
def test_compute_camera_loss_matches_jax_on_its_draws(strategy):
    jcfg, tcfg = _field_cfgs("hash")
    params = _params(jcfg, seed=1)
    cam_dirs, l2c, images = _camera_inputs()
    twists = np.random.default_rng(6).normal(0, 0.05, (W, 6)).astype(np.float32)
    cj = jrays.build_camera_window_buffers(images, cam_dirs, l2c, W)
    ct = trays.build_camera_window_buffers(images, cam_dirs, l2c, W)
    shift = np.zeros(3, np.float32)
    k_cam, k_render = jax.random.split(jax.random.key(12))
    rays_j, intens_j, valid_j = jrays.sample_and_build_camera_rays(
        k_cam, cj, jnp.asarray(twists), jnp.asarray(12.0), jnp.asarray(shift), (0.5, 14.0),
        N_CAM, jnp.ones(W, bool))
    u = torch.tensor(np.asarray(jax.random.uniform(k_cam, (W, N_CAM))))
    rays_t, intens_t, valid_t = trays.sample_and_build_camera_rays(
        ct, torch.from_numpy(twists), torch.tensor(12.0), torch.from_numpy(shift), (0.5, 14.0),
        N_CAM, torch.ones(W, dtype=torch.bool), u)
    b = W * N_CAM
    k_sample, _ = jax.random.split(k_render)
    if strategy == "PROPOSAL":
        sampler_j, sampler_t = jrend.ProposalRaySampler(n_ctrl=9), trend.ProposalRaySampler(n_ctrl=9)
        occ_j = init_proposal_params(jax.random.key(5), JProp(n_freqs=4, n_neurons=16))
        occ_t = convert.proposal_params_from_jax(_np(occ_j), CPU)
        jitter = torch.tensor(np.asarray(jax.random.uniform(k_sample, (b, S))))
        pdf_u = None
    else:
        sampler_j, sampler_t = jrend.OccGridRaySampler(), trend.OccGridRaySampler()
        grid = np.abs(np.random.default_rng(8).normal(size=(16, 16, 16))).astype(np.float32)
        occ_j, occ_t = jnp.asarray(grid), convert.occ_grid_from_jax(grid, CPU)
        k_uniform, k_pdf = jax.random.split(k_sample)
        jitter = torch.tensor(np.asarray(jax.random.uniform(k_uniform, (b, S // 2))))
        pdf_u = torch.tensor(np.asarray(jax.random.uniform(k_pdf, (b, S // 2))))

    def f_j(p):
        return jloss.compute_camera_loss(k_render, rays_j, intens_j, valid_j, p, jcfg, sampler_j,
                                         occ_j, S, 1.0, point_chunk=0, detach_sigma=False)

    (mse_j, rgb_j), g_j = jax.value_and_grad(f_j, has_aux=True)(params)
    params_t = convert.field_params_from_jax(_np(params), CPU)
    leaves = _leaves(params_t)
    for v in leaves.values():
        v.requires_grad_(True)
    mse_t, rgb_t = tloss.compute_camera_loss(rays_t, intens_t, valid_t, params_t, tcfg,
                                             sampler_t, occ_t, S, 1.0, detach_sigma=False,
                                             jitter=jitter, pdf_u=pdf_u)
    mse_t.backward()
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j), atol=1e-6)
    np.testing.assert_allclose(float(mse_t.detach()), float(mse_j), rtol=1e-5)
    _assert_grads({k: v.grad for k, v in leaves.items()}, g_j, 5e-5)


# -- three camera iterations ---------------------------------------------------------

def _scans(seed: int = 0):
    rng = np.random.default_rng(seed)
    dirs, depths = [], []
    for _ in range(W):
        d = rng.normal(size=(3, 100))
        dirs.append((d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32))
        depths.append(rng.uniform(1.5, 9.5, 100).astype(np.float32))
    return dirs, depths, rng.normal(0, 0.02, (W, 6)).astype(np.float32)


def _jax_camera_draws(key, n_iters: int, b: int, b_cam: int):
    """JAX's single-step draws, by the key splits of its loss: k_rays (LiDAR
    uniforms), k_cam (pixel picks), k_render (the LiDAR sampler and sigma noise)
    and fold_in(k_render, 1) (the camera sampler)."""
    draws = []
    for i in range(n_iters):
        k_step = jax.random.fold_in(jax.random.fold_in(key, i), 1)
        k_rays, k_cam, k_render = jax.random.split(k_step, 3)
        k_lidar, _ = jax.random.split(k_rays)
        k_sample, k_noise = jax.random.split(k_render)
        k_cam_sample, _ = jax.random.split(jax.random.fold_in(k_render, 1))
        draws.append(topt.StepDraws(
            ray_u=torch.tensor(np.asarray(jax.random.uniform(k_lidar, (W, N_LIDAR)))),
            jitter=torch.tensor(np.asarray(jax.random.uniform(k_sample, (b, S)))),
            noise=torch.tensor(np.asarray(jax.random.normal(k_noise, (b, S)))),
            cam_u=torch.tensor(np.asarray(jax.random.uniform(k_cam, (W, N_CAM)))),
            cam_jitter=torch.tensor(np.asarray(jax.random.uniform(k_cam_sample, (b_cam, S))))))
    return draws


def _opt_cfgs(**kw):
    common = dict(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                  ray_range=(0.5, 14.0), samples_strategy="PROPOSAL", lr_sigma=0.005,
                  prop_n_ctrl=9, n_camera_samples=N_CAM, lr_rgb=0.01, cameraloss_lambda=0.7, **kw)
    cfg_j = jopt.OptimizerConfig(**common, window_size=W, point_chunk=0, steps_per_dispatch=1,
                                 proposal=JProp(n_freqs=4, n_neurons=16))
    cfg_t = topt.OptimizerConfig(**common, proposal=TProp(n_freqs=4, n_neurons=16))
    return cfg_j, cfg_t


@pytest.mark.parametrize("intensity", ["fourier", "hash"])
def test_camera_run_phase_matches_jax_over_three_iterations(intensity):
    cfg_j, cfg_t = _opt_cfgs()
    jcfg, tcfg = _field_cfgs(intensity)
    params = _params(jcfg, seed=2)
    prop = init_proposal_params(jax.random.key(5), cfg_j.proposal)
    params_np, prop_np = _np(params), _np(prop)
    dirs, depths, twists = _scans()
    cam_dirs, l2c, images = _camera_inputs()
    key = jax.random.key(4)
    phase_j = jopt.PhaseSettings(num_iterations=ITERS, freeze_rgb_mlp=False)

    bj = jrays.build_window_buffers(dirs, depths, [None] * W, W)
    cj = jrays.build_camera_window_buffers(images, cam_dirs, l2c, W)
    run_j = jopt.make_phase_runner(cfg_j, jcfg, phase_j, W, bj.dirs.shape[1],
                                   bj.sky_dirs.shape[1])
    field_j, prop_j, tw_j, losses_j, eps_j = run_j(
        params, prop, jnp.asarray(twists), bj, jnp.ones(W), jnp.asarray(12.0, jnp.float32),
        jnp.zeros(3), 0, key, num_iterations=ITERS, cam_buffers=cj)

    bt = trays.build_window_buffers(dirs, depths, [None] * W, W, device=CPU)
    ct = trays.build_camera_window_buffers(images, cam_dirs, l2c, W)
    phase_t = topt.PhaseSettings(num_iterations=ITERS, freeze_rgb_mlp=False)
    run_t = topt.make_phase_runner(cfg_t, tcfg, phase_t, W, bt.dirs.shape[1],
                                   bt.sky_dirs.shape[1], CPU)
    draws = _jax_camera_draws(key, ITERS, W * N_LIDAR, W * N_CAM)
    field_t, prop_t, tw_t, losses_t, eps_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.proposal_params_from_jax(prop_np, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), 0, None, num_iterations=ITERS, draws=draws, camera=ct)

    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=5e-6)
    cam = run_t.last_camera_losses.numpy()
    assert cam.shape == (ITERS,) and np.all(cam > 0)
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v), atol=5e-6,
                                   err_msg=k)
    # The intensity MLP: every entry within 5e-6 but those of at most one hidden
    # unit (its column of w0, its row of w1), which stay within 2.5% of lr_rgb.
    units = set()
    for i, (k, v) in enumerate(sorted(field_j["intensity"]["mlp"].items())):
        diff = np.abs(field_t["intensity"]["mlp"][k].numpy() - np.asarray(v))
        assert diff.max() <= 0.025 * cfg_t.lr_rgb, (k, diff.max())
        if i == 0:
            units |= set(np.flatnonzero((diff > 5e-6).any(axis=0)).tolist())
        elif i == 1:
            units |= set(np.flatnonzero((diff > 5e-6).any(axis=1)).tolist())
        else:
            assert diff.max() <= 5e-6, k
        assert np.abs(np.asarray(v) - params_np["intensity"]["mlp"][k]).max() > 1e-3
    assert len(units) <= 1, units
    if intensity == "hash":
        table_j = np.asarray(field_j["intensity"]["table"])
        diff = np.abs(field_t["intensity"]["table"].numpy() - table_j)
        assert np.quantile(diff, 0.999) <= 5e-6 and diff.max() <= 0.05 * cfg_t.lr_rgb, diff.max()
        assert np.abs(table_j - params_np["intensity"]["table"]).max() > 1e-3
    for k, v in prop_j.items():
        np.testing.assert_allclose(prop_t[k].numpy(), np.asarray(v), atol=5e-6, err_msg=k)


def test_camera_phase_on_graph_logic_equals_eager():
    """The program's static camera buffers: a call with other images copies them
    in (the graph replays read the static tensors), and the captured program
    (``HostGraph`` runs the graph logic on the CPU) equals the eager one, bit for
    bit, on the same draws."""
    from loner_tpu_torch.mapping.phase_graph import PhaseProgram
    from test_torch_dispatch import HostGraph

    cfg_j, cfg_t = _opt_cfgs()
    _, tcfg = _field_cfgs("hash")
    params_np = _np(_params(_field_cfgs("hash")[0], seed=3))
    prop_np = _np(init_proposal_params(jax.random.key(5), cfg_j.proposal))
    dirs, depths, twists = _scans(1)
    cam_dirs, l2c, images = _camera_inputs(7)
    bt = trays.build_window_buffers(dirs, depths, [None] * W, W, device=CPU)
    other = trays.build_camera_window_buffers([images[1], None], cam_dirs, l2c, W)
    ct = trays.build_camera_window_buffers(images, cam_dirs, l2c, W)
    phase = topt.PhaseSettings(num_iterations=4, freeze_rgb_mlp=False)
    gen = torch.Generator().manual_seed(1)
    draws = [topt.draw_step(gen, cfg_t, W, CPU, camera=True) for _ in range(4)]
    assert draws[0].cam_u.shape == (W, N_CAM) and draws[0].cam_jitter.shape == (W * N_CAM, S)
    outs = []
    for graphs in (False, True):
        prog = PhaseProgram(cfg_t, tcfg, phase, W, CPU, graphs=graphs, graph_class=HostGraph)
        args = (convert.field_params_from_jax(params_np, CPU),
                convert.proposal_params_from_jax(prop_np, CPU),
                convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
                torch.zeros(3), 0, None)
        prog(*args, num_iterations=2, draws=draws, camera=other)  # statics made from `other`
        field, prop, tw, losses, eps = prog(*args, draws=draws, camera=ct)
        outs.append([*_leaves(field).values(), *prop.values(), tw, losses, eps,
                     prog.last_camera_losses])
        assert prog.captured == graphs
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- the JAX package's intensity-training cases ------------------------------------

def _keyframes(n: int, with_images: bool):
    from loner_tpu_torch.common.frame import Frame
    from loner_tpu_torch.common.pose import Pose
    from loner_tpu_torch.common.sensors import Image
    from loner_tpu_torch.common.world_cube import compute_world_cube

    scans, poses, ts, scene, _ = tsyn.generate_sequence(
        num_scans=n, lidar=tsyn.VirtualLidar(num_channels=8, num_columns=64, max_range=30.0),
        rate_hz=2.0)
    zeroed = np.linalg.inv(poses[0])[None] @ poses
    cube = compute_world_cube(None, None, None, zeroed, (0.5, 14.0), padding=0.3)
    cam = tsyn.VirtualCamera(width=16, height=12)
    kfs = []
    for scan, pose in zip(scans, zeroed):
        f = Frame(scan)
        f._lidar_pose = f._gt_lidar_pose = Pose(pose)
        if with_images:
            f.image = Image(cam.render(scene, Pose(pose)), scan.get_start_time())
        kfs.append(KeyFrame(f))
    dirs, _, _ = tcam.get_ray_directions(cam.height, cam.width, cam.k)
    return kfs, cube, (dirs, cam.lidar_to_camera().matrix.astype(np.float32))


def _small_optimizer(cube, freeze_rgb: bool, camera_rays):
    cfg = topt.OptimizerConfig(n_lidar_samples=32, n_sky_samples=0, n_samples_per_ray=16,
                               window_size=2, ray_range=(0.5, 14.0), samples_strategy="PROPOSAL",
                               prop_n_ctrl=9, n_camera_samples=16, steps_per_dispatch=2,
                               proposal=TProp(n_freqs=8, n_neurons=16))
    _, tcfg = _field_cfgs("hash")
    schedule = [{"num_keyframes": -1, "iteration_schedule": [
        {"num_iterations": 5, "freeze_poses": True, "freeze_sigma_mlp": True,
         "freeze_rgb_mlp": freeze_rgb}]}]
    return topt.Optimizer(cfg, tcfg, cube.scale_factor, cube.shift, schedule, CPU,
                          camera_rays=camera_rays, seed=3)


def _flat(tree):
    return torch.cat([v.reshape(-1) for v in _leaves(tree).values()]).numpy().copy()


def test_unfrozen_rgb_trains_intensity_and_keeps_frozen_sigma():
    kfs, cube, geometry = _keyframes(2, True)
    opt = _small_optimizer(cube, False, geometry)
    before, sigma_before = (_flat(opt.state.field_params[k]) for k in ("intensity", "sigma"))
    opt.iterate_optimizer(kfs[:2])
    assert not np.allclose(_flat(opt.state.field_params["intensity"]), before)
    np.testing.assert_array_equal(_flat(opt.state.field_params["sigma"]), sigma_before)
    assert opt.last_camera_losses.shape == (5,) and np.all(opt.last_camera_losses > 0)


def test_frozen_rgb_keeps_intensity_bit_identical():
    kfs, cube, geometry = _keyframes(2, True)
    opt = _small_optimizer(cube, True, geometry)
    before = _flat(opt.state.field_params["intensity"])
    opt.iterate_optimizer(kfs[:2])
    np.testing.assert_array_equal(_flat(opt.state.field_params["intensity"]), before)
    assert opt.last_camera_losses is None


def test_a_flagged_fixed_point_sum_raises_at_the_keyframes_host_copy():
    """The Optimizer reads the fixed-point overflow flag in its one copy of a
    keyframe's results (the phases do not sync for it): a set flag raises there
    and is cleared, and the next keyframe runs."""
    from loner_tpu_torch.ops import fixed_point

    kfs, cube, _ = _keyframes(2, False)
    opt = _small_optimizer(cube, False, None)
    flag = fixed_point.flag(CPU)
    flag.fill_(1)
    with pytest.raises(OverflowError, match="passed its limit"):
        opt.iterate_optimizer(kfs[:2])
    assert int(flag) == 0
    assert np.isfinite(opt.iterate_optimizer(kfs[:2]))


def test_camera_samples_on_a_lidar_only_run_build_no_camera_branch():
    kfs, cube, _ = _keyframes(2, False)
    opt = _small_optimizer(cube, False, None)
    before = _flat(opt.state.field_params["intensity"])
    opt.iterate_optimizer(kfs[:2])
    runner = next(iter(opt._runner_cache.values()))
    assert not runner.use_camera and opt.last_camera_losses is None
    assert runner.draws is None or runner.draws.cam_u is None
    # No camera loss: Adam's steps on zero gradients leave the head as it was.
    np.testing.assert_array_equal(_flat(opt.state.field_params["intensity"]), before)


def test_optimizer_config_reads_the_camera_knobs():
    settings, _ = load_config(str(REPO / "cfg/synthetic/box_room_tpu_camera_r5.yaml"))
    opt = settings.mapper.optimizer
    cfg = topt.OptimizerConfig.from_settings(opt, opt.model_config)
    ref = jopt.OptimizerConfig.from_settings(opt, opt.model_config)
    assert (cfg.n_camera_samples, cfg.lr_rgb, cfg.cameraloss_lambda) == (128, 0.005, 1.0)
    for name in ("n_camera_samples", "cameraloss_lambda", "detach_rgb_from_poses",
                 "detach_rgb_from_sigma", "lr_rgb"):
        assert getattr(cfg, name) == getattr(ref, name), name
    fcfg = tfield.FieldConfig.from_settings(opt.model_config.model.nerf_config)
    assert fcfg.encoding_intensity == "fourier" and fcfg.intensity_pos_dim == 99
    assert fcfg.fourier_intensity == tfield.FourierConfig(n_freqs=48, scale=6.0, seed=4321)


# -- checkpoints across the packages ------------------------------------------------

@pytest.mark.parametrize("intensity", ["fourier", "hash"])
def test_jax_checkpoint_renders_the_same_intensity_in_the_port(tmp_path, intensity):
    jcfg, _ = _field_cfgs(intensity)
    params = _np(_params(jcfg, seed=4))
    back = convert.field_params_to_jax(convert.field_params_from_jax(params, CPU))
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(_leaves(back)[k], v)
    nerf = {"encoding_sigma": "fourier", "encoding_intensity": intensity, "sigma_kernel": "xla",
            "density_activation": "softplus", "sigma_mlp_bias": True,
            "fourier_sigma": {"n_freqs": 8, "scale": 6.0},
            "fourier_intensity": {"n_freqs": 8, "scale": 6.0},
            "sigma_network": {"n_neurons": 32, "n_hidden_layers": 2},
            "intensity_network": {"n_neurons": 16, "n_hidden_layers": 2},
            "pos_encoding_intensity": {"n_levels": 2, "log2_hashmap_size": 10}}
    cube = {"scale_factor": 12.0, "shift": [0.0, 0.0, 0.0]}
    settings = {"mapper": {"optimizer": {"model_config": {
        "model": {"nerf_config": nerf, "num_colors": 3}, "data": {"ray_range": [0.5, 14.0]}}}},
        "world_cube": cube}
    (tmp_path / "checkpoints").mkdir()
    with open(tmp_path / "full_config.pkl", "wb") as f:
        pickle.dump(settings, f)
    with open(tmp_path / "checkpoints" / "final.tar", "wb") as f:
        pickle.dump({"global_step": 1, "network_state_dict": params, "poses": [],
                     "world_cube": cube}, f)
    pose = np.eye(4)
    pose[:3, 3] = [0.5, -0.3, 0.2]
    k = np.array([[6.0, 0, 4], [0, 6.0, 3], [0, 0, 1]])
    dirs = jr.camera_ray_directions(k, 8, 6)
    out_j = jr.render_dataset_frame(jru.load_experiment(str(tmp_path)), pose, dirs, (6, 8),
                                    n_samples=32, with_intensity=True)
    out_t = tr.render_dataset_frame(tru.load_experiment(str(tmp_path), device=CPU), pose, dirs,
                                    (6, 8), n_samples=32, with_intensity=True)
    assert out_t["intensity"].shape == (6, 8, 3)
    np.testing.assert_allclose(out_t["intensity"], np.asarray(out_j["intensity"]), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_t["depth"], np.asarray(out_j["depth"]), rtol=2e-5)


def test_camera_slam_trial_trains_the_head_and_jax_renders_its_checkpoint(tmp_path):
    from loner_tpu_torch.run_loner import run_trial

    scans, poses, ts, scene, _ = tsyn.generate_sequence(
        num_scans=10, lidar=tsyn.VirtualLidar(16, 128, max_range=30.0), rate_hz=5.0)
    tsyn.write_sequence(str(tmp_path / "ds"), scans, poses, ts, scene=scene,
                        camera=tsyn.VirtualCamera())
    settings, _ = load_config(str(REPO / "cfg/synthetic/box_room_camera.yaml"))
    assert settings.system.single_threaded and not settings.system.lidar_only
    settings.augment({"system": {"log_dir_prefix": str(tmp_path / "out") + "/"},
                      "mapper": {"optimizer": {
                          "keyframe_schedule": [
                              {"num_keyframes": 1, "iteration_schedule": [
                                  {"num_iterations": 12, "freeze_poses": True,
                                   "freeze_sigma_mlp": False, "freeze_rgb_mlp": False}]},
                              {"num_keyframes": -1, "iteration_schedule": [
                                  {"num_iterations": 4, "freeze_poses": False,
                                   "freeze_sigma_mlp": False, "freeze_rgb_mlp": False}]}],
                          "num_samples": {"lidar": 32, "camera": 32},
                          "model_config": {"model": {
                              "render": {"N_samples_train": 16},
                              "nerf_config": {"sigma_network": {"n_neurons": 32},
                                              "fourier_sigma": {"n_freqs": 8},
                                              "intensity_network": {"n_neurons": 16}}}}}}})
    log_dir = run_trial(settings, str(tmp_path / "ds"), experiment_name="cam", device="cpu")

    model = tru.load_experiment(log_dir, device=CPU)
    first = pickle.load(open(Path(log_dir) / "checkpoints" / "final.tar", "rb"))
    assert len(first["poses"]) >= 2
    init = tfield.init_field_params(torch.Generator().manual_seed(0), model.field_cfg, CPU)
    assert model.field_params["intensity"]["table"].shape == init["intensity"]["table"].shape
    assert not torch.equal(model.field_params["intensity"]["mlp"]["w0"], init["intensity"]["mlp"]["w0"])
    result = compute_psnr(log_dir, num_images=3, n_samples=32, model=model)
    on_disk = read_json_yaml(str(Path(log_dir) / "metrics" / "psnr.yaml"))
    # Images outside the keyframes' time span are skipped, as in the JAX package.
    assert on_disk["num_images"] == result["num_images"] >= 1
    assert np.isfinite(on_disk["mean"]) and on_disk["min"] <= on_disk["mean"] <= on_disk["max"]

    k = np.asarray(model.settings.calibration.camera_intrinsic.k, np.float64)
    dirs = jr.camera_ray_directions(k, 96, 64)[::97]
    pose = tru.kf_pose_matrices(model)[0][-1] @ tsyn.VirtualCamera().lidar_to_camera().matrix
    out_t = tr.render_dataset_frame(model, pose, dirs, (dirs.shape[0], 1), n_samples=32,
                                    with_intensity=True)
    out_j = jr.render_dataset_frame(jru.load_experiment(log_dir), pose, dirs, (dirs.shape[0], 1),
                                    n_samples=32, with_intensity=True)
    np.testing.assert_allclose(out_t["intensity"], np.asarray(out_j["intensity"]), atol=1e-4)


# -- the Fourier sigma field in bf16 at the courtyard's width ----------------------

def test_fourier_field_bf16_at_the_courtyard_width_differs_only_by_rounding_flips():
    """courtyard_tpu_r5f.yaml's head: F = 96 (K = 195), scale 16, 256 x 2, bf16.
    The plain version (the card's reference) against JAX's Pallas interpret.
    Bound: at most 10% of points beyond 1e-3 and every point within 1e-2
    (measured: 43 of 600, 7.2%, at most 4.5e-3), and at each point beyond 1e-3
    a flip: the two packages' bf16 features (their f32 phases differ in the
    order of three products and two sums) or their f32 pre-activations of some
    hidden unit round to different bf16 values (or take the other side of
    zero). Where nothing flips the outputs agree within 1e-4. The flips come
    from XLA:CPU's bf16 dots, which sum 195 and 256 exact products with errors
    up to ~1e-3, where the plain version (and the card's kernel) accumulates in
    f32."""
    f, h = 96, 256
    rng = np.random.default_rng(1)
    dims = [2 * f + 3, h, h, 1]
    mlp = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        mlp[f"w{i}"] = (rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a)).astype(np.float32)
        mlp[f"b{i}"] = (rng.normal(size=b) * 0.1).astype(np.float32)
    bmat = tfield.fourier_bmat(tfield.FourierConfig(n_freqs=f, scale=16.0), CPU).numpy()
    n = 600
    pts01 = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    out_j = np.asarray(j_fused({k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(pts01),
                               jnp.asarray(bmat), compute_dtype=jnp.bfloat16, interpret=True))
    ws = [torch.from_numpy(mlp[f"w{i}"]) for i in range(3)]
    bs = [torch.from_numpy(mlp[f"b{i}"]) for i in range(3)]
    out_t = tfm.fourier_mlp_fwd_plain(ws, bs, torch.from_numpy(bmat), torch.from_numpy(pts01),
                                      torch.bfloat16).numpy()
    diff = np.abs(out_t - out_j)[:, 0]
    beyond = diff > 1e-3
    assert beyond.mean() <= 0.10 and diff.max() <= 1e-2, (beyond.sum(), diff.max())

    # Each package's f32 pre-activations of both hidden layers, each from its
    # own package's bf16 inputs: the port's plain version (f32 products of bf16
    # values), and JAX's kernel ops outside Pallas (its bf16 dots with f32
    # results, whose XLA:CPU sums differ from exact f32 accumulation by up to
    # ~1e-3 at K = 195; they reproduce the interpret kernel's output).
    def rb(x):
        return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)

    feats_t = tfm._features(torch.from_numpy(pts01), torch.from_numpy(bmat),
                            torch.bfloat16).numpy()
    proj = jnp.dot(jnp.asarray(pts01), jnp.asarray(bmat), precision=jax.lax.Precision.HIGHEST)
    sc_j = jnp.concatenate([jnp.sin(proj), jnp.cos(proj)], axis=-1).astype(jnp.bfloat16)
    w0 = rb(mlp["w0"])
    z_j = (jnp.dot(sc_j, w0[:2 * f], preferred_element_type=jnp.float32)
           + jnp.dot(rb(pts01), w0[2 * f:], preferred_element_type=jnp.float32) + mlp["b0"])
    z_t = feats_t @ np.asarray(w0, np.float32) + mlp["b0"]
    flips = (feats_t[:, :2 * f] != np.asarray(sc_j, np.float32)).any(axis=1)
    for i in (1, 2):
        a_j, a_t = rb(jnp.maximum(z_j, 0.0)), rb(np.maximum(z_t, 0.0))
        flips |= (np.asarray(a_j, np.float32) != np.asarray(a_t, np.float32)).any(axis=1)
        w = rb(mlp[f"w{i}"])
        z_j = jnp.dot(a_j, w, preferred_element_type=jnp.float32) + mlp[f"b{i}"]
        z_t = np.asarray(a_t, np.float32) @ np.asarray(w, np.float32) + mlp[f"b{i}"]
    np.testing.assert_allclose(np.asarray(z_j), out_j, atol=1e-6)
    np.testing.assert_allclose(z_t, out_t, atol=1e-6)
    # Every point beyond 1e-3 has a flipped feature or hidden activation, and
    # where none flips the outputs agree to f32 summation order.
    assert flips[beyond].all(), np.flatnonzero(beyond & ~flips)
    assert diff[~flips].max() <= 1e-4, diff[~flips].max()
