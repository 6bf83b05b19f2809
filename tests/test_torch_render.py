"""The port's offline renderer against the JAX package's, on CPU.

Experiment directories are written by one package and rendered by both: the
flagship settings (cfg/model_config/tpu_native_model_config.yaml with
cfg/nerf_config/tpu_fourier.yaml) with widths cut small (8 frequencies, 32 x 2
sigma MLP, 9 proposal control points, 8 proposal frequencies x 16) and
``compositor: pallas``, random weights from a seed, two keyframe poses inside a
world cube of scale 12. On the CPU the JAX package composites with
``raw2outputs`` and the port with the plain version of its fused compositor.

Depth, variance and opacity are compared on finite rays with depth in
[near, far] (the reference clamps neither). Tolerances, relative to the value:
- f32 with JAX's ``sigma_kernel: xla``: 2e-5 (measured ~1e-6; the two sigma
  paths order the Fourier phase's f32 products and sums differently);
- bf16 with JAX's ``sigma_kernel: pallas`` (interpret mode): 1e-3 (measured
  ~1e-4; f32 summation order flips bf16 roundings of hidden activations).
"""
import os
import pickle
import runpy
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from loner_tpu.analysis import _render_impl as j_impl
from loner_tpu.analysis import render_utils as jru
from loner_tpu.analysis import renderer as jr
from loner_tpu.analysis import renderer_lidar as jrl
from loner_tpu.common.pose import Pose as JPose
from loner_tpu.common.settings import Settings as JSettings
from loner_tpu.common.world_cube import compute_world_cube as j_world_cube
from loner_tpu.mapping.mapper import save_checkpoint as j_save
from loner_tpu.models import field as jfield
from loner_tpu.models.proposal import ProposalConfig as JProp, init_proposal_params
from loner_tpu.ops.voxel import voxel_downsample as j_voxel
from loner_tpu_torch.analysis import _render_impl as t_impl
from loner_tpu_torch.analysis import render_utils as tru
from loner_tpu_torch.analysis import renderer as tr
from loner_tpu_torch.analysis import renderer_lidar as trl
from loner_tpu_torch.common.pose import Pose as TPose
from loner_tpu_torch.common.settings import Settings as TSettings
from loner_tpu_torch.common.world_cube import WorldCube, compute_world_cube as t_world_cube
from loner_tpu_torch.mapping import mapper as tmapper
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models import rendering as trend
from loner_tpu_torch.models.proposal import ProposalConfig as TProp
from loner_tpu_torch.models.proposal import init_proposal_params as t_init_proposal
from loner_tpu_torch.ops import composite as tc
from loner_tpu_torch.ops.voxel import voxel_downsample as t_voxel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RAY_RANGE = (1.0, 10.0)
CUBE = {"scale_factor": 12.0, "shift": [0.0, 0.0, 0.0]}
RTOL = {"float32": 2e-5, "bfloat16": 1e-3}
N_SAMPLES, CHUNK = 64, 48  # 48-ray chunks leave a ragged last chunk of 128 rays


def _model_settings(dtype: str, sigma_kernel: str) -> dict:
    model = JSettings.load_from_file(
        str(REPO / "cfg/model_config/tpu_native_model_config.yaml")).as_plain_dict()
    nerf = model["model"]["nerf_config"]
    nerf["fourier_sigma"]["n_freqs"] = 8
    nerf["sigma_network"]["n_neurons"] = 32
    nerf["pos_encoding_intensity"].update(n_levels=2, log2_hashmap_size=10)
    nerf["intensity_network"]["n_neurons"] = 16
    nerf.update(compute_dtype=dtype, sigma_kernel=sigma_kernel)
    occ = model["model"]["occ_model"]
    occ["prop_n_ctrl"] = 9
    occ["proposal"].update(n_freqs=8, n_neurons=16)
    assert model["model"]["render"]["compositor"] == "pallas"
    return model


def _pose_states(n: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    states = []
    for i in range(n):
        tw = np.concatenate([rng.uniform(-1.0, 1.0, 3), rng.normal(0, 0.2, 3)])
        states.append({"timestamp": float(i), "lidar_to_camera": None, "lidar_pose": tw,
                       "gt_lidar_pose": tw + 0.01, "tracked_pose": tw})
    return states


def _write_config(log_dir: Path, model: dict) -> None:
    (log_dir / "checkpoints").mkdir(parents=True)
    with open(log_dir / "full_config.pkl", "wb") as f:
        pickle.dump({"mapper": {"optimizer": {"model_config": model}}, "world_cube": CUBE}, f)


def _jax_experiment(log_dir: Path, dtype: str, sigma_kernel: str) -> Path:
    """An experiment directory written by the JAX package."""
    model = _model_settings(dtype, sigma_kernel)
    _write_config(log_dir, model)
    fcfg = jfield.FieldConfig.from_settings(model["model"]["nerf_config"], 3)
    params = jfield.init_field_params(jax.random.key(0), fcfg)
    params["sigma"]["mlp"] = {  # non-zero biases
        k: v + 0.05 * jax.random.normal(jax.random.key(7), v.shape) if k.startswith("b") else v
        for k, v in params["sigma"]["mlp"].items()
    }
    prop = init_proposal_params(jax.random.key(5), JProp(n_freqs=8, n_neurons=16))
    j_save(str(log_dir / "checkpoints" / "final.tar"), {
        "global_step": 3,
        "network_state_dict": jax.tree.map(np.asarray, params),
        "occ_model_state_dict": jax.tree.map(np.asarray, prop),
        "poses": _pose_states(),
        "world_cube": CUBE,
    })
    return log_dir


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_written")
    return {dtype: _jax_experiment(root / dtype, dtype, kernel)
            for dtype, kernel in (("float32", "xla"), ("bfloat16", "pallas"))}


def _scan_rays(pose: np.ndarray):
    dirs = trl.build_lidar_ray_directions(8, 16)
    dirs_world = dirs @ pose[:3, :3].T
    return np.broadcast_to(pose[:3, 3], dirs_world.shape), dirs_world


def _assert_renders_match(out_t: dict, out_j: dict, rtol: float, keys=("depth", "variance",
                                                                       "opacity")):
    depth_t, depth_j = out_t["depth"], np.asarray(out_j["depth"])
    ok = np.isfinite(depth_t) & np.isfinite(depth_j)
    ok &= (depth_j >= RAY_RANGE[0]) & (depth_j <= RAY_RANGE[1])
    assert ok.mean() > 0.99, ok.mean()
    for k in keys:
        np.testing.assert_allclose(out_t[k][ok], np.asarray(out_j[k])[ok], rtol=rtol,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_renders_a_jax_written_experiment_as_jax_does(jax_dirs, dtype):
    log_dir = str(jax_dirs[dtype])
    mj, mt = jru.load_experiment(log_dir), tru.load_experiment(log_dir, device=CPU)
    assert mt.compositor == "pallas" and mt.global_step == 3
    assert mt.field_cfg.compute_dtype == getattr(torch, dtype)
    assert t_impl.trained_n_ctrl(mt.settings) == j_impl.trained_n_ctrl(mj.settings) == 9
    mats_j, ts_j = jru.kf_pose_matrices(mj)
    mats_t, ts_t = tru.kf_pose_matrices(mt)
    np.testing.assert_array_equal(mats_t, mats_j)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(tru.kf_pose_matrices(mt, use_gt=True)[0],
                                  jru.kf_pose_matrices(mj, use_gt=True)[0])
    with_peak = dtype == "float32"  # an argmax may flip between bf16-close weights
    for pose in mats_t:
        o, d = _scan_rays(pose)
        out_j = jru.render_depth_chunked(mj, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK,
                                         with_peak=with_peak)
        out_t = tru.render_depth_chunked(mt, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK,
                                         with_peak=with_peak)
        keys = ("depth", "variance", "opacity") + (("peak_depth_consistency",) if with_peak
                                                   else ())
        _assert_renders_match(out_t, out_j, RTOL[dtype], keys)
    # The checkpoint is in meters: depth and variance scale with the cube.
    assert out_t["depth"].dtype == np.float32 and out_t["depth"].shape == (128,)


def test_render_full_map_and_scans_match_jax(jax_dirs, tmp_path):
    log_dir = str(jax_dirs["float32"])
    kw = dict(num_channels=8, num_columns=16, n_samples=N_SAMPLES, var_threshold=100.0,
              voxel_size=0.5)
    merged_j = jrl.render_full_map(log_dir, out_dir=str(tmp_path / "jax"), **kw)
    merged_t = trl.render_full_map(log_dir, out_dir=str(tmp_path / "port"), device=CPU, **kw)
    assert merged_t.shape[0] > 0 and np.isfinite(merged_t).all()
    # Voxel boundaries may flip on tiny depth differences: the merged clouds
    # are held to their size; the per-pose scans below are held point by point.
    assert abs(merged_t.shape[0] - merged_j.shape[0]) <= 0.02 * merged_j.shape[0] + 2
    npy = tmp_path / "port" / "render_full_0.5.npy"
    np.testing.assert_array_equal(np.load(npy), merged_t)
    np.testing.assert_allclose(trl.read_pcd(str(tmp_path / "port" / "render_full_0.5.pcd")),
                               merged_t, atol=1e-6)

    mj, mt = jru.load_experiment(log_dir), tru.load_experiment(log_dir, device=CPU)
    dirs = trl.build_lidar_ray_directions(8, 16)
    np.testing.assert_array_equal(dirs, jrl.build_lidar_ray_directions(8, 16))
    for pose in tru.kf_pose_matrices(mt)[0]:
        scan_j = jrl.render_scan(mj, pose, dirs, RAY_RANGE, n_samples=N_SAMPLES,
                                 var_threshold=100.0, chunk=CHUNK)
        scan_t = trl.render_scan(mt, pose, dirs, RAY_RANGE, n_samples=N_SAMPLES,
                                 var_threshold=100.0, chunk=CHUNK)
        assert scan_t.shape == scan_j.shape and scan_t.shape[0] > 100
        np.testing.assert_allclose(scan_t, scan_j, atol=1e-4)  # meters, ~10 m ranges


def test_render_dataset_frame_matches_jax(jax_dirs):
    log_dir = str(jax_dirs["float32"])
    mj, mt = jru.load_experiment(log_dir), tru.load_experiment(log_dir, device=CPU)
    k = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]])
    np.testing.assert_array_equal(tr.camera_ray_directions(k, 16, 12),
                                  jr.camera_ray_directions(k, 16, 12))
    dirs = tr.spherical_ray_directions(16, 8)
    np.testing.assert_array_equal(dirs, jr.spherical_ray_directions(16, 8))
    pose = tru.kf_pose_matrices(mt)[0][1]
    frame_j = jr.render_dataset_frame(mj, pose, dirs, (8, 16), n_samples=N_SAMPLES, chunk=CHUNK)
    frame_t = tr.render_dataset_frame(mt, pose, dirs, (8, 16), n_samples=N_SAMPLES, chunk=CHUNK)
    for key in ("depth", "variance", "opacity"):
        assert frame_t[key].shape == (8, 16)
    _assert_renders_match(frame_t, frame_j, RTOL["float32"])
    # The intensity head is ported: its frame matches JAX's too.
    frame_j = jr.render_dataset_frame(mj, pose, dirs, (8, 16), n_samples=N_SAMPLES, chunk=CHUNK,
                                      with_intensity=True)
    frame_t = tr.render_dataset_frame(mt, pose, dirs, (8, 16), n_samples=N_SAMPLES, chunk=CHUNK,
                                      with_intensity=True)
    assert frame_t["intensity"].shape == (8, 16, 3)
    np.testing.assert_allclose(frame_t["intensity"], np.asarray(frame_j["intensity"]),
                               rtol=RTOL["float32"], atol=1e-6)


def test_jax_renders_a_port_written_experiment_as_the_port_does(tmp_path):
    model = _model_settings("float32", "xla")
    _write_config(tmp_path, model)
    fcfg = tfield.FieldConfig.from_settings(model["model"]["nerf_config"], 3)
    gen = torch.Generator().manual_seed(3)
    params = tfield.init_field_params(gen, fcfg, CPU)
    params["sigma"]["mlp"]["b1"] += 0.05 * torch.randn(params["sigma"]["mlp"]["b1"].shape,
                                                       generator=gen)
    prop = t_init_proposal(gen, TProp(n_freqs=8, n_neurons=16), CPU)
    poses = [{**s, "lidar_pose": TPose.from_twist(s["lidar_pose"]).to_twist()}
             for s in _pose_states(seed=4)]
    ckpt = tmapper.build_ckpt(params, prop, poses, WorldCube.from_dict(CUBE), 7)
    tmapper.save_checkpoint(str(tmp_path / "checkpoints" / "final.tar"), ckpt)
    back = tmapper.load_checkpoint(str(tmp_path / "checkpoints" / "final.tar"))
    assert set(back) == {"global_step", "network_state_dict", "poses", "world_cube",
                         "occ_model_state_dict"}
    assert all(isinstance(v, np.ndarray) for v in back["network_state_dict"]["sigma"]["mlp"]
               .values())

    mj, mt = jru.load_experiment(str(tmp_path)), tru.load_experiment(str(tmp_path), device=CPU)
    assert mj.global_step == 7
    for name, v in params["sigma"]["mlp"].items():
        np.testing.assert_array_equal(np.asarray(mj.field_params["sigma"]["mlp"][name]),
                                      v.numpy())
    for pose in tru.kf_pose_matrices(mt)[0]:
        o, d = _scan_rays(pose)
        out_j = jru.render_depth_chunked(mj, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK)
        out_t = tru.render_depth_chunked(mt, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK)
        _assert_renders_match(out_t, out_j, RTOL["float32"])


def test_voxel_downsample_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    pts[1000:] = pts[:1000] + rng.normal(0, 0.01, (1000, 3)).astype(np.float32)
    for voxel in (0.1, 0.5):
        out = t_voxel(pts, voxel)
        np.testing.assert_array_equal(out, j_voxel(pts, voxel))
        assert out.dtype == np.float32 and out.shape[0] < pts.shape[0]
    assert t_voxel(np.zeros((0, 3)), 0.1).shape == (0, 3)


def test_pose_world_cube_and_settings_match_jax():
    rng = np.random.default_rng(1)
    for tw in rng.normal(0, 1.0, (5, 6)):
        np.testing.assert_array_equal(TPose.from_twist(tw).matrix, JPose.from_twist(tw).matrix)
        np.testing.assert_allclose(TPose.from_twist(tw).to_twist(), JPose.from_twist(tw)
                                   .to_twist(), atol=1e-12)
    poses = np.stack([JPose.from_twist(tw).matrix for tw in rng.normal(0, 1.0, (4, 6))])
    cube_t, cube_j = t_world_cube(None, None, None, poses, RAY_RANGE), j_world_cube(
        None, None, None, poses, RAY_RANGE)
    assert cube_t.as_dict() == cube_j.as_dict()
    pts = rng.normal(0, 5, (10, 3))
    np.testing.assert_array_equal(cube_t.from_cube(cube_t.to_cube(pts)),
                                  cube_j.from_cube(cube_j.to_cube(pts)))
    s = TSettings({"mapper": {"optimizer": {"model_config": {"model": {
        "render": {"compositor": "pallas"}, "occ_model": {"prop_n_ctrl": 33}}}}}})
    assert s.mapper.optimizer.model_config.model.render.compositor == "pallas"
    assert isinstance(s.mapper.optimizer, TSettings) and s.as_plain_dict()["mapper"]
    for settings in (s, TSettings({"mapper": {}}), TSettings({})):
        js = JSettings(settings.as_plain_dict())
        assert t_impl.configured_compositor(settings) == j_impl.configured_compositor(js)
        assert t_impl.trained_n_ctrl(settings) == j_impl.trained_n_ctrl(js)


def _small_field():
    fcfg = tfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=tfield.MLPConfig(32, 2, 1), density_activation="softplus",
        sigma_mlp_bias=True, pos_encoding_intensity=tfield.HashEncodingConfig(
            n_levels=2, log2_hashmap_size=10),
    )
    return fcfg, tfield.init_field_params(torch.Generator().manual_seed(0), fcfg, CPU)


def test_render_rays_takes_the_fused_compositor_by_the_jax_rule(monkeypatch):
    fcfg, params = _small_field()
    prop = t_init_proposal(torch.Generator().manual_seed(1), TProp(n_freqs=8, n_neurons=16), CPU)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(20, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = trend.pack_rays(torch.tensor(rng.uniform(-0.2, 0.2, (20, 3)), dtype=torch.float32),
                           torch.tensor(d, dtype=torch.float32), torch.full((20,), 0.1),
                           torch.full((20,), 0.8))
    calls = []
    plain = tc.composite_plain
    monkeypatch.setattr(tc, "composite_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    sampler = trend.make_sampler(prop, n_ctrl=9)
    assert isinstance(sampler, trend.ProposalRaySampler)
    assert isinstance(trend.make_sampler(None), trend.UniformRaySampler)
    assert isinstance(trend.make_sampler(torch.zeros(8, 8, 8)), trend.OccGridRaySampler)

    def render(compositor, **kw):
        with torch.inference_mode():
            return trend.render_rays(rays, params, fcfg, sampler, 40, occ_state=prop,
                                     compositor=compositor, **kw)

    ref = render("xla", ret_var=True)
    for compositor in ("pallas", "plain"):
        out = render(compositor, ret_var=True)
        for k in ("depth", "weights", "opacity", "variance"):
            torch.testing.assert_close(out[k], ref[k], rtol=1e-5, atol=1e-6, msg=k)
        torch.testing.assert_close(out["z_vals"], ref["z_vals"], rtol=0, atol=0)
    assert len(calls) == 2
    render("pallas", ret_var=False)  # the fused compositor returns the variance: not taken
    render("pallas", ret_var=True, raw_noise_std=1.0, noise=torch.zeros(20, 40))  # noise
    assert len(calls) == 2
    with pytest.raises(ValueError):
        render("cuda", ret_var=True)


def test_what_is_not_ported_raises(jax_dirs, tmp_path):
    mt = tru.load_experiment(str(jax_dirs["float32"]), device=CPU)
    o, d = _scan_rays(np.eye(4))
    # The intensity head is ported: colours come back with the depths.
    out = tru.render_depth_chunked(mt, o, d, RAY_RANGE, n_samples=8, with_intensity=True)
    assert out["rgb"].shape == (o.shape[0], 3) and np.isfinite(out["rgb"]).all()
    # An occupancy-grid checkpoint (OGM) is ported: it loads as the grid and
    # renders through the OGM sampler as the JAX package renders it.
    ckpt = tmapper.load_checkpoint(str(jax_dirs["float32"] / "checkpoints" / "final.tar"))
    ckpt["occ_model_state_dict"] = np.random.default_rng(1).uniform(
        0.5, 4.0, (8, 8, 8)).astype(np.float32)
    _write_config(tmp_path, _model_settings("float32", "xla"))
    tmapper.save_checkpoint(str(tmp_path / "checkpoints" / "final.tar"), ckpt)
    mt = tru.load_experiment(str(tmp_path), device=CPU)
    assert isinstance(mt.occ_grid, torch.Tensor) and mt.occ_grid.shape == (8, 8, 8)
    out_t = tru.render_depth_chunked(mt, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK)
    out_j = jru.render_depth_chunked(jru.load_experiment(str(tmp_path)), o, d, RAY_RANGE,
                                     n_samples=N_SAMPLES, chunk=CHUNK)
    _assert_renders_match(out_t, out_j, RTOL["float32"])


def _hash_model_settings() -> dict:
    """The reference's model (cfg/model_config/default_model_config.yaml: hash
    sigma field, OGM sampler) at box_room_tiny's grid widths."""
    model = JSettings.load_from_file(
        str(REPO / "cfg/model_config/default_model_config.yaml")).as_plain_dict()
    nerf = model["model"]["nerf_config"]
    nerf["pos_encoding_sigma"].update(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5)
    nerf["pos_encoding_intensity"].update(n_levels=2, log2_hashmap_size=10)
    nerf["intensity_network"]["n_neurons"] = 16
    model["model"]["occ_model"]["voxel_size"] = 16
    assert "compositor" not in model["model"]["render"] and "encoding_sigma" not in nerf
    return model


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hash_ogm_experiment_renders_alike_in_both_packages(tmp_path, writer):
    """A hash-field / OGM experiment written by either package renders the same
    in the other. The grid's logits are positive, as a trained grid's are along
    the surfaces: the sampler's 1e-5 pdf floor then never meets f32 rounding of
    the interpolation (tests/test_torch_hash.py)."""
    model = _hash_model_settings()
    _write_config(tmp_path, model)
    grid = np.random.default_rng(6).uniform(0.5, 4.0, (16, 16, 16)).astype(np.float32)
    poses = [{**s, "lidar_pose": TPose.from_twist(s["lidar_pose"]).to_twist()}
             for s in _pose_states(seed=5)]
    if writer == "jax":
        fcfg = jfield.FieldConfig.from_settings(model["model"]["nerf_config"], 3)
        params = jfield.init_field_params(jax.random.key(1), fcfg)
        # A table of O(1) features, as a trained one holds, so the field is not flat.
        params["sigma"]["table"] = 2.0 * jax.random.normal(jax.random.key(2),
                                                           params["sigma"]["table"].shape)
        ckpt = {"global_step": 5, "network_state_dict": jax.tree.map(np.asarray, params),
                "occ_model_state_dict": grid, "poses": poses, "world_cube": CUBE}
        j_save(str(tmp_path / "checkpoints" / "final.tar"), ckpt)
    else:
        fcfg = tfield.FieldConfig.from_settings(model["model"]["nerf_config"], 3)
        params = tfield.init_field_params(torch.Generator().manual_seed(1), fcfg, CPU)
        params["sigma"]["table"] = 2.0 * torch.randn(params["sigma"]["table"].shape,
                                                     generator=torch.Generator().manual_seed(2))
        ckpt = tmapper.build_ckpt(params, torch.tensor(grid), poses, WorldCube.from_dict(CUBE), 5)
        tmapper.save_checkpoint(str(tmp_path / "checkpoints" / "final.tar"), ckpt)
    back = tmapper.load_checkpoint(str(tmp_path / "checkpoints" / "final.tar"))
    assert back["occ_model_state_dict"].shape == (16, 16, 16)
    assert back["occ_model_state_dict"].dtype == np.float32
    assert back["network_state_dict"]["sigma"]["table"].shape == (86074, 2)

    mj, mt = jru.load_experiment(str(tmp_path)), tru.load_experiment(str(tmp_path), device=CPU)
    assert mt.field_cfg.encoding_sigma == "hash" and mt.compositor == "xla"
    np.testing.assert_array_equal(mt.occ_grid.numpy(), grid)
    np.testing.assert_array_equal(mt.field_params["sigma"]["table"].numpy(),
                                  np.asarray(mj.field_params["sigma"]["table"]))
    for pose in tru.kf_pose_matrices(mt)[0]:
        o, d = _scan_rays(pose)
        out_j = jru.render_depth_chunked(mj, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK)
        out_t = tru.render_depth_chunked(mt, o, d, RAY_RANGE, n_samples=N_SAMPLES, chunk=CHUNK)
        assert np.abs(out_t["opacity"]).max() > 0.5  # the field is not empty
        _assert_renders_match(out_t, out_j, RTOL["float32"])


@pytest.mark.parametrize("entry", ["load_experiment", "render_full_map", "renderer_lidar CLI",
                                   "load_experiment on the CPU"])
def test_renderer_entry_points_run_on_the_card_unless_asked_for_the_cpu(jax_dirs, tmp_path,
                                                                        monkeypatch, entry):
    # No silent fallback: without a card, the default device raises and names the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log_dir = str(jax_dirs["float32"])
    if entry == "load_experiment on the CPU":
        assert tru.load_experiment(log_dir, device="cpu").device == CPU
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "load_experiment":
            tru.load_experiment(log_dir)
        elif entry == "render_full_map":
            trl.render_full_map(log_dir, out_dir=str(tmp_path))
        else:
            monkeypatch.setattr(sys, "argv", ["renderer_lidar", log_dir])
            runpy.run_path(trl.__file__, run_name="__main__")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("n", [0, 1, 50])
def test_pcd_round_trip(tmp_path, n):
    pts = np.random.default_rng(n).uniform(-5, 5, (n, 3)).astype(np.float32)
    trl.write_pcd(pts, str(tmp_path / "c.pcd"))
    back = trl.read_pcd(str(tmp_path / "c.pcd"))
    assert back.shape == (n, 3)
    np.testing.assert_allclose(back, pts, atol=1e-6)  # written as %.6f
    if n > 1:
        np.testing.assert_allclose(jrl.read_pcd(str(tmp_path / "c.pcd")), back, atol=0)


def test_cached_fourier_bmat_made_under_inference_mode_serves_autograd():
    # The projection is cached per process: a render (inference mode) that
    # asks first must not leave an inference tensor for a later training step.
    fcfg, params = _small_field()
    fcfg = replace(fcfg, fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=5.5))
    pts = torch.rand((16, 3), generator=torch.Generator().manual_seed(4)) * 2 - 1
    with torch.inference_mode():
        tfield.query_sigma(params, pts, fcfg)
    assert not tfield.fourier_bmat(fcfg.fourier_sigma, CPU).is_inference()
    w0 = params["sigma"]["mlp"]["w0"].clone().requires_grad_(True)
    grad_params = {**params, "sigma": {"mlp": {**params["sigma"]["mlp"], "w0": w0}}}
    tfield.query_sigma(grad_params, pts, fcfg).sum().backward()
    assert w0.grad is not None and torch.isfinite(w0.grad).all()
