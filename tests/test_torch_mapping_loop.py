"""The PyTorch port's mapping loop against the JAX package's, on the CPU.

- ``KeyFrameManager``: the same frames are elected and the same windows drawn
  for the same seed (TEMPORAL, MOTION and HYBRID gating; HYBRID and RANDOM
  windows), and new keyframes are re-based onto the optimised reference alike.
- ``DeviceScanPool``: its windows equal ``build_window_buffers`` of the same
  scans, bit for bit, and each keyframe's scan is uploaded once (a larger scan
  re-pads the pool).
- ``Optimizer.iterate_optimizer``: a 1-keyframe bootstrap and then a
  2-keyframe window (tracking refinement with ``latest_kf_only``, then the
  joint phase) against JAX's, in f32 with a tiny Fourier field, the port
  started from JAX's initial parameters through ``restore``. FIXED rays,
  ``perturb: 0`` and ``raw_noise_std: 0`` make both deterministic. Losses
  within rtol 2e-5, written-back twists within 1e-5 (twelve Adam steps of f32
  gradients summed in another order), equal ``global_step`` and checkpoint
  schema.
- The same at the reference's configuration, OGM sampler + hash sigma field
  (box_room_tiny's grid widths, f32 training encode), with perturb and sigma
  noise on: the port's generator is replaced by the draws JAX made from its
  per-phase keys, and the grid takes its SGD step at global steps 0 and 10.
  Twists within 1e-5, the grid within 5e-5 and the checkpoint schema (the grid a
  (V, V, V) f32 array) equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.common.frame import Frame as JFrame
from loner_tpu.common.pose import Pose as JPose
from loner_tpu.common.sensors import LidarScan as JScan
from loner_tpu.common.settings import Settings as JSettings
from loner_tpu.mapping import optimizer as jopt
from loner_tpu.mapping.keyframe import KeyFrame as JKeyFrame
from loner_tpu.mapping.keyframe_manager import KeyFrameManager as JKFM
from loner_tpu.mapping.mapper import jax_tree_to_numpy
from loner_tpu.models import field as jfield
from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
from loner_tpu.models.proposal import ProposalConfig as JProp
from loner_tpu_torch.common.frame import Frame as TFrame
from loner_tpu_torch.common.pose import Pose as TPose
from loner_tpu_torch.common.sensors import LidarScan as TScan
from loner_tpu_torch.common.settings import Settings as TSettings
from loner_tpu_torch.common.world_cube import WorldCube
from loner_tpu_torch.mapping import mapper as tmapper
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.mapping.keyframe import KeyFrame as TKeyFrame
from loner_tpu_torch.mapping.keyframe_manager import KeyFrameManager as TKFM
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig as THash
from loner_tpu_torch.models.proposal import ProposalConfig as TProp

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _scan(rng, n: int, t0: float):
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return d.astype(np.float32), rng.uniform(1.5, 9.5, n).astype(np.float32), t0 + np.linspace(
        0.0, 0.1, n)


def _frames(n_frames: int, n_points: int = 64, seed: int = 0):
    """Matching JAX and port frames at 5 Hz along a turning path."""
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for i in range(n_frames):
        d, z, ts = _scan(rng, n_points + 7 * i, 100.0 + 0.2 * i)
        twist = np.array([0.3 * i, 0.05 * i, 0.0, 0.0, 0.0, 0.09 * i])
        fj, ft = JFrame(None, JScan(d, z, ts)), TFrame(TScan(d, z, ts))
        fj._lidar_pose, ft._lidar_pose = JPose.from_twist(twist), TPose.from_twist(twist)
        out_j.append(fj)
        out_t.append(ft)
    return out_j, out_t


def _kfm_settings(kf_strategy: str, window_strategy: str) -> dict:
    return {
        "keyframe_selection": {"strategy": kf_strategy, "temporal": {"time_diff_seconds": 0.5},
                               "motion": {"translation_threshold_m": 0.5,
                                          "rotation_threshold_deg": 12.0}},
        "window_selection": {"strategy": window_strategy, "window_size": 4,
                             "hybrid_settings": {"num_recent_frames": 2}},
    }


@pytest.mark.parametrize("kf_strategy,window_strategy", [
    ("TEMPORAL", "HYBRID"), ("MOTION", "RANDOM"), ("HYBRID", "HYBRID"), ("HYBRID_LAZY", "RANDOM"),
])
def test_keyframe_manager_matches_jax(kf_strategy, window_strategy):
    frames_j, frames_t = _frames(40)
    kfm_j = JKFM(JSettings(_kfm_settings(kf_strategy, window_strategy)), seed=3)
    kfm_t = TKFM(TSettings(_kfm_settings(kf_strategy, window_strategy)), seed=3)
    n_windows = 0
    for i, (fj, ft) in enumerate(zip(frames_j, frames_t)):
        kj, kt = kfm_j.process_frame(fj), kfm_t.process_frame(ft)
        assert (kj is None) == (kt is None), i
        assert kfm_j.get_last_mapped_time() == kfm_t.get_last_mapped_time()
        if kj is None:
            continue
        win_j, win_t = kfm_j.get_active_window(), kfm_t.get_active_window()
        assert [k.get_time() for k in win_j] == [k.get_time() for k in win_t]
        n_windows += 1
        # An optimised pose written back into the newest keyframe re-bases the
        # next one, in both packages.
        shift = np.array([0.01 * i, 0.0, 0.0, 0.0, 0.0, 0.001 * i])
        win_j[-1].set_pose_twist(win_j[-1].pose_twist() + shift)
        win_t[-1].set_pose_twist(win_t[-1].pose_twist() + shift)
    assert n_windows >= 5
    states_j, states_t = kfm_j.get_poses_state(), kfm_t.get_poses_state()
    assert len(states_j) == len(states_t)
    for sj, st in zip(states_j, states_t):
        assert sj.keys() == st.keys() and sj["timestamp"] == st["timestamp"]
        for k in ("lidar_pose", "tracked_pose"):
            np.testing.assert_allclose(st[k], sj[k], atol=1e-12)


def test_device_scan_pool_matches_window_buffers_and_uploads_once():
    _, frames = _frames(6, n_points=3000)
    kfs = [TKeyFrame(f) for f in frames]
    pool = trays.DeviceScanPool(CPU)
    windows = [kfs[:1], kfs[:3], kfs[1:4] + kfs[:1], kfs[2:5]]
    for win in windows:
        got = pool.build_window(win, 4, use_mask=False)
        want = trays.build_window_buffers([k.scan_dirs() for k in win],
                                          [k.scan_depths() for k in win], [None] * len(win), 4,
                                          device=CPU)
        for name in ("dirs", "depths", "counts", "sky_dirs", "sky_counts", "slot_valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name).numpy(), err_msg=name)
    assert pool.uploads == 5
    # A scan beyond the 4096-point size class re-pads the whole pool.
    big = TKeyFrame(_frames(1, n_points=5000, seed=9)[1][0])
    got = pool.build_window([kfs[0], big], 2, use_mask=False)
    want = trays.build_window_buffers([kfs[0].scan_dirs(), big.scan_dirs()],
                                      [kfs[0].scan_depths(), big.scan_depths()], [None] * 2, 2,
                                      device=CPU)
    assert got.dirs.shape[1] == 8192
    np.testing.assert_array_equal(got.dirs.numpy(), want.dirs.numpy())
    np.testing.assert_array_equal(got.depths.numpy(), want.depths.numpy())
    assert pool.uploads == 6


SCHEDULE = [
    {"num_keyframes": 1, "iteration_schedule": [
        {"num_iterations": 4, "freeze_poses": True, "freeze_sigma_mlp": False}]},
    {"num_keyframes": -1, "iteration_schedule": [
        {"num_iterations": 3, "freeze_poses": False, "latest_kf_only": True,
         "freeze_sigma_mlp": True},
        {"num_iterations": 5, "freeze_poses": False, "freeze_sigma_mlp": False}]},
]


def _optimizers():
    common = dict(n_lidar_samples=16, n_sky_samples=0, n_samples_per_ray=32,
                  ray_range=(1.0, 10.0), samples_strategy="PROPOSAL", rays_strategy="FIXED",
                  perturb=0.0, raw_noise_std=0.0, lr_sigma=0.005, prop_n_ctrl=9,
                  prop_train_subsample=4, window_size=2)
    cfg_j = jopt.OptimizerConfig(**common, point_chunk=0, proposal=JProp(n_freqs=8, n_neurons=16))
    cfg_t = topt.OptimizerConfig(**common, proposal=TProp(n_freqs=8, n_neurons=16))
    field = dict(encoding_sigma="fourier", density_activation="softplus", sigma_mlp_bias=True)
    fcfg_j = jfield.FieldConfig(
        fourier_sigma=jfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=jfield.MLPConfig(32, 2, 1), compute_dtype=jnp.float32, sigma_kernel="pallas",
        pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10), **field)
    fcfg_t = tfield.FieldConfig(
        fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=tfield.MLPConfig(32, 2, 1), compute_dtype=torch.float32,
        pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
        **field)
    opt_j = jopt.Optimizer(cfg_j, fcfg_j, 12.0, np.zeros(3), SCHEDULE,
                           skip_pose_refinement=False, seed=0)
    opt_t = topt.Optimizer(cfg_t, fcfg_t, 12.0, np.zeros(3), SCHEDULE, CPU,
                           skip_pose_refinement=False, seed=0)
    opt_t.restore(jax_tree_to_numpy(opt_j.state.field_params),
                  jax_tree_to_numpy(opt_j.state.occ_grid), 0, 0)
    return opt_j, opt_t


def test_iterate_optimizer_matches_jax():
    frames_j, frames_t = _frames(2, n_points=200)
    kfs_j = [JKeyFrame(f) for f in frames_j]
    kfs_t = [TKeyFrame(f) for f in frames_t]
    opt_j, opt_t = _optimizers()
    for window in ([0], [0, 1]):
        loss_j = opt_j.iterate_optimizer([kfs_j[i] for i in window])
        loss_t = opt_t.iterate_optimizer([kfs_t[i] for i in window])
        assert np.isfinite(loss_t)
        np.testing.assert_allclose(opt_t.last_losses, opt_j.last_losses, rtol=2e-5)
        np.testing.assert_allclose(opt_t.last_depth_eps, opt_j.last_depth_eps, rtol=2e-5)
        for kj, kt in zip(kfs_j, kfs_t):
            np.testing.assert_allclose(kt.pose_twist(), kj.pose_twist(), atol=1e-5)
        assert opt_t.state.global_step == opt_j.state.global_step
    assert opt_t.state.global_step == 4 + 3 + 5
    assert kfs_t[0].is_anchored and not kfs_t[1].is_anchored
    # The anchored keyframe kept its pose; the other one moved.
    np.testing.assert_allclose(kfs_t[0].pose_twist(), frames_t[0].get_lidar_pose().to_twist(),
                               atol=1e-6)
    assert np.abs(kfs_t[1].pose_twist() - frames_t[1].get_lidar_pose().to_twist()).max() > 1e-5
    for k, v in jax_tree_to_numpy(opt_j.state.field_params)["sigma"]["mlp"].items():
        np.testing.assert_allclose(opt_t.state.field_params["sigma"]["mlp"][k].numpy(), v,
                                   atol=1e-5, err_msg=k)

    # Checkpoint schema: the same nesting, names, shapes and dtypes.
    cube = WorldCube(12.0, np.zeros(3))
    ckpt_t = tmapper.build_ckpt(opt_t.state.field_params, opt_t.state.occ_grid,
                                [k.get_pose_state() for k in kfs_t], cube,
                                opt_t.state.global_step)
    ckpt_j = {"network_state_dict": jax_tree_to_numpy(opt_j.state.field_params),
              "occ_model_state_dict": jax_tree_to_numpy(opt_j.state.occ_grid),
              "poses": [k.get_pose_state() for k in kfs_j]}

    def schema(tree):
        if isinstance(tree, dict):
            return {k: schema(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [schema(v) for v in tree]
        if isinstance(tree, np.ndarray):
            return (tree.shape, str(tree.dtype))
        return type(tree).__name__

    for key in ckpt_j:
        assert schema(ckpt_t[key]) == schema(ckpt_j[key]), key
    assert set(ckpt_t) == {"global_step", "network_state_dict", "poses", "world_cube",
                           "occ_model_state_dict"}


def _schema(tree):
    if isinstance(tree, dict):
        return {k: _schema(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_schema(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return (tree.shape, str(tree.dtype))
    return type(tree).__name__


def test_iterate_optimizer_at_ogm_and_hash_matches_jax(monkeypatch):
    from test_torch_step import jax_step_draws

    tiny = dict(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5)
    common = dict(n_lidar_samples=16, n_sky_samples=0, n_samples_per_ray=32,
                  ray_range=(1.0, 10.0), samples_strategy="OGM", rays_strategy="RANDOM",
                  lr_sigma=0.01, occ_voxel_size=16, occ_lr=0.5, occ_update_every=10,
                  encode_impl="vjp_f32", window_size=2)
    cfg_j = jopt.OptimizerConfig(**common, point_chunk=0, steps_per_dispatch=1)
    cfg_t = topt.OptimizerConfig(**common)
    fcfg_j = jfield.FieldConfig(pos_encoding_sigma=JHash(**tiny),
                                sigma_mlp=jfield.MLPConfig(16, 1, 1),
                                pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10))
    fcfg_t = tfield.FieldConfig(pos_encoding_sigma=THash(**tiny),
                                sigma_mlp=tfield.MLPConfig(16, 1, 1),
                                pos_encoding_intensity=THash(n_levels=2, log2_hashmap_size=10))
    opt_j = jopt.Optimizer(cfg_j, fcfg_j, 12.0, np.zeros(3), SCHEDULE,
                           skip_pose_refinement=False, seed=4)
    opt_t = topt.Optimizer(cfg_t, fcfg_t, 12.0, np.zeros(3), SCHEDULE, CPU,
                           skip_pose_refinement=False, seed=4)
    assert opt_t.state.occ_grid.shape == (16, 16, 16)
    opt_t.restore(jax_tree_to_numpy(opt_j.state.field_params),
                  np.asarray(opt_j.state.occ_grid), 0, 0)

    # JAX's key schedule: Optimizer splits (field, proposal, rest), each phase
    # takes a split of the rest, each single-step iteration fold_in(fold_in(k, i), 1).
    keys = list(jax.random.split(jax.random.key(4), 3))
    phases = [(1, 4), (2, 3), (2, 5)]  # (window slots, iterations) in schedule order
    queue = []
    k_rest = keys[2]
    for w, n in phases:
        k_rest, sub = jax.random.split(k_rest)
        queue += [(w, jax.random.fold_in(jax.random.fold_in(sub, i), 1)) for i in range(n)]

    def jax_draws(generator, cfg, window_size, device, camera=False):
        w, k_step = queue.pop(0)
        assert w == window_size and not camera
        return jax_step_draws(k_step, w, cfg.n_lidar_samples, cfg.n_samples_per_ray, ogm=True)

    monkeypatch.setattr(topt, "draw_step", jax_draws)
    frames_j, frames_t = _frames(2, n_points=200, seed=1)
    kfs_j = [JKeyFrame(f) for f in frames_j]
    kfs_t = [TKeyFrame(f) for f in frames_t]
    for window in ([0], [0, 1]):
        opt_j.iterate_optimizer([kfs_j[i] for i in window])
        opt_t.iterate_optimizer([kfs_t[i] for i in window])
        np.testing.assert_allclose(opt_t.last_losses, opt_j.last_losses, rtol=2e-5)
        for kj, kt in zip(kfs_j, kfs_t):
            np.testing.assert_allclose(kt.pose_twist(), kj.pose_twist(), atol=1e-5)
    assert not queue and opt_t.state.global_step == opt_j.state.global_step == 12
    grid_j = np.asarray(opt_j.state.occ_grid)
    np.testing.assert_allclose(opt_t.state.occ_grid.numpy(), grid_j, atol=5e-5)
    assert np.abs(grid_j).max() > 1e-3  # updated at global steps 0 and 10

    cube = WorldCube(12.0, np.zeros(3))
    ckpt_t = tmapper.build_ckpt(opt_t.state.field_params, opt_t.state.occ_grid,
                                [k.get_pose_state() for k in kfs_t], cube,
                                opt_t.state.global_step)
    ckpt_j = {"network_state_dict": jax_tree_to_numpy(opt_j.state.field_params),
              "occ_model_state_dict": jax_tree_to_numpy(opt_j.state.occ_grid),
              "poses": [k.get_pose_state() for k in kfs_j]}
    for key in ckpt_j:
        assert _schema(ckpt_t[key]) == _schema(ckpt_j[key]), key
    assert _schema(ckpt_t["occ_model_state_dict"]) == ((16, 16, 16), "float32")


def test_optimizer_rejects_debug_dumps():
    """The five debug dumps are ported (tests/test_torch_debug.py): each flag is
    taken and sets the runners' extras mode as the JAX package's does; a flag
    the JAX package has not is still refused."""
    cfg = topt.OptimizerConfig(samples_strategy="UNIFORM")
    fcfg = tfield.FieldConfig(encoding_sigma="fourier", fourier_sigma=tfield.FourierConfig(n_freqs=8),
                              sigma_mlp=tfield.MLPConfig(16, 2, 1))
    with pytest.raises(TypeError):
        topt.Optimizer(cfg, fcfg, 12.0, np.zeros(3), SCHEDULE, CPU, draw_everything=True)
    for flags, mode in (({}, "none"), ({"log_losses": True}, "none"),
                        ({"write_ray_point_clouds": True}, "none"), ({"store_ray": True}, "ray"),
                        ({"store_ray": True, "draw_samples": True}, "full"),
                        ({"draw_rays_eps": True}, "full")):
        opt = topt.Optimizer(cfg, fcfg, 12.0, np.zeros(3), SCHEDULE, CPU, **flags)
        assert opt._extras_mode == mode, flags
