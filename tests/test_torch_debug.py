"""The PyTorch port's debug dumps against the JAX package's, on the CPU.

- The writers (``write_pcd_xyz``, ``write_pcd_xyz_intensity``,
  ``dump_ray_point_cloud``, ``dump_frame_point_cloud`` with its sky cloud,
  ``log_losses``) and ``IterationRayRecordDumper`` (store_ray, draw_samples,
  draw_rays_eps over dispatches of 3 and 1 iterations) give the JAX package's
  directory tree, byte for byte, from the same numpy arrays.
- The per-iteration record (``extras_mode`` ``"ray"`` and ``"full"``) changes
  no parameter, twist, grid or loss: a phase with it equals one without it to
  the bit, eagerly and through the graph logic on the CPU (``HostGraph``), and
  the graph's records equal the eager loop's to the bit; a phase's records
  come one a dispatch, stacked (k, B, ...), k = 1 under ``"full"``.
- A keyframe window with all five mapper flags through both optimizers, at the
  two tiny configurations of ``tests/test_torch_mapping_loop.py`` (proposal,
  deterministic; OGM + hash grid on JAX's draws), the ray-cloud batch picked by
  JAX's uniforms from ``jax.random.key(0)``: the same files, their numbers
  within the mapping loop test's tolerances.
- The tracker's frame clouds through both trackers on the same scans: the same
  files, points within the tracker test's pose tolerance times the range.
"""
import os
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from loner_tpu.common.frame import Frame as JFrame
from loner_tpu.common.sensors import LidarScan as JScan
from loner_tpu.common.settings import Settings as JSettings
from loner_tpu.common.signals import Signal as JSignal
from loner_tpu.mapping.keyframe import KeyFrame as JKeyFrame
from loner_tpu.runtime import debug_artifacts as jdbg
from loner_tpu.tracking.tracker import Tracker as JTracker
from loner_tpu_torch.common.frame import Frame as TFrame
from loner_tpu_torch.common.sensors import LidarScan as TScan
from loner_tpu_torch.common.settings import Settings as TSettings
from loner_tpu_torch.common.signals import Signal as TSignal
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping.keyframe import KeyFrame as TKeyFrame
from loner_tpu_torch.mapping.phase_graph import FULL_EXTRAS, RAY_EXTRAS, PhaseProgram
from loner_tpu_torch.runtime import debug_artifacts as tdbg
from loner_tpu_torch.tracking.tracker import Tracker as TTracker

torch.set_num_threads(1)
CPU = torch.device("cpu")


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _record(rng, t, b, s, full):
    rec = {"rays": rng.normal(size=(t, b, 11)).astype(np.float32),
           "depths_cube": rng.uniform(0.1, 0.8, (t, b)).astype(np.float32),
           "std": rng.uniform(0, 1, (t, b)).astype(np.float32),
           "js": rng.uniform(0, 3, (t, b)).astype(np.float32),
           "valid": rng.random((t, b)) > 0.2}
    if full:
        w = rng.random((t, b, s)).astype(np.float32)
        w[w < 0.5] = 0.0
        rec.update(points=rng.normal(size=(t, b, s, 3)).astype(np.float32), w_pred=w,
                   w_gt=np.roll(w, 1, axis=-1), z_m=rng.uniform(1, 9, (t, b, s)).astype(np.float32),
                   per_ray_eps=rng.uniform(0.5, 2, (t, b)).astype(np.float32))
    return rec


def _frames_with_sky(rng):
    d = rng.normal(size=(3, 50))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    z = rng.uniform(1, 9, 50).astype(np.float32)
    ts = np.linspace(100.0, 100.1, 50)
    sky = d[:, :7] * np.array([[1], [1], [-1]], np.float32)
    fj, ft = JFrame(None, JScan(d, z, ts)), TFrame(TScan(d, z, ts))
    fj.lidar_points.sky_rays, ft.lidar_points.sky_rays = sky, sky.copy()
    return fj, ft


def test_debug_writers_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    trees = {}
    for pkg, mod in (("jax", jdbg), ("port", tdbg)):
        root = str(tmp_path / pkg)
        r = np.random.default_rng(1)
        pts, inten = r.normal(size=(40, 3)) * 5, r.random(40)
        mod.write_pcd_xyz(pts, os.path.join(root, "a", "xyz.pcd"))
        mod.write_pcd_xyz_intensity(pts, inten, os.path.join(root, "a", "xyzi.pcd"))
        mod.dump_ray_point_cloud(r.normal(size=(30, 11)).astype(np.float32),
                                 r.uniform(0.1, 0.9, 30).astype(np.float32), root, "kf_3")
        mod.log_losses(r.random(7), r.random(7), root, 2, 1)
        fj, ft = _frames_with_sky(np.random.default_rng(2))
        mod.dump_frame_point_cloud(fj if pkg == "jax" else ft, root, 5)
        dumper = mod.IterationRayRecordDumper(
            root, 4, n_lidar=3, n_sky=1, window_slots=2, num_kfs=2, world_scale=12.0,
            world_shift=np.array([0.5, -1.0, 0.25], np.float32), eps_min=0.5, js_alpha=1.5,
            max_js_score=2.0, store_ray=True, draw_samples=True, draw_rays_eps=True)
        for t in (3, 1):
            dumper.append(_record(r, t, 8, 5, full=True))
        dumper.finish()
        mod.dump_iteration_ray_record([_record(r, 2, 8, 5, full=False)], root, 6, 3, 1, 2, 1,
                                      12.0, np.zeros(3, np.float32), 0.5, 1.0, 2.0, store_ray=True)
        trees[pkg] = tree(root)
    assert trees["port"] == trees["jax"]
    names = set(trees["port"])
    assert {"frames/cloud_5.pcd", "frames/cloud_5_sky.pcd", "rays/lidar/kf_4.pcd",
            "rays/js/kf_6.npy", "samples/samples_kf4_it3_gt.pcd", "rays_eps/origins_kf4_it0.pcd",
            "losses/keyframe_2/phase_1.csv", "depth_eps/keyframe_2/phase_1.csv",
            "rays/kf_3_rays.pcd"} <= names
    assert len([n for n in names if n.startswith("samples/")]) == 8  # 4 iterations x 2


# -- the record through the phase program ---------------------------------------

def _phase_inputs():
    from test_torch_dispatch import _hash_phase_inputs

    return _hash_phase_inputs()


def _outputs(out):
    field, occ, tw, losses, eps = out
    return [losses, eps, tw, occ, field["sigma"]["table"], *field["sigma"]["mlp"].values()]


@pytest.mark.parametrize("mode", ["ray", "full"])
@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "host_graph"])
def test_the_record_changes_no_bit_of_training(mode, graphs):
    from test_torch_dispatch import ITERS, HostGraph

    cfg, fcfg, w, buffers, params, grid, twists, draws = _phase_inputs()
    cfg = replace(cfg, steps_per_dispatch=3, max_inflight_dispatches=1)
    phase = topt.PhaseSettings(num_iterations=ITERS)
    args = (params, grid, twists, buffers, torch.ones(w), torch.tensor(12.0), torch.zeros(3), 9,
            None)

    def program(extras_mode, with_graphs):
        p = PhaseProgram(cfg, fcfg, phase, w, CPU, graphs=with_graphs, extras_mode=extras_mode,
                         graph_class=HostGraph)
        if with_graphs:
            p.capture(*args[:-2], None)
        return p

    ref = _outputs(program("none", graphs)(*args, draws=draws))
    log = []
    got = _outputs(program(mode, graphs)(*args, draws=draws, extras_log=log))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # One record a dispatch: 3 + 3 + 1 at k = 3, all single under "full".
    k = 1 if mode == "full" else 3
    sizes = [k] * (ITERS // k) + [1] * (ITERS % k)
    assert [rec["rays"].shape[0] for rec in log] == sizes
    names = FULL_EXTRAS if mode == "full" else RAY_EXTRAS
    b, s = w * cfg.n_lidar_samples, cfg.n_samples_per_ray
    for rec in log:
        assert set(rec) == set(names)
        t = rec["rays"].shape[0]
        assert rec["rays"].shape == (t, b, 11) and rec["valid"].dtype == bool
        assert rec["std"].shape == rec["js"].shape == rec["depths_cube"].shape == (t, b)
        if mode == "full":
            assert rec["points"].shape == (t, b, s, 3) and rec["w_gt"].shape == (t, b, s)
    # Each record's rays are its iteration's: the same draws give the same rays.
    if graphs:
        eager_log = []
        program(mode, False)(*args, draws=draws, extras_log=eager_log)
        for rg, re in zip(log, eager_log):
            for name in names:
                np.testing.assert_array_equal(rg[name], re[name], err_msg=name)
    # A second phase on the same program reuses its host slots.
    again = []
    p = program(mode, graphs)
    p(*args, draws=draws, extras_log=[])
    p(*args, draws=draws, extras_log=again)
    for r1, r2 in zip(again, log):
        for name in names:
            np.testing.assert_array_equal(r1[name], r2[name], err_msg=name)


def test_extras_mode_sets_the_dispatch_size():
    cfg = topt.OptimizerConfig(steps_per_dispatch=4)
    assert [topt.fused_steps(cfg, m) for m in ("none", "ray", "full")] == [4, 4, 1]
    with pytest.raises(ValueError, match="extras_mode"):
        PhaseProgram(cfg, None, topt.PhaseSettings(), 2, CPU, graphs=False, extras_mode="all")


# -- a keyframe window with every flag, against JAX --------------------------------

FLAGS = dict(log_losses=True, write_ray_point_clouds=True, store_ray=True, draw_samples=True,
             draw_rays_eps=True)


def _numbers(data: bytes, name: str):
    if name.endswith(".npy"):
        import io

        return np.load(io.BytesIO(data))
    if name.endswith(".pcd"):
        lines = data.decode().splitlines()
        header = lines[:11]
        body = np.array([[float(v) for v in ln.split()] for ln in lines[11:]])
        return header, body
    return np.array([float(v) for v in data.decode().split()])


def _flagged_optimizers(config, dirs, monkeypatch):
    """Both packages' optimizers with every mapper flag, the port's started from
    JAX's parameters. ``proposal``: the mapping loop test's deterministic tiny
    configuration (FIXED rays, no jitter, no noise); ``ogm_hash``: its OGM +
    hash-grid one, the port fed the draws JAX makes from its per-phase keys."""
    from test_torch_mapping_loop import SCHEDULE, _optimizers
    from test_torch_step import jax_step_draws
    from loner_tpu.mapping import optimizer as jopt
    from loner_tpu.mapping.mapper import jax_tree_to_numpy
    from loner_tpu.models import field as jfield
    from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
    from loner_tpu_torch.models import field as tfield
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig as THash

    if config == "proposal":
        base_j, base_t = _optimizers()
        cfg_j, cfg_t, fcfg_j, fcfg_t = (base_j._cfg, base_t._cfg, base_j._field_cfg,
                                        base_t._field_cfg)
        seed, frames_seed = 0, 0
    else:
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
        seed, frames_seed = 4, 1
        # JAX's key schedule (tests/test_torch_mapping_loop.py): a split of the
        # rest a phase, fold_in(fold_in(k, i), 1) a single-step iteration.
        queue, k_rest = [], jax.random.split(jax.random.key(seed), 3)[2]
        for w, n in [(1, 4), (2, 3), (2, 5)]:
            k_rest, sub = jax.random.split(k_rest)
            queue += [(w, jax.random.fold_in(jax.random.fold_in(sub, i), 1)) for i in range(n)]

        def jax_draws(generator, cfg, window_size, device, camera=False):
            w, k_step = queue.pop(0)
            assert w == window_size
            return jax_step_draws(k_step, w, cfg.n_lidar_samples, cfg.n_samples_per_ray, ogm=True)

        monkeypatch.setattr(topt, "draw_step", jax_draws)
    opt_j = jopt.Optimizer(cfg_j, fcfg_j, 12.0, np.zeros(3), SCHEDULE, skip_pose_refinement=False,
                           seed=seed, log_directory=dirs["jax"], **FLAGS)
    opt_t = topt.Optimizer(cfg_t, fcfg_t, 12.0, np.zeros(3), SCHEDULE, CPU,
                           skip_pose_refinement=False, seed=seed, log_directory=dirs["port"],
                           **FLAGS)
    occ = opt_j.state.occ_grid
    opt_t.restore(jax_tree_to_numpy(opt_j.state.field_params),
                  jax_tree_to_numpy(occ) if isinstance(occ, dict) else np.asarray(occ), 0, 0)
    return opt_j, opt_t, frames_seed


@pytest.mark.parametrize("config", ["proposal", "ogm_hash"])
def test_optimizer_with_all_five_flags_matches_jax(config, tmp_path, monkeypatch):
    from test_torch_mapping_loop import _frames

    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    opt_j, opt_t, frames_seed = _flagged_optimizers(config, dirs, monkeypatch)
    frames_j, frames_t = _frames(2, n_points=200, seed=frames_seed)
    kfs_j = [JKeyFrame(f) for f in frames_j]
    kfs_t = [TKeyFrame(f) for f in frames_t]
    cfg = opt_t.config
    for window in ([0], [0, 1]):
        w = 1 if len(window) == 1 else cfg.window_size
        # The ray-cloud batch: the uniforms JAX draws from jax.random.key(0).
        k_lidar, _ = jax.random.split(jax.random.key(0))
        u = torch.tensor(np.asarray(jax.random.uniform(k_lidar, (w, cfg.n_lidar_samples))))
        opt_j.iterate_optimizer([kfs_j[i] for i in window])
        opt_t.iterate_optimizer([kfs_t[i] for i in window], ray_cloud_u=u)
        np.testing.assert_allclose(opt_t.last_losses, opt_j.last_losses, rtol=2e-5)
    got, want = tree(dirs["port"]), tree(dirs["jax"])
    want.pop("timing.csv"), got.pop("timing.csv")
    assert sorted(got) == sorted(want)
    assert {"rays/kf_1_rays.pcd", "rays/lidar/kf_1.pcd", "rays/std/kf_0.npy",
            "losses/keyframe_1/phase_1.csv", "samples/samples_kf1_it7_gt.pcd",
            "rays_eps/rays_kf0_it3.pcd"} <= set(got)
    for name in sorted(want):
        a, b = _numbers(got[name], name), _numbers(want[name], name)
        if name.endswith(".pcd"):
            assert a[0] == b[0], name  # the header: fields and point count
            a, b = a[1], b[1]
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            # Weights and margins: the loop test's loss tolerance; points in
            # meters: its twist tolerance over the 12 m cube.
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5 * 12, err_msg=name)


# -- the tracker's frame clouds --------------------------------------------------------

def test_tracker_frame_clouds_match_jax(tmp_path):
    from test_torch_tracker import _port_scans, _scans, _settings

    scans = _scans()
    roots = {}
    for pkg, (tracker_cls, settings_cls, signal_cls, kw) in {
            "jax": (JTracker, JSettings, JSignal, {}),
            "port": (TTracker, TSettings, TSignal, {"device": CPU})}.items():
        s = _settings(True)
        root = str(tmp_path / pkg)
        s["tracker"].update(debug={"write_frame_point_clouds": True}, log_directory=root)
        lidar, frames = signal_cls(), signal_cls()
        out = frames.register()
        tracker = tracker_cls(settings_cls(s), None, lidar, frames, **kw)
        for scan in (scans if pkg == "jax" else _port_scans(scans)):
            lidar.emit((scan, None))
            tracker.update()
        tracker.flush()
        n = 0
        while out.has_value():
            out.get_value()
            n += 1
        roots[pkg] = (tree(root), n)
    (got, n_t), (want, n_j) = roots["port"], roots["jax"]
    assert n_t == n_j == len(got) == 5 and sorted(got) == sorted(want)
    for name in want:
        (ha, a), (hb, b) = _numbers(got[name], name), _numbers(want[name], name)
        assert ha == hb
        # Poses within 1e-4 m / 1e-4 rad (the tracker test) at ranges up to 30 m.
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 + 1e-4 * 30, err_msg=name)
