"""The port's mesher against the JAX package's, on the CPU.

Same numpy inputs from a seed go through the JAX function and its counterpart in
``loner_tpu_torch`` (``device="cpu"``):

- ``splat_weights_max`` against ``_splat_weights_max`` on the four cases of
  tests/test_mesher.py and a random one: equal bits (a max does not depend on
  the order of the updates);
- ``marching_tetrahedra`` on a seeded random grid and on a sphere's distance
  grid: the same faces, vertices within 1e-5 grid units (the weld's quantum;
  measured: equal bits);
- ``build_weight_grid`` at resolution 32 on experiments the port wrote (the
  flagship field cut small, f32, and the reference's hash field with an OGM
  grid): weights within 1e-4 absolute (weights lie in [0, 1]; measured 1e-6
  Fourier, 3e-6 hash: the two packages order f32 sums differently,
  tests/test_torch_render.py);
- ``get_mesh`` at resolution 32 (the weight grid's rays and samples cut for the
  CPU in both packages alike): vertex and face counts within 1% and a symmetric
  chamfer of the vertices below 1e-3 m (the grid's cells are 0.75 m wide), with
  and without a ``meshing_bounding_box``;
- ``write_ply`` / ``read_ply`` / ``read_ply_vertices``, ``sample_mesh_points``
  and ``mesh_to_pcd``: equal arrays (the same numpy draws from the same seeds).
"""
import functools
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from loner_tpu.analysis import mesh_to_pcd as jm2p
from loner_tpu.analysis import mesher as jmesher
from loner_tpu.analysis import render_utils as jru
from loner_tpu.ops import marching as jmarch
from loner_tpu_torch.analysis import mesh_to_pcd as tm2p
from loner_tpu_torch.analysis import mesher as tmesher
from loner_tpu_torch.analysis import render_utils as tru
from loner_tpu_torch.common.pose import Pose as TPose
from loner_tpu_torch.common.world_cube import WorldCube
from loner_tpu_torch.mapping import mapper as tmapper
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models.proposal import ProposalConfig as TProp
from loner_tpu_torch.models.proposal import init_proposal_params as t_init_proposal
from loner_tpu_torch.ops import marching as tmarch
from test_torch_render import CUBE, RAY_RANGE, _hash_model_settings, _model_settings, _pose_states

torch.set_num_threads(1)

CPU = torch.device("cpu")
VERT_ATOL = 1e-5  # grid units
GRID_ATOL = 1e-4  # weights
MESH_COUNT_SHARE = 0.01
MESH_CHAMFER_M = 1e-3
# The weight grid's virtual scans cut for the CPU (get_mesh's own: 64 x 512 rays,
# 512 samples, 8192-ray chunks).
SMALL_GRID = dict(n_samples=32, num_channels=8, num_columns=32, chunk=64)

# (grid shape, lo, hi, points, weights): tests/test_mesher.py's cases.
SPLAT_CASES = {
    "full cube": ((8, 8, 8), [-1.0] * 3, [1.0] * 3, [[0.125] * 3], [0.7]),
    "restricted bound": ((8, 8, 8), [0.0] * 3, [1.0] * 3, [[0.5625] * 3], [1.0]),
    "outside clamps": ((4, 4, 4), [0.0] * 3, [1.0] * 3, [[-0.5, 0.5, 0.5], [1.5, 0.5, 0.5]],
                       [0.3, 0.4]),
    "max keeps strongest": ((4, 4, 4), [-1.0] * 3, [1.0] * 3, [[0.1] * 3, [0.1] * 3], [0.2, 0.9]),
}


def _splat_inputs(case: str):
    if case != "random":
        shape, lo, hi, pts, w = SPLAT_CASES[case]
        return (np.zeros(shape, np.float32), np.float32(lo), np.float32(hi),
                np.float32(pts), np.float32(w))
    rng = np.random.default_rng(11)
    grid = rng.uniform(0, 0.5, (16, 16, 16)).astype(np.float32)  # include_self matters
    lo = rng.uniform(-1.0, -0.5, 3).astype(np.float32)
    hi = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (5000, 3)).astype(np.float32)  # some outside [lo, hi]
    pts[2500:] = pts[:2500]  # repeated cells
    return grid, lo, hi, pts, rng.uniform(0, 1, 5000).astype(np.float32)


@pytest.mark.parametrize("case", list(SPLAT_CASES) + ["random"])
def test_splat_weights_max_matches_jax_bits(case):
    grid, lo, hi, pts, w = _splat_inputs(case)
    ref = np.asarray(jmesher._splat_weights_max(*(jnp.asarray(a) for a in (grid, pts, w, lo, hi))))
    t_grid = torch.tensor(grid)
    out = tmesher.splat_weights_max(t_grid, *(torch.tensor(a) for a in (pts, w, lo, hi)))
    assert out is t_grid  # in place
    np.testing.assert_array_equal(out.numpy(), ref)


def _grid(kind: str):
    if kind == "random":
        return np.random.default_rng(0).uniform(0, 1, (9, 10, 11)).astype(np.float32), 0.5
    ax = np.linspace(-1, 1, 33)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - 0.6).astype(np.float32), 0.0


@pytest.mark.parametrize("kind", ["random", "sphere"])
def test_marching_tetrahedra_matches_jax(kind):
    grid, level = _grid(kind)
    vj, fj = jmarch.marching_tetrahedra(grid, level)
    vt, ft = tmarch.marching_tetrahedra(torch.tensor(grid), level)
    assert vt.dtype == torch.float32 and ft.dtype == torch.int64 and len(ft) > 1000
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=VERT_ATOL)
    # The compat wrapper hands numpy arrays back, as skimage's does.
    verts, faces, normals, values = tmarch.marching_cubes_compat(grid, level)
    assert isinstance(verts, np.ndarray) and normals is None and values is None
    np.testing.assert_array_equal(faces, fj)


def test_marching_tetrahedra_without_a_crossing_is_empty():
    grid = np.zeros((5, 5, 5), np.float32)
    vj, fj = jmarch.marching_tetrahedra(grid, 0.5)
    vt, ft = tmarch.marching_tetrahedra(torch.tensor(grid), 0.5)
    assert vt.shape == vj.shape == (0, 3) and ft.shape == fj.shape == (0, 3)


def _port_experiment(log_dir, kind: str, bbox=None) -> str:
    """An experiment written by the port: the flagship field cut small (f32) or
    the reference's hash field with a positive OGM grid; random weights from a
    seed, two keyframe poses."""
    model = _model_settings("float32", "xla") if kind == "fourier" else _hash_model_settings()
    os.makedirs(os.path.join(log_dir, "checkpoints"))
    config = {"mapper": {"optimizer": {"model_config": model}}, "world_cube": CUBE}
    if bbox is not None:
        config["meshing_bounding_box"] = bbox
    with open(os.path.join(log_dir, "full_config.pkl"), "wb") as f:
        pickle.dump(config, f)
    fcfg = tfield.FieldConfig.from_settings(model["model"]["nerf_config"], 3)
    gen = torch.Generator().manual_seed(3)
    params = tfield.init_field_params(gen, fcfg, CPU)
    if kind == "fourier":
        params["sigma"]["mlp"]["b1"] += 0.05 * torch.randn(params["sigma"]["mlp"]["b1"].shape,
                                                           generator=gen)
        occ = t_init_proposal(gen, TProp(n_freqs=8, n_neurons=16), CPU)
    else:
        params["sigma"]["table"] = 2.0 * torch.randn(params["sigma"]["table"].shape,
                                                     generator=gen)
        occ = torch.tensor(np.random.default_rng(6).uniform(0.5, 4.0, (16, 16, 16)),
                           dtype=torch.float32)
    poses = [{**s, "lidar_pose": TPose.from_twist(s["lidar_pose"]).to_twist()}
             for s in _pose_states(seed=4)]
    tmapper.save_checkpoint(os.path.join(log_dir, "checkpoints", "final.tar"),
                            tmapper.build_ckpt(params, occ, poses, WorldCube.from_dict(CUBE), 7))
    return str(log_dir)


BBOX = {"x": [-6.0, 4.0], "y": [-5.0, 5.0], "z": [-20.0, 3.0]}  # z reaches past the cube


@pytest.fixture(scope="module")
def port_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_written")
    return {"fourier": _port_experiment(root / "fourier", "fourier"),
            "hash": _port_experiment(root / "hash", "hash"),
            "fourier bbox": _port_experiment(root / "bbox", "fourier", BBOX)}


@pytest.mark.parametrize("kind", ["fourier", "hash"])
def test_build_weight_grid_matches_jax(port_dirs, kind):
    log_dir = port_dirs[kind]
    mj, mt = jru.load_experiment(log_dir), tru.load_experiment(log_dir, device=CPU)
    mats, _ = tru.kf_pose_matrices(mt)
    bound = np.array([[-0.6, -0.5, -0.8], [0.7, 0.5, 0.4]], np.float32)
    for b in (None, bound):
        gj = jmesher.build_weight_grid(mj, mats, RAY_RANGE, resolution=32, bound=b, **SMALL_GRID)
        gt = tmesher.build_weight_grid(mt, mats, RAY_RANGE, resolution=32, bound=b, **SMALL_GRID)
        assert gt.shape == (32, 32, 32) and gt.device == CPU
        assert (gj > 0.1).sum() > 50  # the level of get_mesh is crossed
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=GRID_ATOL)


@pytest.mark.parametrize("kind", ["fourier", "hash", "fourier bbox"])
def test_get_mesh_matches_jax(port_dirs, kind, monkeypatch, tmp_path):
    for module in (jmesher, tmesher):
        monkeypatch.setattr(module, "build_weight_grid",
                            functools.partial(module.build_weight_grid, **SMALL_GRID))
    log_dir = port_dirs[kind]
    vj, fj = jmesher.get_mesh(log_dir, resolution=32, skip_step=1,
                              out_file=str(tmp_path / "jax.ply"))
    report = {}
    vt, ft = tmesher.get_mesh(log_dir, resolution=32, skip_step=1, device="cpu",
                              out_file=str(tmp_path / "port.ply"), report=report)
    assert set(report) == {"weight_grid_s", "marching_s", "grid_max", "cells_above_level"}
    assert 0.1 < report["grid_max"] <= 1.0 and report["cells_above_level"] > 50
    assert len(vj) > 100 and np.isfinite(vt).all()
    assert abs(len(vt) - len(vj)) <= MESH_COUNT_SHARE * len(vj)
    assert abs(len(ft) - len(fj)) <= MESH_COUNT_SHARE * len(fj)
    chamfer = cKDTree(vj).query(vt)[0].mean() + cKDTree(vt).query(vj)[0].mean()
    assert chamfer < MESH_CHAMFER_M, chamfer
    np.testing.assert_allclose(tmesher.read_ply_vertices(str(tmp_path / "port.ply")), vt,
                               atol=1e-5)
    if kind == "fourier bbox":  # the vertices stay inside the box clipped to the cube
        model = tru.load_experiment(log_dir, device=CPU)
        lo, hi = model.world_cube.from_cube(tmesher.mesh_bound(model))
        assert (vt >= lo - 1e-4).all() and (vt <= hi + 1e-4).all()
        assert hi[2] < BBOX["z"][1] + 1e-4 and lo[2] > BBOX["z"][0]


def test_get_mesh_runs_on_the_card_unless_asked_for_the_cpu(port_dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesher.get_mesh(port_dirs["fourier"])


def test_ply_io_sampling_and_mesh_to_pcd_match_jax(tmp_path):
    grid, level = _grid("sphere")
    verts, faces = jmarch.marching_tetrahedra(grid, level)
    verts = verts / 16.0 - 1.0  # a sphere of radius 0.6 m
    tmesher.write_ply(verts, faces, str(tmp_path / "port.ply"))
    jmesher.write_ply(verts, faces, str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()
    rv, rf = tm2p.read_ply(str(tmp_path / "port.ply"))
    jv, jf = jm2p.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(rv, jv)
    np.testing.assert_array_equal(rf, jf)
    np.testing.assert_array_equal(tmesher.read_ply_vertices(str(tmp_path / "port.ply")), rv)
    for seed in (0, 5):
        np.testing.assert_array_equal(tmesher.sample_mesh_points(rv, rf, 3000, seed=seed),
                                      jmesher.sample_mesh_points(rv, rf, 3000, seed=seed))
    pts = tm2p.mesh_to_pcd(str(tmp_path / "port.ply"), n_points=40_000, voxel_size=0.05)
    np.testing.assert_array_equal(
        pts, jm2p.mesh_to_pcd(str(tmp_path / "port.ply"), n_points=40_000, voxel_size=0.05))
    radius = np.linalg.norm(pts, axis=1)
    assert pts.dtype == np.float32 and 0.55 < radius.min() and radius.max() < 0.65
