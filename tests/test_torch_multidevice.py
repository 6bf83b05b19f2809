"""The port's multi-device mapper (``system.mesh_devices``) and the tracker's ICP
device (``tracker.icp.device``), on the CPU with gloo at small widths.

- The sharded phase runner: 4 ranks on the 1-D mesh ``[4]`` and on ``[2, 2]``
  (two keyframe ranks, each slot's points split over two ray ranks) run one W=8
  phase of 3 iterations (one dispatch of 3) on the draws the JAX package made,
  for the OGM + hash configuration of tests/test_mesh_sharding.py (f32 training
  encode, the port's CPU path) and a proposal + Fourier one. Every rank returns
  the same bits; the result matches the port's own one-device runner at that
  file's tolerances (losses rtol 2e-5 / atol 2e-6, twists rtol 2e-4 / atol
  1e-7, parameters rtol 2e-4 / atol 2e-6), and JAX's one-device
  ``make_phase_runner`` at the same tolerances for the proposal + Fourier
  configuration; for the hash field at the bounds that hold the port's one
  device to JAX (``_close_hash``), which already misses the tighter ones. JAX
  runs on one device, not on its virtual mesh.
- A one-rank mesh runs the one-device program to the bit.
- A camera phase (the intensity head trained from the window's images) on
  ``[2, 2]`` and on ``[4]`` against one device, at the same tolerances.
- The proposal + Fourier configuration with N_SKY sky rays a slot (the sky
  buffers filled) on ``[4]`` and ``[2, 2]``: against the port's one device, JAX's
  one device and JAX's own sharded phase on as many virtual devices, at the
  same tolerances.
- ``Optimizer(mesh=...)`` on a hash field against ``mesh=None``: an m=2 window
  on ``[2]`` and ``[2, 2]``, at the JAX Optimizer-level tolerances (twists
  rtol 1e-3 / atol 1e-4, losses rtol 2e-3 / atol 2e-4: the table's scatter-add
  order differs and Adam amplifies it on rarely-hit entries). The KF#1
  bootstrap under a mesh keeps the full window width: a 2-rank mesh against a
  1-rank one (the same program, no other rank). A restored checkpoint reaches
  every rank: after ``restore`` a 2-rank mesh matches one device again.
- ``Mapper``: ``mesh_devices: [2, 2]`` builds the 2-axis mesh; an indivisible
  window raises before any process starts.
- A tiny threaded SLAM run (box_room_tiny.yaml, window 4) through
  ``run_loner``'s command line with ``system.mesh_devices: 2`` and
  ``tracker.icp.device: 0`` as an override document: ATE under the bar, and no
  follower left afterwards.
- A killed follower makes rank 0 raise at its next command; ``launch`` refuses
  a ``__main__`` without a file (a spawned rank could not start).
- The teardown (``Mesh.leave``): four gloo ranks run a window through the
  ``Optimizer``, and ``close()`` returns within TEARDOWN_BOUND with every
  follower's exit code 0, each rank's teardown seconds reported and the runner
  cache empty; a follower that never reaches the teardown's barrier makes
  ``close()`` raise within the barrier's bound (shortened here), naming its
  rank, and leaves no process and no group behind.
- ``tracker.icp.device: 0`` on the CPU gives the unset tracker's transforms; an
  index the machine does not have raises (the JAX package falls back instead).

Every spawned process runs under a deadline of its own (``RANK_SECONDS``) and is
killed at teardown: pytest-timeout is not installed.
"""
import contextlib
import multiprocessing
import os
import pickle
import re
import signal
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from loner_tpu_torch import convert
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SPAWN = multiprocessing.get_context("spawn")
RANK_SECONDS = 120.0
W, N_LIDAR, S, ITERS = 8, 32, 16, 3
N_SKY = 8  # sky rays a slot of the sky case (cfg/synthetic/box_room_sky.yaml's, cut)


# -- processes ---------------------------------------------------------------------
def _child(target, index, args, queue) -> None:
    try:
        queue.put((index, "ok", target(index, *args)))
    except Exception:  # reported to the test, which raises it
        queue.put((index, "error", traceback.format_exc()))


def in_processes(n: int, target, args: tuple, seconds: float = RANK_SECONDS) -> list:
    """``target(i, *args)`` in n spawned processes, one OMP thread each; their
    results in order. Raises on a child's error or after ``seconds``; kills
    what is left either way."""
    queue = SPAWN.Queue()
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        # Not daemonic: a process here may start a mesh's followers itself.
        procs = [SPAWN.Process(target=_child, args=(target, i, args, queue)) for i in range(n)]
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    results = {}
    deadline = time.time() + seconds
    try:
        while len(results) < n:
            left = deadline - time.time()
            if left <= 0:
                raise TimeoutError(f"{n - len(results)} of {n} processes gave no result in "
                                   f"{seconds} s")
            try:
                i, status, value = queue.get(timeout=min(left, 1.0))
            except Exception:  # queue.Empty
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and len(results) < n and queue.empty():
                    time.sleep(0.5)
                    if queue.empty():
                        raise RuntimeError(f"a process exited with {dead} and no result")
                continue
            if status == "error":
                raise RuntimeError(f"process {i} failed:\n{value}")
            results[i] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.exitcode is None:
                p.kill()
                p.join(timeout=10)
    return [results[i] for i in range(n)]


# -- the sharded phase runner ----------------------------------------------------------
def _scans(w: int, n: int = 256, seed: int = 0):
    """tests/test_mesh_sharding.py's window: w scans of n unit directions."""
    rng = np.random.default_rng(seed)
    dirs, deps = [], []
    for _ in range(w):
        d = rng.normal(size=(3, n))
        dirs.append((d / np.linalg.norm(d, axis=0)).astype(np.float32))
        deps.append(rng.uniform(1.0, 10.0, n).astype(np.float32))
    return dirs, deps


def _sky_dirs(w: int, n: int = 40, seed: int = 1) -> list:
    """Upward unit directions, n a slot (every slot has sky)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(w):
        d = rng.normal(size=(3, n))
        d[2] = np.abs(d[2]) + 0.5
        out.append((d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32))
    return out


def _port_cfgs(config: str):
    if config == "proposal_fourier_sky":
        from dataclasses import replace

        cfg, fcfg = _port_cfgs("proposal_fourier")
        return replace(cfg, enable_sky=True, n_sky_samples=N_SKY), fcfg
    if config == "ogm_hash":
        cfg = topt.OptimizerConfig(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                                   window_size=W, occ_voxel_size=8, ray_range=(0.5, 12.0),
                                   steps_per_dispatch=3, encode_impl="vjp_f32")
        fcfg = tfield.FieldConfig(
            pos_encoding_sigma=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
            pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10))
        return cfg, fcfg
    from loner_tpu_torch.models.proposal import ProposalConfig as TProp

    cfg = topt.OptimizerConfig(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                               window_size=W, ray_range=(0.5, 12.0), samples_strategy="PROPOSAL",
                               prop_n_ctrl=9, prop_train_subsample=4, steps_per_dispatch=3,
                               proposal=TProp(n_freqs=4, n_neurons=16))
    fcfg = tfield.FieldConfig(
        fourier_sigma=tfield.FourierConfig(n_freqs=8, scale=6.0),
        sigma_mlp=tfield.MLPConfig(32, 2, 1), compute_dtype=torch.float32,
        pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
        encoding_sigma="fourier", density_activation="softplus", sigma_mlp_bias=True)
    return cfg, fcfg


def _jax_case(config: str) -> dict:
    """The JAX package's one-device phase and its inputs and draws, as numpy; for
    the sky case also its phase on the virtual devices of ``[4]`` and ``[2,
    2]`` (GSPMD shards the window's slots, the sky buffers with them, and each
    slot's points on the ray axis)."""
    import jax
    import jax.numpy as jnp
    from loner_tpu.mapping import optimizer as jopt
    from loner_tpu.mapping import rays as jrays
    from loner_tpu.models import field as jfield
    from loner_tpu.models.hash_encoding import HashEncodingConfig as JHash
    from loner_tpu.models.occupancy_grid import init_occ_grid
    from loner_tpu.models.proposal import ProposalConfig as JProp, init_proposal_params
    from loner_tpu.parallel import mesh as jmesh
    from test_torch_step import jax_step_draws

    sky = config == "proposal_fourier_sky"
    if config == "ogm_hash":
        cfg = jopt.OptimizerConfig(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                                   window_size=W, occ_voxel_size=8, ray_range=(0.5, 12.0),
                                   point_chunk=0, steps_per_dispatch=3, encode_impl="vjp_f32")
        fcfg = jfield.FieldConfig(pos_encoding_sigma=JHash(n_levels=2, log2_hashmap_size=10),
                                  pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10))
        occ = init_occ_grid(8)
    else:
        cfg = jopt.OptimizerConfig(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                                   window_size=W, ray_range=(0.5, 12.0),
                                   samples_strategy="PROPOSAL", prop_n_ctrl=9,
                                   prop_train_subsample=4, point_chunk=0, steps_per_dispatch=3,
                                   proposal=JProp(n_freqs=4, n_neurons=16))
        fcfg = jfield.FieldConfig(
            fourier_sigma=jfield.FourierConfig(n_freqs=8, scale=6.0),
            sigma_mlp=jfield.MLPConfig(32, 2, 1), compute_dtype=jnp.float32,
            sigma_kernel="pallas", pos_encoding_intensity=JHash(n_levels=2, log2_hashmap_size=10),
            encoding_sigma="fourier", density_activation="softplus", sigma_mlp_bias=True)
        occ = init_proposal_params(jax.random.key(5), cfg.proposal)
        if sky:
            from dataclasses import replace

            cfg = replace(cfg, enable_sky=True, n_sky_samples=N_SKY)
    dirs, deps = _scans(W)
    sky_dirs = _sky_dirs(W) if sky else [None] * W
    params = jfield.init_field_params(jax.random.key(0), fcfg)
    # The runner donates its inputs: take their values first.
    params_np, occ_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, occ)
    key = jax.random.key(1)
    bj = jrays.build_window_buffers(dirs, deps, sky_dirs, W)
    run = jopt.make_phase_runner(cfg, fcfg, jopt.PhaseSettings(num_iterations=ITERS), W,
                                 bj.dirs.shape[1], bj.sky_dirs.shape[1])

    def phase(mesh=None) -> dict:
        inputs = (jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, occ_np),
                  jnp.zeros((W, 6), jnp.float32), bj, jnp.ones((W,), jnp.float32))
        ctx = contextlib.nullcontext()
        if mesh is not None:
            inputs = (*(jmesh.replicate(t, mesh) for t in inputs[:3]),
                      jmesh.shard_window_buffers(bj, mesh), jmesh.replicate(inputs[4], mesh))
            ctx = jax.set_mesh(mesh)
        with ctx:
            out = run(*inputs, jnp.asarray(12.0, jnp.float32), jnp.zeros(3, jnp.float32), 0, key,
                      num_iterations=ITERS)
        return _outputs(jax.tree.map(np.asarray, out[0]), jax.tree.map(np.asarray, out[1]),
                        out[2], out[3])

    # The draws of JAX's programs at 3 fused steps a dispatch (one dispatch).
    draws = [jax_step_draws(jax.random.fold_in(jax.random.fold_in(key, 0), j), W, N_LIDAR, S,
                            config == "ogm_hash", n_sky=N_SKY if sky else 0) for j in range(ITERS)]
    case = {
        "config": config, "sky": sky_dirs,
        "params": params_np, "occ": occ_np,
        "draws": [{k: v.numpy() for k, v in vars(d).items() if v is not None} for d in draws],
        "want": phase(),
    }
    if sky:
        case["sharded"] = {(4,): phase(jmesh.make_mesh(4)), (2, 2): phase(jmesh.make_mesh_2d(2, 2))}
    return case


def _outputs(field, occ, twists, losses) -> dict:
    out = {"losses": np.asarray(losses), "twists": np.asarray(twists)}
    for part in ("sigma", "intensity"):
        for k, v in field[part]["mlp"].items():
            out[f"{part}.{k}"] = np.asarray(v)
        if "table" in field[part]:
            out[f"{part}.table"] = np.asarray(field[part]["table"])
    if isinstance(occ, dict):
        out.update({f"occ.{k}": np.asarray(v) for k, v in occ.items()})
    elif occ is not None:
        out["occ"] = np.asarray(occ)
    return out


def _port_phase(case: dict, mesh=None) -> dict:
    cfg, fcfg = _port_cfgs(case["config"])
    dirs, deps = _scans(W)
    b = trays.build_window_buffers(dirs, deps, case["sky"], W, device=CPU)
    if case["config"] == "ogm_hash":
        occ = convert.occ_grid_from_jax(case["occ"], CPU)
    else:
        occ = convert.proposal_params_from_jax(case["occ"], CPU)
    run = topt.make_phase_runner(cfg, fcfg, topt.PhaseSettings(num_iterations=ITERS), W,
                                 b.dirs.shape[1], b.sky_dirs.shape[1], CPU, mesh=mesh)
    draws = [topt.StepDraws(**{k: torch.from_numpy(v) for k, v in d.items()})
             for d in case["draws"]]
    field, occ, tw, losses, _ = run(
        convert.field_params_from_jax(case["params"], CPU), occ, torch.zeros(W, 6), b,
        torch.ones(W), torch.tensor(12.0), torch.zeros(3), 0, None, num_iterations=ITERS,
        draws=draws)
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()  # noqa: E731
    return _outputs(to_np(field), None if occ is None else to_np(occ), tw.numpy(), losses.numpy())


def _phase_rank(rank: int, spec, port: int, case: dict) -> dict:
    mesh = tmesh.join(spec, rank, port)
    try:
        return _port_phase(case, mesh)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jax_cases():
    return {}


def _close(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5, atol=2e-6,
                               err_msg=f"{what}: losses")
    np.testing.assert_allclose(got["twists"], want["twists"], rtol=2e-4, atol=1e-7,
                               err_msg=f"{what}: twists")
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        if k not in ("losses", "twists"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6,
                                       err_msg=f"{what}: {k}")


def _close_hash(got: dict, want: dict) -> None:
    """The hash field against JAX: the port's one device already misses JAX at
    ``_close``'s tolerances here (a twist by 5.5e-7, four table entries by up
    to 3e-6: f32 scatter-add and gradient sums in another order), so the bounds
    are tests/test_torch_dispatch.py's for the port against JAX on this model."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got["twists"], want["twists"], atol=1e-5)
    for k in want:
        if k.endswith(".table"):
            diff = np.abs(got[k] - want[k])
            assert np.quantile(diff, 0.999) <= 5e-6 and diff.max() <= 0.05 * 0.01, k
        elif k not in ("losses", "twists"):
            np.testing.assert_allclose(got[k], want[k], atol=5e-5, err_msg=k)


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["mesh4", "mesh2x2"])
@pytest.mark.parametrize("config", ["ogm_hash", "proposal_fourier", "proposal_fourier_sky"])
def test_sharded_phase_matches_jax_and_one_device(config, shape, jax_cases):
    if config not in jax_cases:
        jax_cases[config] = _jax_case(config)
    case = jax_cases[config]
    spec = (tmesh.make_mesh(4, CPU) if len(shape) == 1 else tmesh.make_mesh_2d(2, 2, CPU))
    assert spec.axis_names == (("data",) if len(shape) == 1 else ("data", "ray"))
    ranks = in_processes(4, _phase_rank, (spec, tmesh.free_port(), case))
    for r in range(1, 4):  # replicated state: every rank holds the same bits
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")
    one = _port_phase(case)
    _close(ranks[0], one, "mesh against the port's one device")
    if config == "ogm_hash":
        _close_hash(ranks[0], case["want"])
    else:
        _close(ranks[0], case["want"], "mesh against JAX")
    if "sharded" in case:
        _close(ranks[0], case["sharded"][shape], "mesh against JAX's sharded phase")
    # The phase moved the state.
    assert np.abs(ranks[0]["twists"]).max() > 1e-4


@pytest.mark.parametrize("config", ["ogm_hash", "proposal_fourier"])
def test_a_one_rank_mesh_is_the_one_device_program_to_the_bit(config, jax_cases):
    """Its collectives sum one term and its denominators are the window's counts:
    the program is the one-device program, bit for bit (on the card the same
    holds through the graphs with NCCL: chip_smoke.py phase 21)."""
    if config not in jax_cases:
        jax_cases[config] = _jax_case(config)
    case = jax_cases[config]
    (got,) = in_processes(1, _phase_rank, (tmesh.make_mesh(1, CPU), tmesh.free_port(), case))
    one = _port_phase(case)
    assert got.keys() == one.keys()
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)


def _camera_phase(_, spec=None, port=None) -> dict:
    """A phase that trains the intensity head from the window's images (hash
    field, OGM), on draws from one seeded generator; on a mesh rank when
    ``spec`` is given."""
    from dataclasses import replace

    from loner_tpu_torch.common.camera import get_ray_directions
    from loner_tpu_torch.datasets.synthetic import VirtualCamera
    from loner_tpu_torch.models.occupancy_grid import init_occ_grid

    mesh = None if spec is None else tmesh.join(spec, _, port)
    try:
        cfg, fcfg = _port_cfgs("ogm_hash")
        cfg = replace(cfg, n_camera_samples=8)
        dirs, deps = _scans(W)
        b = trays.build_window_buffers(dirs, deps, [None] * W, W, device=CPU)
        rng = np.random.default_rng(4)
        cam_dirs, _, _ = get_ray_directions(6, 8, np.array([[6.0, 0, 4], [0, 6.0, 3], [0, 0, 1]]))
        images = [rng.uniform(size=(6, 8, 3)).astype(np.float32) if i != 5 else None
                  for i in range(W)]
        camera = trays.build_camera_window_buffers(
            images, cam_dirs, VirtualCamera().lidar_to_camera().matrix.astype(np.float32), W)
        params = tfield.init_field_params(torch.Generator().manual_seed(0), fcfg, CPU)
        run = topt.make_phase_runner(
            cfg, fcfg, topt.PhaseSettings(num_iterations=ITERS, freeze_rgb_mlp=False), W,
            b.dirs.shape[1], b.sky_dirs.shape[1], CPU, mesh=mesh)
        field, occ, tw, losses, _ = run(
            params, init_occ_grid(8, CPU) + 0.1, torch.zeros(W, 6), b, torch.ones(W),
            torch.tensor(12.0), torch.zeros(3), 0, torch.Generator().manual_seed(3),
            num_iterations=ITERS, camera=camera)
        to_np = lambda t: {k: to_np(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()  # noqa: E731
        out = _outputs(to_np(field), occ.numpy(), tw.numpy(), losses.numpy())
        out["camera_losses"] = run.last_camera_losses.numpy()
        return out
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def test_camera_phase_on_a_2x2_mesh_matches_one_device():
    """Each rank builds its slots' camera rays and takes its share of them on
    the ray axis; the camera loss's mean is the window's."""
    _check_camera_phase(tmesh.make_mesh_2d(2, 2, CPU))


def test_camera_phase_on_a_four_rank_mesh_matches_one_device():
    """``[4]``: each rank builds and renders its two slots' camera rays whole."""
    _check_camera_phase(tmesh.make_mesh(4, CPU))


def _check_camera_phase(spec) -> None:
    ranks = in_processes(4, _camera_phase, (spec, tmesh.free_port()))
    one = _camera_phase(0)
    for r in range(1, 4):
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r}: {k}")
    np.testing.assert_allclose(ranks[0]["camera_losses"], one["camera_losses"], rtol=2e-5,
                               atol=2e-6)
    assert one["camera_losses"].min() > 0
    _close({k: v for k, v in ranks[0].items() if k != "camera_losses"},
           {k: v for k, v in one.items() if k != "camera_losses"}, "camera phase")
    # The intensity head was trained.
    assert np.abs(one["intensity.w0"] - tfield.init_field_params(
        torch.Generator().manual_seed(0), _port_cfgs("ogm_hash")[1], CPU)["intensity"]["mlp"][
        "w0"].numpy()).max() > 1e-4


# -- the Optimizer ---------------------------------------------------------------------
def _keyframes(n: int, seed: int = 0):
    from loner_tpu_torch.common.frame import Frame
    from loner_tpu_torch.common.pose import Pose
    from loner_tpu_torch.common.sensors import LidarScan
    from loner_tpu_torch.mapping.keyframe import KeyFrame

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        npts = 300 + 11 * i
        d = rng.normal(size=(3, npts))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        frame = Frame(LidarScan(d.astype(np.float32), rng.uniform(1.5, 9.5, npts).astype(
            np.float32), 100.0 + 0.2 * i + np.linspace(0.0, 0.1, npts)))
        frame._lidar_pose = Pose.from_twist(np.array([0.3 * i, 0.05 * i, 0, 0, 0, 0.09 * i]))
        out.append(KeyFrame(frame))
    return out


SCHEDULE = [{"num_keyframes": 1, "iteration_schedule": [
                {"num_iterations": 6, "freeze_poses": True, "freeze_sigma_mlp": False}]},
            {"num_keyframes": -1, "iteration_schedule": [
                {"num_iterations": 6, "freeze_poses": False, "freeze_sigma_mlp": False}]}]


JOINT = [{"num_keyframes": -1, "iteration_schedule": [
    {"num_iterations": 6, "freeze_poses": False, "freeze_sigma_mlp": False}]}]


def _optimizer(mesh_spec, schedule=JOINT, window_size: int = 2):
    """A hash-field optimizer whose window of 2 slots puts a keyframe on each rank
    of a 2-rank mesh (an empty slot's rays are all masked)."""
    cfg = topt.OptimizerConfig(n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S,
                               window_size=window_size, occ_voxel_size=8, ray_range=(1.0, 10.0),
                               steps_per_dispatch=3, encode_impl="vjp_f32", occ_update_every=5)
    fcfg = tfield.FieldConfig(
        pos_encoding_sigma=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10),
        pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10))
    return topt.Optimizer(cfg, fcfg, 12.0, np.zeros(3), schedule, CPU, seed=5,
                          skip_pose_refinement=False, mesh=mesh_spec)


def _run_windows(opt, windows) -> dict:
    """Each window through the optimizer; the losses, the written-back twists
    and the runners' window widths."""
    out = {"losses": [], "twists": []}
    try:
        for win in windows:
            opt.iterate_optimizer(win)
            out["losses"].append(opt.last_losses.copy())
            out["twists"].append(np.stack([kf.pose_twist() for kf in win]))
        out["widths"] = sorted({key[1] for key in opt._runner_cache})
        out["global_step"] = opt.state.global_step
    finally:
        opt.close()
    return out


def _optimizer_run(_, shape, bootstrap: bool) -> dict:
    kfs = _keyframes(3)
    if bootstrap:
        spec = tmesh.make_mesh(shape[0], CPU)
        return _run_windows(_optimizer(spec, SCHEDULE), [kfs[:1], kfs[:2]])
    one = _run_windows(_optimizer(None), [kfs[1:3]])
    kfs = _keyframes(3)
    spec = tmesh.make_mesh(shape[0], CPU) if len(shape) == 1 else tmesh.make_mesh_2d(*shape, CPU)
    return {"one": one, "mesh": _run_windows(_optimizer(spec), [kfs[1:3]]),
            "children": len(multiprocessing.active_children())}


@pytest.mark.parametrize("shape", [(2,), (2, 2)], ids=["mesh2", "mesh2x2"])
def test_optimizer_under_a_mesh_matches_one_device(shape):
    (res,) = in_processes(1, _optimizer_run, (shape, False))
    one, mesh = res["one"], res["mesh"]
    assert res["children"] == 0  # close() stopped the followers
    assert one["widths"] == mesh["widths"] == [2]
    np.testing.assert_allclose(mesh["twists"][0], one["twists"][0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mesh["losses"][0], one["losses"][0], rtol=2e-3, atol=2e-4)
    assert np.abs(mesh["twists"][0] - np.stack([k.pose_twist() for k in _keyframes(3)[1:3]])
                  ).max() > 1e-4


def test_bootstrap_under_a_mesh_keeps_the_full_width():
    two, one = in_processes(2, lambda_bootstrap, ())
    # One device runs the bootstrap at W=1; every mesh at the full width.
    assert one["widths"] == two["widths"] == [2]
    assert one["global_step"] == two["global_step"] == 12
    for a, b in zip(two["losses"], one["losses"]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
    for a, b in zip(two["twists"], one["twists"]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def lambda_bootstrap(index: int) -> dict:
    """Process 0: a 2-rank mesh; process 1: a 1-rank one (no follower)."""
    return _optimizer_run(index, (2,) if index == 0 else (1,), True)


def _restore_run(_) -> dict:
    """A checkpoint's state (another optimizer's, seed 9, a global step of 40)
    restored into a one-device optimizer and a 2-rank one, then one window each."""
    from loner_tpu_torch.mapping.mapper import build_ckpt

    from loner_tpu_torch.common.world_cube import WorldCube

    base = _optimizer(None)
    src = topt.Optimizer(base.config, base._field_cfg, 12.0, np.zeros(3), JOINT, CPU, seed=9)

    ckpt = build_ckpt(src.state.field_params, src.state.occ_grid, [],
                      WorldCube(scale_factor=12.0, shift=np.zeros(3)), 40)
    out = {}
    for name, spec in (("one", None), ("mesh", tmesh.make_mesh(2, CPU))):
        opt = _optimizer(spec)
        opt.restore(ckpt["network_state_dict"], ckpt["occ_model_state_dict"], 40, 2)
        out[name] = _run_windows(opt, [_keyframes(3)[1:3]])
    return out


def test_restore_under_a_mesh_reaches_every_rank():
    (res,) = in_processes(1, _restore_run, ())
    one, mesh = res["one"], res["mesh"]
    assert one["global_step"] == mesh["global_step"] == 46
    np.testing.assert_allclose(mesh["twists"][0], one["twists"][0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mesh["losses"][0], one["losses"][0], rtol=2e-3, atol=2e-4)


# -- the Mapper ------------------------------------------------------------------------
def _mapper(mesh_devices, window_size: int):
    from loner_tpu_torch.common.settings import load_config
    from loner_tpu_torch.common.signals import Signal
    from loner_tpu_torch.common.world_cube import WorldCube
    from loner_tpu_torch.mapping.mapper import Mapper

    settings, _ = load_config(str(REPO / "cfg/synthetic/box_room_tiny.yaml"))
    s = settings.mapper
    s.augment({"mesh_devices": mesh_devices,
               "keyframe_manager": {"window_selection": {"window_size": window_size}}})
    s["lidar_only"] = True
    s["debug"] = settings.debug
    s["log_directory"] = os.environ.get("TMPDIR", "/tmp")
    cube = WorldCube(scale_factor=10.0, shift=np.zeros(3))
    return Mapper(s, Signal(single_process=True), Signal(single_process=True), cube, CPU)


def _mapper_run(_) -> dict:
    mapper = _mapper([2, 2], 4)
    try:
        spec = mapper.optimizer.mesh.spec
        return {"axes": spec.axis_names, "shape": spec.shape, "size": spec.size,
                "children": len(multiprocessing.active_children())}
    finally:
        mapper.close()


def test_mapper_builds_the_2axis_mesh_from_settings():
    (res,) = in_processes(1, _mapper_run, ())
    assert res == {"axes": ("data", "ray"), "shape": (2, 2), "size": 4, "children": 3}


@pytest.mark.parametrize("mesh_devices", [2, [2, 1]])
def test_mapper_raises_for_a_window_the_mesh_does_not_divide(mesh_devices):
    with pytest.raises(ValueError, match="does not divide"):
        _mapper(mesh_devices, 3)
    assert not torch.distributed.is_initialized()
    assert not multiprocessing.active_children()


def test_a_ray_axis_must_divide_the_point_pad():
    from types import SimpleNamespace

    spec = tmesh.make_mesh_2d(1, 3, CPU)
    assert spec.shape == (1, 3) and spec.backend == "gloo"
    rank2 = SimpleNamespace(spec=spec, ray_index=2)  # the shard arithmetic of rank 2
    with pytest.raises(ValueError, match="point pad 4096 does not divide"):
        tmesh.Mesh.points(rank2, 4096)
    assert tmesh.Mesh.points(rank2, 4098) == (2732, 4098)
    with pytest.raises(ValueError, match="cards"):
        tmesh.make_mesh(torch.cuda.device_count() + 1, "cuda:0")


def test_launch_refuses_a_main_module_without_a_file(monkeypatch):
    """A spawned rank runs ``__main__`` again from its file (a script read from
    standard input has none): ``launch`` raises before it starts any process."""
    import sys
    import types

    fake = types.ModuleType("__main__")
    fake.__file__ = "<stdin>"
    monkeypatch.setitem(sys.modules, "__main__", fake)
    with pytest.raises(RuntimeError, match="re-import __main__"):
        tmesh.launch(tmesh.make_mesh(2, CPU), _phase_rank, ())
    assert not multiprocessing.active_children()
    assert not torch.distributed.is_initialized()


# -- a follower that dies --------------------------------------------------------------
def _killed_run(_) -> dict:
    opt = _optimizer(tmesh.make_mesh(2, CPU))
    kfs = _keyframes(3)
    try:
        opt.iterate_optimizer(kfs[:2])
        follower = opt.mesh._processes[0]
        os.kill(follower.pid, signal.SIGKILL)
        follower.join(timeout=10)
        t0 = time.time()
        try:
            opt.iterate_optimizer(kfs[1:3])
        except RuntimeError as e:
            return {"error": str(e), "seconds": time.time() - t0}
        return {"error": None}
    finally:
        opt.close()


def test_a_killed_follower_makes_rank_0_raise():
    (res,) = in_processes(1, _killed_run, ())
    assert res["error"] is not None and "rank 1 exited" in res["error"], res
    assert res["seconds"] < 5.0


# -- the teardown ----------------------------------------------------------------------
TEARDOWN_BOUND = 20.0  # seconds: close() of a healthy 4-rank gloo mesh (~1 s here)


def _four_rank_close(_) -> dict:
    """An m=3 window on four gloo ranks (window 4: a slot a rank), then close()."""
    opt = _optimizer(tmesh.make_mesh(4, CPU), window_size=4)
    mesh = opt.mesh
    try:
        opt.iterate_optimizer(_keyframes(3))
    finally:
        t0 = time.time()
        opt.close()
        seconds = time.time() - t0
    return {"seconds": seconds, "exitcodes": [p.exitcode for p in mesh._processes],
            "teardown": mesh.teardown, "runners": len(opt._runner_cache),
            "captures": opt.graph_captures, "children": len(multiprocessing.active_children()),
            "initialized": torch.distributed.is_initialized()}


def test_close_after_a_phase_ends_every_rank_of_four():
    (res,) = in_processes(1, _four_rank_close, ())
    assert res["seconds"] < TEARDOWN_BOUND, res
    assert res["exitcodes"] == [0, 0, 0], res
    assert sorted(k for k in res["teardown"] if isinstance(k, int)) == [0, 1, 2, 3], res
    for r in range(4):
        steps = res["teardown"][r]
        assert set(steps) == {"release", "synchronize", "barrier", "leave", "total"}, steps
        assert steps["total"] < TEARDOWN_BOUND
    assert res["runners"] == 0 and res["children"] == 0 and not res["initialized"]
    assert res["captures"] == 0  # gloo on the CPU: eager, nothing captured


def _stuck_at_rank_2(mesh) -> None:
    """A follower's main: rank 2 never returns after the stop, so never reaches
    the teardown's barrier; the others return and run the teardown."""
    mesh.receive()
    if mesh.rank == 2:
        time.sleep(3600)


def _stuck_close(_, bound: float) -> dict:
    tmesh.TEARDOWN_SECONDS = bound
    mesh = tmesh.launch(tmesh.make_mesh(4, CPU), _stuck_at_rank_2)
    t0 = time.time()
    try:
        mesh.close()
        error = None
    except RuntimeError as e:
        error = str(e)
    return {"error": error, "seconds": time.time() - t0,
            "alive": [p.is_alive() for p in mesh._processes],
            "children": len(multiprocessing.active_children()),
            "initialized": torch.distributed.is_initialized()}


def test_a_follower_that_misses_the_teardown_barrier_makes_close_raise():
    bound = 3.0
    (res,) = in_processes(1, _stuck_close, (bound,))
    assert res["error"] is not None, res
    named = re.search(r"Ranks? ([\d, ]+) failed to pass monitoredBarrier", res["error"])
    assert named is not None and named.group(1).strip() == "2", res["error"]
    # The barrier's bound (TEARDOWN_SECONDS + the ranks), then the stuck follower is
    # killed and the group aborted.
    assert bound + 4 <= res["seconds"] < bound + 14.0, res
    assert not any(res["alive"]) and res["children"] == 0 and not res["initialized"], res


# -- SLAM ------------------------------------------------------------------------------
def _slam_run(_, dataset: str, prefix: str) -> dict:
    """``run_loner``'s command line, as a user runs the mesh: the settings as a
    config file, ``mesh_devices`` and ``icp.device`` as one override document."""
    from loner_tpu_torch.analysis.traj_metrics import evaluate_trajectory_files
    from loner_tpu_torch.common.json_yaml import write_json_yaml
    from loner_tpu_torch.common.settings import load_config
    from loner_tpu_torch.run_loner import main

    # tests/test_torch_slam.py's cut of box_room_tiny.yaml, threaded, window 4.
    settings, _ = load_config(str(REPO / "cfg/synthetic/box_room_tiny.yaml"))
    settings.augment({
        "system": {"single_threaded": False, "log_dir_prefix": prefix},
        "mapper": {"keyframe_manager": {"window_selection": {"window_size": 4}},
                   "optimizer": {
                       "num_samples": {"lidar": 64},
                       "keyframe_schedule": [
                           {"num_keyframes": 1, "iteration_schedule": [
                               {"num_iterations": 60, "freeze_poses": True,
                                "freeze_sigma_mlp": False, "freeze_rgb_mlp": True}]},
                           {"num_keyframes": -1, "iteration_schedule": [
                               {"num_iterations": 10, "freeze_poses": False,
                                "freeze_sigma_mlp": False, "freeze_rgb_mlp": True}]}],
                       "model_config": {"model": {"render": {"N_samples_train": 32}}}}},
    })
    config = os.path.join(prefix, "config.yaml")
    overrides = os.path.join(prefix, "mesh.yaml")
    os.makedirs(prefix, exist_ok=True)
    write_json_yaml(config, settings.as_plain_dict())
    with open(overrides, "w") as f:
        f.write("{system: {mesh_devices: 2}, tracker: {icp: {device: 0}}}\n")
    main([dataset, config, "--overrides", overrides, "--run_all_combos", "--experiment_name",
          "port_mesh2", "--device", "cpu"])
    log_dir = os.path.join(prefix, "port_mesh2")
    with open(os.path.join(log_dir, "full_config.pkl"), "rb") as f:
        full = pickle.load(f)
    res = evaluate_trajectory_files(
        os.path.join(log_dir, "trajectory", "estimated_trajectory.txt"),
        os.path.join(log_dir, "trajectory", "groundtruth.txt"), delta_m=1.0)
    timing = np.loadtxt(os.path.join(log_dir, "timing.csv"), delimiter=",", ndmin=2)
    return {"ate": res["ate"]["rmse"], "children": len(multiprocessing.active_children()),
            "keyframes": len(timing), "mesh_devices": full["system"]["mesh_devices"],
            "icp_device": full["tracker"]["icp"]["device"],
            "final": os.path.exists(os.path.join(log_dir, "checkpoints", "final.tar"))}


def test_threaded_slam_on_a_two_rank_mesh(tmp_path):
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
    from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence

    root = str(tmp_path / "ds")
    scans, poses, ts, _, _ = generate_sequence(
        num_scans=24, lidar=VirtualLidar(num_channels=16, num_columns=128, max_range=30.0),
        rate_hz=5.0)
    writer = ScanStreamWriter(root)
    for s in scans:
        writer.add_scan(s)
    writer.write_gt(poses, ts)
    (res,) = in_processes(1, _slam_run, (root, str(tmp_path / "out")), seconds=240.0)
    assert res["mesh_devices"] == 2 and res["icp_device"] == 0
    assert res["final"] and res["keyframes"] >= 2
    assert res["ate"] < 0.15, res
    assert res["children"] == 0


# -- tracker.icp.device ----------------------------------------------------------------
def _tracker(icp_extra: dict):
    from loner_tpu_torch.common.settings import Settings
    from loner_tpu_torch.common.signals import Signal
    from loner_tpu_torch.tracking.tracker import Tracker

    schedule = [{"threshold": 0.5, "max_iterations": 10}, {"threshold": 0.1,
                                                           "max_iterations": 10}]
    settings = Settings({
        "system": {"lidar_only": True},
        "calibration": {"lidar_to_camera": {"xyz": [0, 0, 0], "orientation": [0, 0, 0, 1]}},
        "tracker": {
            "icp": {"schedule": schedule, "scan_duration": 1,
                    "downsample": {"type": "UNIFORM", "target_uniform_point_count": 512},
                    **icp_extra},
            "synchronization": {"enabled": False, "max_time_delta": 0.5},
            "frame_synthesis": {"frame_decimation_rate_hz": 5, "frame_match_tolerance": 0.01,
                                "frame_delta_t_sec_tolerance": 0.02, "decimate_on_load": False},
            "motion_compensation": {"enabled": False},
        },
    })
    return Tracker(settings, None, Signal(), Signal(), CPU)


def test_icp_device_zero_on_the_cpu_matches_the_unset_tracker():
    rng = np.random.default_rng(3)
    cloud = rng.uniform(-5.0, 5.0, (512, 3)).astype(np.float32)
    angle = 0.05
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                    [0, 0, 1]], np.float32)
    target = cloud @ rot.T + np.array([0.1, -0.05, 0.02], np.float32)
    out = []
    for extra in ({}, {"device": 0}):
        tracker = _tracker(extra)
        assert tracker._device == CPU
        result = tracker._dispatch_icp(cloud, target, np.eye(4))
        out.append(result.transformation.numpy())
    np.testing.assert_array_equal(out[1], out[0])
    assert np.abs(out[0][:3, 3]).max() > 0.01


@pytest.mark.parametrize("index", [1, 99])
def test_icp_device_out_of_range_raises(index):
    with pytest.raises(ValueError, match="tracker.icp.device"):
        _tracker({"device": index})
