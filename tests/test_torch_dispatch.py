"""The port's dispatch schedule (``steps_per_dispatch``, ``max_inflight_dispatches``)
against the JAX package's, and its CUDA graphs.

- ``run_phase`` at k = 3 against JAX's ``make_phase_runner`` with
  ``steps_per_dispatch=3``, ``max_inflight_dispatches=1`` over 7 iterations (two
  fused dispatches and a single step), the port fed the draws JAX made from its
  dispatch keys (``fold_in(fold_in(key, i0), j)`` in a dispatch from i0,
  ``fold_in(fold_in(key, i), 1)`` for a single step i): the OGM sampler + hash
  field from global step 9 (the grid's SGD step at 10, inside the first
  dispatch), and the proposal sampler + Fourier field, at the sizes and the
  tolerances of tests/test_torch_step.py (losses rtol 2e-5; twists atol 1e-5, a
  bound twice that file's for more than twice its iterations, summation order
  of f32 gradients; the hash table's per-entry bound, 5% of lr over 3 Adam
  steps, scaled to 7 steps; the rest as there).
- The port at k = 1, 3 and 10 on the same draws gives the same bits, eagerly and
  through the graph runner with a graph type that runs on the CPU
  (``HostGraph``: a capture runs the iteration's Python once, a replay runs it
  again with the launch counts held, as a CUDA replay runs only kernels); there
  the counted launches are (kernels per iteration) x (iterations).
- ``OptimizerConfig.from_settings`` reads both knobs as the JAX package does,
  from cfg/synthetic/box_room_tpu_rt_r4.yaml (3, 1) and cfg/defaults.yaml (10, 2).
- ``run_dispatches`` waits on dispatch n - d before enqueuing dispatch n, and
  never with d = 0 (a fake event class records the order).
- On a CUDA card (marked ``cuda``, skipped without one): the captured iteration
  against the eager loop for both configurations, the ICP graph against the
  eager dispatch, and the in-flight wait letting another thread run. JAX is imported only by the tests that compare with it, so
  these run on a machine without it:
  ``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_dispatch.py -m cuda``.
"""
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from loner_tpu_torch import convert
from loner_tpu_torch.common import cuda_graphs
from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.mapping.phase_graph import PhaseProgram
from loner_tpu_torch.ops import hash_grid as thash_grid

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ITERS, K = 7, 3


class HostGraph(cuda_graphs.CountedGraph):
    """A CUDA graph's semantics on the CPU: the capture runs the function once
    (its Python, and here its work too); a replay runs it again and takes back
    the launch counts its wrappers added, since a replay runs no Python."""

    def __init__(self) -> None:
        self.launches = {}
        self._fn = None

    def _capture(self, fn, pool, stream, generators):
        self._fn = fn
        return fn()

    def _replay(self) -> None:
        held = cuda_graphs.launch_counts()
        self._fn()
        now = cuda_graphs.launch_counts()
        cuda_graphs.add_launch_counts({k: now[k] - held[k] for k in now}, -1)

    def pool(self):
        return None


def _dispatch_draws(key, w, n_lidar, s, ogm, n_iters=ITERS, k=K):
    """The draws of JAX's programs at k fused steps a dispatch."""
    import jax
    from test_torch_step import jax_step_draws

    keys = []
    i = 0
    while i + k <= n_iters:
        keys += [jax.random.fold_in(jax.random.fold_in(key, i), j) for j in range(k)]
        i += k
    keys += [jax.random.fold_in(jax.random.fold_in(key, i), 1) for i in range(i, n_iters)]
    return [jax_step_draws(kk, w, n_lidar, s, ogm) for kk in keys]


def _k3(cfg):
    return replace(cfg, steps_per_dispatch=K, max_inflight_dispatches=1)


def test_ogm_hash_phase_at_three_steps_a_dispatch_matches_jax():
    import jax
    import jax.numpy as jnp
    from loner_tpu.mapping import optimizer as jopt
    from loner_tpu.mapping import rays as jrays
    from loner_tpu.models import field as jfield
    from test_torch_step import N_LIDAR, S, W, _hash_configs, _scans

    cfg_j, cfg_t, fcfg_j, fcfg_t = _hash_configs("vjp_f32")
    cfg_j, cfg_t = _k3(cfg_j), _k3(cfg_t)
    assert jopt.fused_steps(cfg_j, "none") == topt.fused_steps(cfg_t) == K
    dirs, depths, twists = _scans(W, seed=3)
    params = jfield.init_field_params(jax.random.key(2), fcfg_j)
    params_np = jax.tree.map(np.asarray, params)
    grid = np.asarray(jax.random.normal(jax.random.key(8), (16, 16, 16))) * 0.1
    key, step0 = jax.random.key(9), 9  # global steps 9-15: the grid moves at 10

    bj = jrays.build_window_buffers(dirs, depths, [None] * W, W)
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, jopt.PhaseSettings(num_iterations=ITERS), W,
                                   bj.dirs.shape[1], bj.sky_dirs.shape[1])
    out_j = run_j(params, jnp.asarray(grid), jnp.asarray(twists), bj, jnp.ones(W),
                  jnp.asarray(12.0, jnp.float32), jnp.zeros(3), step0, key, num_iterations=ITERS)

    bt = trays.build_window_buffers(dirs, depths, [None] * W, W, device=CPU)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(num_iterations=ITERS), W,
                                   bt.dirs.shape[1], bt.sky_dirs.shape[1], CPU)
    out_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.occ_grid_from_jax(grid, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), step0, None, num_iterations=ITERS,
        draws=_dispatch_draws(key, W, N_LIDAR, S, True))
    (field_j, grid_j, tw_j, losses_j, eps_j), (field_t, grid_t, tw_t, losses_t, eps_t) = out_j, out_t
    assert losses_t.shape == (ITERS,) and np.asarray(losses_j).shape == (ITERS,)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=1e-5)
    assert np.abs(tw_t.numpy() - twists).max() > 1e-4
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v), atol=5e-5,
                                   err_msg=k)
    # tests/test_torch_step.py's table bound, its per-entry part (5% of lr over 3
    # Adam steps, where a near-cancelling gradient moves an entry by another
    # fraction of lr in each package) scaled to 7 steps.
    table_j = np.asarray(field_j["sigma"]["table"])
    diff = np.abs(field_t["sigma"]["table"].numpy() - table_j)
    assert np.quantile(diff, 0.999) <= 5e-6, np.quantile(diff, 0.999)
    assert diff.max() <= 0.05 * cfg_t.lr_sigma * ITERS / 3, diff.max()
    assert np.abs(table_j - params_np["sigma"]["table"]).max() > 1e-3
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), atol=5e-5)
    assert np.abs(np.asarray(grid_j) - grid).max() > 1e-3  # the update at step 10


def test_proposal_fourier_phase_at_three_steps_a_dispatch_matches_jax():
    import jax
    import jax.numpy as jnp
    from loner_tpu.mapping import optimizer as jopt
    from loner_tpu.mapping import rays as jrays
    from loner_tpu.models import field as jfield
    from loner_tpu.models.proposal import init_proposal_params
    from test_torch_step import N_LIDAR, S, W, _configs, _scans

    cfg_j, cfg_t, fcfg_j, fcfg_t = _configs("PROPOSAL", 1.0)
    cfg_j, cfg_t = _k3(cfg_j), _k3(cfg_t)
    dirs, depths, twists = _scans(W)
    params = jfield.init_field_params(jax.random.key(0), fcfg_j)
    prop = init_proposal_params(jax.random.key(5), cfg_j.proposal)
    params_np, prop_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, prop)
    key = jax.random.key(1)

    bj = jrays.build_window_buffers(dirs, depths, [None] * W, W)
    run_j = jopt.make_phase_runner(cfg_j, fcfg_j, jopt.PhaseSettings(num_iterations=ITERS), W,
                                   bj.dirs.shape[1], bj.sky_dirs.shape[1])
    field_j, prop_j, tw_j, losses_j, eps_j = run_j(
        params, prop, jnp.asarray(twists), bj, jnp.ones(W), jnp.asarray(12.0, jnp.float32),
        jnp.zeros(3), 0, key, num_iterations=ITERS)

    bt = trays.build_window_buffers(dirs, depths, [None] * W, W, device=CPU)
    run_t = topt.make_phase_runner(cfg_t, fcfg_t, topt.PhaseSettings(num_iterations=ITERS), W,
                                   bt.dirs.shape[1], bt.sky_dirs.shape[1], CPU)
    field_t, prop_t, tw_t, losses_t, eps_t = run_t(
        convert.field_params_from_jax(params_np, CPU), convert.proposal_params_from_jax(prop_np, CPU),
        convert.twists_from_jax(twists, CPU), bt, torch.ones(W), torch.tensor(12.0),
        torch.zeros(3), 0, None, num_iterations=ITERS,
        draws=_dispatch_draws(key, W, N_LIDAR, S, False))
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=2e-5)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=2e-5)
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), atol=1e-5)
    for k, v in field_j["sigma"]["mlp"].items():
        np.testing.assert_allclose(field_t["sigma"]["mlp"][k].numpy(), np.asarray(v), atol=5e-6,
                                   err_msg=k)
    for k, v in prop_j.items():
        np.testing.assert_allclose(prop_t[k].numpy(), np.asarray(v), atol=5e-6, err_msg=k)
    assert np.abs(tw_t.numpy() - twists).max() > 1e-4


def _hash_phase_inputs(seed: int = 3):
    """A tiny OGM + hash phase's configs, state and draws, all from numpy."""
    from loner_tpu_torch.models import field as tfield
    from loner_tpu_torch.models.hash_encoding import HashEncodingConfig as THash

    w, n_lidar, s = 2, 8, 32
    cfg = topt.OptimizerConfig(n_lidar_samples=n_lidar, n_sky_samples=0, n_samples_per_ray=s,
                               samples_strategy="OGM", lr_sigma=0.01, occ_voxel_size=16,
                               occ_lr=0.5, occ_update_every=10, encode_impl="vjp_f32")
    fcfg = tfield.FieldConfig(pos_encoding_sigma=THash(n_levels=6, log2_hashmap_size=14,
                                                       per_level_scale=1.5),
                              sigma_mlp=tfield.MLPConfig(16, 1, 1),
                              pos_encoding_intensity=THash(n_levels=2, log2_hashmap_size=10))
    rng = np.random.default_rng(seed)
    dirs = [rng.normal(size=(3, 100)) for _ in range(w)]
    dirs = [(d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32) for d in dirs]
    depths = [rng.uniform(1.5, 9.5, 100).astype(np.float32) for _ in range(w)]
    buffers = trays.build_window_buffers(dirs, depths, [None] * w, w, device=CPU)
    params = tfield.init_field_params(torch.Generator().manual_seed(2), fcfg, CPU)
    grid = torch.from_numpy((rng.normal(size=(16, 16, 16)) * 0.1).astype(np.float32))
    twists = torch.from_numpy(rng.normal(0, 0.02, (w, 6)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    draws = [topt.draw_step(gen, cfg, w, CPU) for _ in range(ITERS)]
    return cfg, fcfg, w, buffers, params, grid, twists, draws


@pytest.fixture
def counting_hash_kernels(monkeypatch):
    """The hash encode's plain version, counted as its CUDA wrappers count."""
    select = thash_grid._select

    def counting(pos01, plain):
        fwd, bwd = select(pos01, plain)

        def fwd_counted(*args, **kwargs):
            thash_grid.counts.fwd_launches += 1
            return fwd(*args, **kwargs)

        def bwd_counted(*args, need_dpos=True, **kwargs):
            groups = len(thash_grid.level_groups(args[3], thash_grid.BWD_GROUP_BYTES))
            thash_grid.counts.bwd_launches += groups
            thash_grid.counts.bwd_no_dpos_launches += groups * int(not need_dpos)
            return bwd(*args, need_dpos=need_dpos, **kwargs)

        return fwd_counted, bwd_counted

    monkeypatch.setattr(thash_grid, "_select", counting)
    thash_grid.counts.reset()
    yield thash_grid.counts
    thash_grid.counts.reset()


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "host_graph"])
@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("frozen", [False, True], ids=["poses", "frozen_poses"])
def test_steps_per_dispatch_keeps_the_numbers_and_counts_replays(k, graphs, frozen,
                                                                 counting_hash_kernels):
    cfg, fcfg, w, buffers, params, grid, twists, draws = _hash_phase_inputs()
    phase = topt.PhaseSettings(num_iterations=ITERS, freeze_poses=frozen)
    args = (params, grid, twists, buffers, torch.ones(w), torch.tensor(12.0), torch.zeros(3), 9,
            None)

    def outputs(out):
        field, occ, tw, losses, eps = out
        return [losses, eps, tw, occ, field["sigma"]["table"], *field["sigma"]["mlp"].values()]

    ref = outputs(topt.make_phase_runner(replace(cfg, steps_per_dispatch=1), fcfg, phase, w,
                                         4096, 4096, CPU)(*args, draws=draws))
    program = PhaseProgram(replace(cfg, steps_per_dispatch=k), fcfg, phase, w, CPU,
                           graphs=graphs, graph_class=HostGraph)
    if graphs:
        program.capture(*args[:-2], None)
        assert program.captured and program.captures == 2  # with and without the grid step
    counting_hash_kernels.reset()
    got = outputs(program(*args, draws=draws))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # One forward and one backward call a replay (a launch a level group: one at
    # this grid); frozen poses take the backward without dpos.
    groups = len(thash_grid.level_groups(fcfg.pos_encoding_sigma, thash_grid.BWD_GROUP_BYTES))
    assert groups == 1
    assert (counting_hash_kernels.fwd_launches, counting_hash_kernels.bwd_launches,
            counting_hash_kernels.bwd_no_dpos_launches) == (ITERS, ITERS, ITERS if frozen else 0)
    # A second phase on the same program starts from its inputs and a fresh Adam.
    again = outputs(program(*args, draws=draws))
    for a, b in zip(again, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _settings_pair(path: Path):
    """A config's mapper.optimizer settings as each package loads them."""
    from loner_tpu.common import settings as jsettings

    from loner_tpu_torch.common.settings import load_config

    raw = jsettings._load_yaml_with_includes(str(path))
    if isinstance(raw, dict) and "baseline" in raw:
        js = jsettings.Settings.load_from_file(str(path.parent / raw["baseline"]))
        js.augment(raw.get("changes"))
    else:
        js = jsettings.Settings(raw)
    ts, _ = load_config(str(path))
    return js.mapper.optimizer, ts.mapper.optimizer


@pytest.mark.parametrize("config,want", [("cfg/synthetic/box_room_tpu_rt_r4.yaml", (3, 1)),
                                         ("cfg/defaults.yaml", (10, 2))])
def test_from_settings_reads_the_dispatch_knobs_as_jax(config, want):
    from loner_tpu.mapping import optimizer as jopt

    js, ts = _settings_pair(REPO / config)
    cfg_j = jopt.OptimizerConfig.from_settings(js, js.model_config)
    cfg_t = topt.OptimizerConfig.from_settings(ts, ts.model_config)
    assert (cfg_t.steps_per_dispatch, cfg_t.max_inflight_dispatches) == want
    assert (cfg_j.steps_per_dispatch, cfg_j.max_inflight_dispatches) == want


class FakeEvent:
    log: list = []

    def __init__(self) -> None:
        self.n = sum(1 for e in FakeEvent.log if e[0] == "record")

    def record(self) -> None:
        FakeEvent.log.append(("record", self.n))

    def synchronize(self) -> None:
        FakeEvent.log.append(("wait", self.n))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_inflight_bound_waits_on_dispatch_n_minus_depth(depth):
    FakeEvent.log = []
    n_iters, k = 14, 3  # four dispatches of 3, then two single steps
    topt.run_dispatches(n_iters, k, depth,
                        lambda i0, kk: FakeEvent.log.append(("dispatch", i0, kk)), FakeEvent)
    want = []
    for n in range(4):
        if depth and n >= depth:
            want.append(("wait", n - depth))
        want += [("dispatch", 3 * n, 3), ("record", n)]
    want += [("dispatch", 12, 1), ("dispatch", 13, 1)]
    assert FakeEvent.log == want
    if depth == 0:
        assert not any(e[0] == "wait" for e in FakeEvent.log)


def test_one_step_a_dispatch_runs_single_steps_unbounded():
    log = []
    topt.run_dispatches(4, 1, 1, lambda i0, k: log.append((i0, k)), FakeEvent)
    assert log == [(0, 1), (1, 1), (2, 1), (3, 1)]
    assert topt.fused_steps(topt.OptimizerConfig(steps_per_dispatch=0)) == 1
    assert topt.fused_steps(topt.OptimizerConfig(), "full") == 1


def test_graphs_need_a_cuda_device():
    from loner_tpu_torch.models import field as tfield

    with pytest.raises(ValueError, match="CUDA graphs"):
        topt.make_phase_runner(topt.OptimizerConfig(), tfield.FieldConfig(),
                               topt.PhaseSettings(), 2, 4096, 4096, CPU, graphs=True)
    assert not topt.make_phase_runner(topt.OptimizerConfig(), tfield.FieldConfig(),
                                      topt.PhaseSettings(), 2, 4096, 4096, CPU).graphs


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["flagship", "reference"])
def test_graphs_match_the_eager_loop_on_the_card(cuda_device, config):
    """Both configurations' widths, 2 keyframes x 64 rays: the flagship (no
    atomics) to the bit, the reference (hash table and grid gradients by float
    atomics, in an order that changes per run) with losses within rtol 3e-3,
    chip_smoke.py's bound (measured on an H100: 1.3e-4)."""
    from loner_tpu_torch.analysis.profile_iteration import configs

    dev = cuda_device
    cfg, fcfg = configs(config)
    cfg = replace(cfg, n_lidar_samples=64, steps_per_dispatch=K)
    w = 2
    rng = np.random.default_rng(0)
    dirs = [rng.normal(size=(3, 5000)) for _ in range(w)]
    dirs = [(d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32) for d in dirs]
    depths = [rng.uniform(1.5, 9.5, 5000).astype(np.float32) for _ in range(w)]
    buffers = trays.build_window_buffers(dirs, depths, [None] * w, w, device=dev)
    state = topt.Optimizer(cfg, fcfg, 12.0, np.zeros(3), [], dev).state
    twists = torch.from_numpy(rng.normal(0, 0.02, (w, 6)).astype(np.float32)).to(dev)
    outs = {}
    for graphs in (True, False):
        run = topt.make_phase_runner(cfg, fcfg, topt.PhaseSettings(), w, buffers.dirs.shape[1],
                                     buffers.sky_dirs.shape[1], dev, graphs=graphs)
        outs[graphs] = run(state.field_params, state.occ_grid, twists, buffers,
                           torch.ones(w, device=dev), torch.tensor(12.0, device=dev),
                           torch.zeros(3, device=dev), 9, torch.Generator(device=dev).manual_seed(1),
                           num_iterations=ITERS)
    (_, _, tw_g, losses_g, _), (_, _, tw_e, losses_e, _) = outs[True], outs[False]
    assert losses_g.shape == (ITERS,) and torch.isfinite(losses_g).all()
    if config == "flagship":
        assert torch.equal(losses_g, losses_e) and torch.equal(tw_g, tw_e)
    else:
        torch.testing.assert_close(losses_g, losses_e, rtol=3e-3, atol=0)


@pytest.mark.cuda
def test_icp_graph_matches_the_eager_dispatch_on_the_card(cuda_device):
    from loner_tpu_torch.tracking.icp import ICPGraph, run_icp_schedule

    rng = np.random.default_rng(3)
    target = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    angle = 0.05
    rot = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                    [0, 0, 1]], np.float32)
    source = target @ rot.T + np.array([0.1, -0.05, 0.02], np.float32)
    schedule = [{"threshold": 1.5, "max_iterations": 10}, {"threshold": 0.125, "max_iterations": 10}]
    stream = torch.cuda.Stream(cuda_device, priority=-1)
    with torch.cuda.stream(stream):
        eager = run_icp_schedule(source, target, schedule, pad_size=3072, device=cuda_device)
        graph = ICPGraph(cuda_device, schedule, pad_size=3072)
        replayed = graph(source, target, None)
        chained_eager = run_icp_schedule(source, target, schedule, pad_size=3072,
                                         init=eager.transformation)
        chained_graph = graph(source, target, replayed.transformation)
        torch.cuda.synchronize()
    assert graph.captures == 1
    for a, b in ((eager, replayed), (chained_eager, chained_graph)):
        assert torch.equal(a.transformation, b.transformation)
        assert torch.equal(a.fitness, b.fitness)


@pytest.mark.cuda
def test_the_inflight_wait_lets_other_threads_run(cuda_device):
    """``run_dispatches`` waits on a ``torch.cuda.Event``; another thread (the
    tracker's) runs Python meanwhile."""
    import threading
    import time

    ticks, stop = [], threading.Event()

    def count():
        while not stop.is_set():
            ticks.append(1)
            time.sleep(1e-4)

    torch.cuda.synchronize()
    thread = threading.Thread(target=count)
    thread.start()
    # The wait before the second dispatch lasts the first one's ~0.3 s spin.
    topt.run_dispatches(6, 3, 1, lambda i0, k: torch.cuda._sleep(500_000_000), torch.cuda.Event)
    before = len(ticks)
    torch.cuda.synchronize()
    stop.set()
    thread.join()
    # A tick takes ~1 ms on the card's host (the 0.1 ms sleep rounds up), so a
    # free GIL gives hundreds in the wait, a held one a few.
    assert before > 50
