"""A ray's forward does not depend on what else its batch holds, on the CPU.

A mesh rank computes the window's forward for its share of the rays; it must
compute for each ray the bits one device computes for the whole window, or the
ranks' sums differ from one device's by more than the order of summation
(``chip_smoke.py``'s ``forward_batch_witness`` reads this op by op on the card).

- The proposal sampler's sample depths, and ``compute_lidar_loss``'s per-ray JS
  scores, depths and weights (the flagship's Fourier field in bf16 and f32,
  through its plain version here), on B rays equal to the bit the
  concatenation over B/2 and B/4 batches, the last batch shorter (a ragged
  tail).
- The proposal MLP's logits at every point count from 2 to 70 against one batch.
- The backward, per ray: the compositing's cotangent at each sample's sigma, the
  transmittance's (its reversed cumsum in blocks of ``SCAN_ROWS`` rays, over more
  than two blocks), and the hash field's (box_room_tiny's grid, the f32 MLP)
  cotangent at the encoder's output and dpos, each from seeded upstream
  cotangents, equal to the bit in 2 and 4 batches; on a card (``-m cuda``) the
  hash field's case again through its kernels, the hash pair and the sigma-MLP
  pair (``ops/sigma_mlp.py``).
- Two gloo ranks, each adding its half of the points' hash-table and OGM-grid
  gradients into fixed-point sums and all-reducing the int64 sums through
  ``Mesh.all_reduce_``: the one-rank sums to the bit.
- Four gloo ranks, ``[4]`` and ``[2, 2]``, each computing its share of a W=8
  window's first iteration (``iteration_loss`` with its ``WindowShard``), with
  LiDAR rays only and with N_SKY sky rays a slot too: the ranks' per-ray JS
  scores, sample depths and weights, in rank order, equal to the bit one
  device's for the whole window. (The ranks' phase against one
  device at tests/test_torch_multidevice.py's tolerances is that file's
  ``test_sharded_phase_matches_jax_and_one_device``.)

On the CPU PyTorch computes the sigmoid and the softplus over the last elements
of a contiguous run with its scalar function, which may round a value one ulp
from the vector loop's (the card computes every element with one function). So
the sampler's and the loss's batches here hold whole multiples of 32 rays, which
put each run's end on a vector boundary at every point count a ray has. At those
counts the CPU's one-column product happens to keep its order; the logits test,
with no sigmoid, takes every count, and fails on ``proposal_logits`` as one
product of one column.
"""
import numpy as np
import pytest
import torch

from loner_tpu_torch.mapping import optimizer as topt
from loner_tpu_torch.mapping import rays as trays
from loner_tpu_torch.mapping.loss import LossConfig, compute_lidar_loss
from loner_tpu_torch.models import field as tfield
from loner_tpu_torch.models.proposal import ProposalConfig, init_proposal_params, proposal_logits
from loner_tpu_torch.models import occupancy_grid as tog
from loner_tpu_torch.models.rendering import (
    SCAN_ROWS, ProposalRaySampler, _PositiveCumprod, pack_rays, raw2outputs,
)
from loner_tpu_torch.ops import hash_grid
from loner_tpu_torch.parallel import mesh as tmesh
from test_torch_multidevice import in_processes

torch.set_num_threads(1)

CPU = torch.device("cpu")
RUN = 32  # rays: the batches' multiple (module docstring)
B = 7 * RUN
N_CTRL, S = 33, 64  # the flagship's proposal control points; samples a ray (cut)
W, N_LIDAR = 8, 32  # the mesh window: 256 rays, 64 a rank on [4] and on [2, 2]
N_SKY = 16  # sky rays a slot of the sky window: 384 rays, 96 a rank on [4] and on [2, 2]


def _batches(n: int, parts: int) -> list:
    """Row slices of ``n`` rows in ``parts`` batches of whole RUNs, the last shorter."""
    k = -(-n // parts // RUN) * RUN
    return [slice(i, min(i + k, n)) for i in range(0, n, k)]


def _rays(n: int, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.normal(0.0, 0.05, (n, 3))
    depth = rng.uniform(0.15, 0.75, n)
    rays = pack_rays(torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
                     torch.full((n,), 0.05), torch.full((n,), 0.85))
    draws = {"jitter": torch.tensor(rng.uniform(size=(n, S)), dtype=torch.float32),
             "noise": torch.tensor(rng.normal(size=(n, S)), dtype=torch.float32)}
    return rays, torch.tensor(depth, dtype=torch.float32), draws


def _proposal():
    return init_proposal_params(torch.Generator().manual_seed(5), ProposalConfig(), CPU)


def _field_cfg(dtype: torch.dtype) -> tfield.FieldConfig:
    return tfield.FieldConfig(
        encoding_sigma="fourier", fourier_sigma=tfield.FourierConfig(n_freqs=16, scale=6.0),
        sigma_mlp=tfield.MLPConfig(64, 2, 1), density_activation="softplus",
        sigma_mlp_bias=True, compute_dtype=dtype,
        pos_encoding_intensity=tfield.HashEncodingConfig(n_levels=2, log2_hashmap_size=10))


def _equal_in_batches(fn, n: int, *inputs) -> None:
    whole = fn(*inputs)
    for parts in (2, 4):
        batches = _batches(n, parts)
        assert len(batches) == parts and batches[-1].stop - batches[-1].start < batches[0].stop
        pieces = [fn(*(t[s] for t in inputs)) for s in batches]
        for name in whole:
            np.testing.assert_array_equal(torch.cat([p[name] for p in pieces]).numpy(),
                                          whole[name].numpy(), err_msg=f"{name}, {parts} batches")


def test_sampler_depths_do_not_depend_on_the_batch():
    prop = _proposal()
    rays, _, draws = _rays(B)
    sampler = ProposalRaySampler(n_ctrl=N_CTRL)
    with torch.no_grad():
        _equal_in_batches(lambda r, j: {"z": sampler.get_samples(r, S, 1.0, prop, j)}, B,
                          rays, draws["jitter"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_lidar_loss_forward_per_ray_does_not_depend_on_the_batch(dtype):
    fcfg = _field_cfg(dtype)
    params = tfield.init_field_params(torch.Generator().manual_seed(6), fcfg, CPU)
    prop = _proposal()
    rays, depths, draws = _rays(B, seed=1)
    valid = torch.ones(B, dtype=torch.bool)

    def forward(r, dep, v, j, nz):
        _, aux = compute_lidar_loss(r, dep, v, params, fcfg, ProposalRaySampler(n_ctrl=N_CTRL),
                                    prop, LossConfig(), 12.0, S, 1.0, 1.0, 0.0, 0.0, jitter=j,
                                    noise=nz)
        return {k: aux[k] for k in ("js_score", "z_m", "w_pred", "std")}

    with torch.no_grad():
        _equal_in_batches(forward, B, rays, depths, valid, draws["jitter"], draws["noise"])


def test_proposal_logits_do_not_depend_on_the_row_count():
    """The proposal MLP alone (no sigmoid): every count of points from 2 to 70,
    whole rays or not, against one batch of 70. (A single point takes BLAS's
    matrix-vector path in every product; a call holds a ray's control points at
    least.)"""
    prop = _proposal()
    pts = torch.rand(70, 3, generator=torch.Generator().manual_seed(7)) * 2.0 - 1.0
    with torch.no_grad():
        whole = proposal_logits(prop, pts)
        for n in range(2, 71):
            np.testing.assert_array_equal(proposal_logits(prop, pts[:n]).numpy(),
                                          whole[:n].numpy(), err_msg=f"{n} points")


# -- four gloo ranks ---------------------------------------------------------------
def _window_case(n_sky: int = 0) -> dict:
    """W scans of 256 rays and, with ``n_sky``, 40 upward sky directions a slot."""
    rng = np.random.default_rng(2)
    dirs, deps, sky = [], [], []
    for _ in range(W):
        d = rng.normal(size=(3, 256))
        dirs.append((d / np.linalg.norm(d, axis=0)).astype(np.float32))
        deps.append(rng.uniform(1.0, 10.0, 256).astype(np.float32))
        u = rng.normal(size=(3, 40))
        u[2] = np.abs(u[2]) + 0.5
        sky.append((u / np.linalg.norm(u, axis=0)).astype(np.float32) if n_sky else None)
    return {"dirs": dirs, "deps": deps, "sky": sky, "n_sky": n_sky,
            "twists": rng.normal(0.0, 0.02, (W, 6)).astype(np.float32)}


def _window_forward(case: dict, mesh=None) -> dict:
    """The first iteration's forward of the window (this rank's share under a
    mesh): per-ray JS scores, sample depths and weights of its LiDAR and sky
    rays."""
    cfg = topt.OptimizerConfig(
        n_lidar_samples=N_LIDAR, n_sky_samples=case["n_sky"], enable_sky=case["n_sky"] > 0,
        n_samples_per_ray=S, window_size=W, ray_range=(0.5, 12.0), samples_strategy="PROPOSAL",
        prop_n_ctrl=N_CTRL, prop_train_subsample=8, steps_per_dispatch=3)
    fcfg = _field_cfg(torch.bfloat16)
    params = tfield.init_field_params(torch.Generator().manual_seed(6), fcfg, CPU)
    prop = _proposal()
    buffers = trays.build_window_buffers(case["dirs"], case["deps"], case["sky"], W, device=CPU)
    draws = topt.draw_step(torch.Generator().manual_seed(3), cfg, W, CPU)
    shard = None
    if mesh is not None:
        buffers = tmesh.shard_window_buffers(buffers, mesh)
        shard = tmesh.WindowShard(mesh, W, N_LIDAR, case["n_sky"])
    with torch.no_grad():
        _, aux = topt.iteration_loss(cfg, fcfg, params["sigma"], prop,
                                     torch.from_numpy(case["twists"]), params["intensity"],
                                     buffers, torch.tensor(12.0), torch.zeros(3), draws,
                                     shard=shard)
    return {k: aux[k].numpy() for k in ("js_score", "z_m", "w_pred")}


def _rank(rank: int, spec, port: int, case: dict) -> dict:
    mesh = tmesh.join(spec, rank, port)
    try:
        return _window_forward(case, mesh)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("shape,n_sky", [((4,), 0), ((2, 2), 0), ((4,), N_SKY), ((2, 2), N_SKY)],
                         ids=["mesh4", "mesh2x2", "mesh4_sky", "mesh2x2_sky"])
def test_four_ranks_compute_one_devices_forward(shape, n_sky):
    case = _window_case(n_sky)
    spec = tmesh.make_mesh(4, CPU) if len(shape) == 1 else tmesh.make_mesh_2d(2, 2, CPU)
    ranks = in_processes(4, _rank, (spec, tmesh.free_port(), case))
    one = _window_forward(case)
    assert one["js_score"].shape == (W * (N_LIDAR + n_sky),)
    for name in one:
        np.testing.assert_array_equal(np.concatenate([r[name] for r in ranks]), one[name],
                                      err_msg=name)
    if n_sky:  # the sky rays (each slot's last N_SKY) were rendered, not masked out
        sky = one["z_m"].reshape(W, N_LIDAR + n_sky, -1)[:, N_LIDAR:]
        assert np.isfinite(sky).all() and np.ptp(sky) > 0


def test_window_shares_are_whole_runs():
    """The mesh test's shares keep the module docstring's multiple."""
    for n_sky in (0, N_SKY):
        for n_kf, n_ray in ((4, 1), (2, 2)):
            assert (W // n_kf) * (N_LIDAR + n_sky) // n_ray % RUN == 0


# -- the backward ---------------------------------------------------------------------
def _hash_field():
    fcfg = tfield.FieldConfig(
        pos_encoding_sigma=tfield.HashEncodingConfig(n_levels=6, log2_hashmap_size=14,
                                                     per_level_scale=1.5),
        sigma_mlp=tfield.MLPConfig(64, 1, 1), compute_dtype=torch.float32)
    return fcfg, tfield.init_field_params(torch.Generator().manual_seed(7), fcfg, CPU)


def _grads(fn, inputs: list, wrt: list, upstream: list) -> dict:
    """The gradients of sum(out_i * upstream_i) at the inputs named in ``wrt``."""
    leaves = [t.clone().requires_grad_(i in wrt) for i, t in enumerate(inputs)]
    outs = fn(*leaves)
    total = sum((o * u).sum() for o, u in zip(outs, upstream))
    got = torch.autograd.grad(total, [leaves[i] for i in wrt])
    return {f"d{i}": g for i, g in zip(wrt, got)}


@pytest.mark.parametrize("op", ["compositing", "transmittance", "hash_field",
                                pytest.param("hash_field_kernels", marks=pytest.mark.cuda)])
def test_backward_per_ray_does_not_depend_on_the_batch(op):
    rng = np.random.default_rng(14)
    if op == "transmittance":
        n = 2 * SCAN_ROWS + 3 * RUN
        x = torch.tensor(rng.uniform(0.05, 1.0, (n, S + 1)), dtype=torch.float32)
        up = torch.tensor(rng.normal(size=(n, S + 1)), dtype=torch.float32)
        fn = lambda xx, uu: _grads(lambda a: (_PositiveCumprod.apply(a),), [xx], [0], [uu])  # noqa
        _equal_in_batches(fn, n, x, up)
        return
    if op == "compositing":
        raw = torch.tensor(rng.normal(size=(B, S, 1)), dtype=torch.float32)
        z = torch.tensor(np.sort(rng.uniform(0.05, 0.85, (B, S)), axis=1), dtype=torch.float32)
        d = torch.tensor(rng.normal(size=(B, 3)), dtype=torch.float32)
        noise = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32)
        far = torch.full((B, 1), 0.9)
        ud = torch.tensor(rng.normal(size=B), dtype=torch.float32)
        uw = torch.tensor(rng.normal(size=(B, S)), dtype=torch.float32)

        def fn(r, zz, dd, nz, ff, u1, u2):
            return _grads(lambda a: (lambda o: (o["depth"], o["weights"]))(raw2outputs(
                a, zz, dd, noise=nz, raw_noise_std=1.0, softplus=True, far=ff)), [r], [0],
                [u1, u2])

        _equal_in_batches(fn, B, raw, z, d, noise, far, ud, uw)
        return
    fcfg, params = _hash_field()
    dev = CPU
    if op == "hash_field_kernels":  # the hash kernels and the sigma-MLP pair on the card
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the hash field's kernels run only there")
        dev = torch.device("cuda")
        params = {"sigma": {"table": params["sigma"]["table"].to(dev),
                            "mlp": {k: w.to(dev) for k, w in params["sigma"]["mlp"].items()}}}
        assert tfield.sigma_mlp_engages(params["sigma"]["mlp"], fcfg, dev)
    n = 5 * B  # points: whole RUNs, ragged in 2 and 4 batches
    pos = torch.tensor(rng.uniform(-1.0, 1.0, (n, 3)), dtype=torch.float32, device=dev)
    up = torch.tensor(rng.normal(size=(n, 1)), dtype=torch.float32, device=dev)
    cfg = fcfg.pos_encoding_sigma

    def fn(pp, uu):
        feats = hash_grid.hash_encode(params["sigma"]["table"], (pp + 1.0) * 0.5, cfg)
        d_features = _grads(lambda f: (tfield.hash_sigma_mlp(params["sigma"]["mlp"], f, fcfg),),
                            [feats.detach()], [0], [uu])["d0"]
        dpos = _grads(lambda x: (tfield.query_sigma(params, x, fcfg),), [pp], [0], [uu])["d0"]
        return {"d_features": d_features.cpu(), "dpos": dpos.cpu()}

    _equal_in_batches(fn, n, pos, up)


# -- two gloo ranks: the fixed-point sums ----------------------------------------------
def _fixed_case() -> dict:
    rng = np.random.default_rng(15)
    fcfg, params = _hash_field()
    n = 4000
    return {"table": params["sigma"]["table"], "cfg": fcfg.pos_encoding_sigma,
            "pos": torch.tensor(rng.uniform(0.0, 1.0, (n, 3)), dtype=torch.float32),
            "g": torch.tensor(rng.normal(size=(n, fcfg.pos_encoding_sigma.output_dim)),
                              dtype=torch.float32),
            "grid": torch.tensor(rng.normal(size=(10, 10, 10)), dtype=torch.float32),
            "pts": torch.tensor(rng.uniform(-1.1, 1.1, (n, 3)), dtype=torch.float32),
            "lg": torch.tensor(rng.normal(size=n) * 1e-2, dtype=torch.float32)}


def _fixed_sums(case: dict, rows) -> tuple:
    table = hash_grid.table_sum(case["table"])
    hash_grid.hash_encode_bwd_plain(case["table"], case["pos"][rows], case["g"][rows],
                                    case["cfg"], torch.bfloat16, need_dpos=False, sink=table)
    grid = tog.grid_sum(case["grid"])
    tog.scatter_occ_grad(case["grid"], case["pts"][rows], case["lg"][rows], grid)
    return table, grid


def _fixed_rank(rank: int, spec, port: int, case: dict) -> dict:
    mesh = tmesh.join(spec, rank, port)
    try:
        rows = torch.arange(case["pos"].shape[0]).chunk(spec.size)[rank]
        table, grid = _fixed_sums(case, rows)
        flat = torch.cat([table.acc.reshape(-1), grid.acc.reshape(-1)])
        mesh.all_reduce_(flat)
        return {"flat": flat.numpy(), "table": table.to_float().numpy()}
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("buffer", ["table", "grid"])
def test_two_ranks_int64_all_reduce_gives_one_ranks_gradient(buffer):
    case = _fixed_case()
    ranks = in_processes(2, _fixed_rank, (tmesh.make_mesh(2, CPU), tmesh.free_port(), case))
    table, grid = _fixed_sums(case, torch.arange(case["pos"].shape[0]))
    one = {"table": table.acc.reshape(-1).numpy(), "grid": grid.acc.reshape(-1).numpy()}
    n_table = one["table"].size
    for r in ranks:
        got = r["flat"][:n_table] if buffer == "table" else r["flat"][n_table:]
        np.testing.assert_array_equal(got, one[buffer])
    assert np.abs(one[buffer]).max() > 0
    # Each rank's own share alone is not the whole: the sum is what made it equal.
    assert not np.array_equal(ranks[0]["table"].reshape(-1), table.to_float().numpy().reshape(-1))
