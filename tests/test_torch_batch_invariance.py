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
- Four gloo ranks, ``[4]`` and ``[2, 2]``, each computing its share of a W=8
  window's first iteration (``iteration_loss`` with its ``WindowShard``): the
  ranks' per-ray JS scores, sample depths and weights, in rank order, equal to
  the bit one device's for the whole window. (The ranks' phase against one
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
from loner_tpu_torch.models.rendering import ProposalRaySampler, pack_rays
from loner_tpu_torch.parallel import mesh as tmesh
from test_torch_multidevice import in_processes

torch.set_num_threads(1)

CPU = torch.device("cpu")
RUN = 32  # rays: the batches' multiple (module docstring)
B = 7 * RUN
N_CTRL, S = 33, 64  # the flagship's proposal control points; samples a ray (cut)
W, N_LIDAR = 8, 32  # the mesh window: 256 rays, 64 a rank on [4] and on [2, 2]


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
def _window_case() -> dict:
    rng = np.random.default_rng(2)
    dirs, deps = [], []
    for _ in range(W):
        d = rng.normal(size=(3, 256))
        dirs.append((d / np.linalg.norm(d, axis=0)).astype(np.float32))
        deps.append(rng.uniform(1.0, 10.0, 256).astype(np.float32))
    return {"dirs": dirs, "deps": deps, "twists": rng.normal(0.0, 0.02, (W, 6)).astype(np.float32)}


def _window_forward(case: dict, mesh=None) -> dict:
    """The first iteration's forward of the window (this rank's share under a
    mesh): per-ray JS scores, sample depths and weights."""
    cfg = topt.OptimizerConfig(
        n_lidar_samples=N_LIDAR, n_sky_samples=0, n_samples_per_ray=S, window_size=W,
        ray_range=(0.5, 12.0), samples_strategy="PROPOSAL", prop_n_ctrl=N_CTRL,
        prop_train_subsample=8, steps_per_dispatch=3)
    fcfg = _field_cfg(torch.bfloat16)
    params = tfield.init_field_params(torch.Generator().manual_seed(6), fcfg, CPU)
    prop = _proposal()
    buffers = trays.build_window_buffers(case["dirs"], case["deps"], [None] * W, W, device=CPU)
    draws = topt.draw_step(torch.Generator().manual_seed(3), cfg, W, CPU)
    shard = None
    if mesh is not None:
        buffers = tmesh.shard_window_buffers(buffers, mesh)
        shard = tmesh.WindowShard(mesh, W, N_LIDAR, 0)
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


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["mesh4", "mesh2x2"])
def test_four_ranks_compute_one_devices_forward(shape):
    case = _window_case()
    spec = tmesh.make_mesh(4, CPU) if len(shape) == 1 else tmesh.make_mesh_2d(2, 2, CPU)
    ranks = in_processes(4, _rank, (spec, tmesh.free_port(), case))
    one = _window_forward(case)
    assert one["js_score"].shape == (W * N_LIDAR,)
    for name in one:
        np.testing.assert_array_equal(np.concatenate([r[name] for r in ranks]), one[name],
                                      err_msg=name)


def test_window_shares_are_whole_runs():
    """The mesh test's shares keep the module docstring's multiple."""
    for n_kf, n_ray in ((4, 1), (2, 2)):
        assert (W // n_kf) * N_LIDAR // n_ray % RUN == 0
