"""The port's hash-grid encoding, occupancy grid and OGM sampler against the
JAX package's, on the CPU (where the port runs the kernels' plain version).

Sizes: cfg/synthetic/box_room_tiny.yaml's sigma grid (6 levels, 2^14 entries,
scale 1.5) and the reference's 16 levels x 2 features at 2^18 (3,710,866
entries), on a few thousand points with some at 0, at 1 and outside [0, 1].
Tolerances, each with its reason:
- corner indices and trilinear weights: equal (integer hash in int64 keeps the
  low bits of the uint32 one; the weights are the same f32 products);
- the f32 encode and the bf16 training encode: within 1e-6 relative (measured
  equal: the same f32 products, summed over the corners in order);
- the table gradient: 1e-5 relative (``index_add_`` against JAX's sorted
  segment sum: the same f32 terms, summed in another order);
- the position gradient: 1e-5 of its largest entry (the closed form in a fixed
  order against JAX's reductions; up to ~3e6 at the finest level's 524,288
  cells per unit);
- occupancy interpolation and update: 1e-5 (``grid_sample`` unnormalises the
  coordinates in another op order);
- OGM samples: 1e-5 of the ray's depth range, on a grid whose logits lie in
  [0.5, 4] along the rays. The sampler's pdf is the clipped probability plus a
  1e-5 floor: where a ray's probabilities sit near that floor, the f32 rounding
  of the interpolation (~1e-6 on logits of a few units) moves the inverse CDF by
  up to 1e-3 of the range, in either package alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loner_tpu.models import hash_encoding as jh
from loner_tpu.models import occupancy_grid as jog
from loner_tpu.models import rendering as jrend
from loner_tpu_torch.models import hash_encoding as th
from loner_tpu_torch.models import occupancy_grid as tog
from loner_tpu_torch.models import rendering as trend
from loner_tpu_torch.ops import hash_grid

torch.set_num_threads(1)

CONFIGS = {
    "box_room_tiny": dict(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5),
    "reference": dict(),  # 16 levels x 2 features at 2^18, base 16, scale 2
}
N_POINTS = 2000


def _inputs(cfg_j, seed: int = 0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05, 1.05, (N_POINTS, 3)).astype(np.float32)
    pos[:4] = 0.0
    pos[4:8] = 1.0
    pos[8, 0], pos[9, 1], pos[10, 2] = 0.0, 1.0, 1.0
    table = rng.uniform(-1.0, 1.0, (cfg_j.total_table_size, 2)).astype(np.float32)
    g = rng.normal(size=(N_POINTS, cfg_j.output_dim)).astype(np.float32)
    return pos, table, g


@pytest.mark.parametrize("name", CONFIGS)
def test_level_layout_and_corners_match_jax(name):
    cj, ct = jh.HashEncodingConfig(**CONFIGS[name]), th.HashEncodingConfig(**CONFIGS[name])
    np.testing.assert_array_equal(ct.level_resolutions(), cj.level_resolutions())
    np.testing.assert_array_equal(ct.level_table_sizes(), cj.level_table_sizes())
    np.testing.assert_array_equal(ct.level_offsets(), cj.level_offsets())
    assert ct.total_table_size == cj.total_table_size
    if name == "reference":
        assert ct.total_table_size == 17 ** 3 + 33 ** 3 + 14 * 2 ** 18 == 3710866
        assert ct.level_dense().tolist() == [True, True] + [False] * 14
    pos, _, _ = _inputs(cj)
    idx_j, w_j = jh.hash_corner_indices(jnp.asarray(pos), cj)
    idx_t, w_t = th.hash_corner_indices(torch.tensor(pos), ct)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    # At pos = 1 the cell is clamped to res - 1 and frac is exactly 1.
    _, frac = hash_grid.corner_geometry(torch.ones((1, 3)), ct)
    assert torch.all(frac == 1.0)


@pytest.mark.parametrize("name", CONFIGS)
def test_f32_encode_matches_jax_hash_encode(name):
    cj, ct = jh.HashEncodingConfig(**CONFIGS[name]), th.HashEncodingConfig(**CONFIGS[name])
    pos, table, _ = _inputs(cj, seed=1)
    out_j = np.asarray(jh.hash_encode(jnp.asarray(table), jnp.asarray(pos), cj))
    out_t = th.hash_encode(torch.tensor(table), torch.tensor(pos), ct)
    assert out_t.shape == (N_POINTS, ct.output_dim) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_training_encode_matches_hash_encode_vjp(name, dtype):
    cj, ct = jh.HashEncodingConfig(**CONFIGS[name]), th.HashEncodingConfig(**CONFIGS[name])
    pos, table, g = _inputs(cj, seed=2)
    jdt = getattr(jnp, dtype)

    def loss(t, p):
        return (jh.hash_encode_vjp(t, p, cj, jdt, jdt) * g).sum()

    out_j = np.asarray(jh.hash_encode_vjp(jnp.asarray(table), jnp.asarray(pos), cj, jdt, jdt))
    dtable_j, dpos_j = (np.asarray(x) for x in
                        jax.grad(loss, (0, 1))(jnp.asarray(table), jnp.asarray(pos)))

    tt = torch.tensor(table, requires_grad=True)
    pt = torch.tensor(pos, requires_grad=True)
    out_t = th.hash_encode(tt, pt, ct, getattr(torch, dtype))
    (out_t * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=1e-6, atol=1e-7)
    if dtype == "bfloat16":  # the features are bf16 values held in f32
        np.testing.assert_array_equal(out_t.detach().to(torch.bfloat16).float().numpy(),
                                      out_t.detach().numpy())
    np.testing.assert_allclose(tt.grad.numpy(), dtable_j, rtol=1e-5, atol=1e-6)
    scale = np.abs(dpos_j).max()
    np.testing.assert_allclose(pt.grad.numpy() / scale, dpos_j / scale, atol=1e-5)
    # Outside [0, 1] the clip stops the gradient; at an exact 0 or 1 it is halved.
    outside = (pos < 0) | (pos > 1)
    assert np.all(pt.grad.numpy()[outside] == 0) and np.all(dpos_j[outside] == 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_encode_of_points_without_gradient_skips_dpos(name, dtype, monkeypatch):
    """Frozen poses: the points need no gradient, so the backward skips its dpos
    half and gives the table the same gradient, JAX's hash_encode_vjp's."""
    cj, ct = jh.HashEncodingConfig(**CONFIGS[name]), th.HashEncodingConfig(**CONFIGS[name])
    pos, table, g = _inputs(cj, seed=5)
    jdt = getattr(jnp, dtype)
    dtable_j = np.asarray(jax.grad(lambda t: (jh.hash_encode_vjp(t, jnp.asarray(pos), cj, jdt, jdt)
                                              * g).sum())(jnp.asarray(table)))
    asked = []
    plain_bwd = hash_grid.hash_encode_bwd_plain

    def recording_bwd(*args, need_dpos=True):
        asked.append(need_dpos)
        return plain_bwd(*args, need_dpos=need_dpos)

    monkeypatch.setattr(hash_grid, "hash_encode_bwd_plain", recording_bwd)
    grads = {}
    for needs_pos_grad in (True, False):
        tt = torch.tensor(table, requires_grad=True)
        pt = torch.tensor(pos, requires_grad=needs_pos_grad)
        (th.hash_encode(tt, pt, ct, getattr(torch, dtype)) * torch.tensor(g)).sum().backward()
        assert (pt.grad is not None) == needs_pos_grad
        grads[needs_pos_grad] = tt.grad
    assert asked == [True, False]
    torch.testing.assert_close(grads[False], grads[True], rtol=0, atol=0)
    np.testing.assert_allclose(grads[False].numpy(), dtable_j, rtol=1e-5, atol=1e-6)
    dtable, dpos = plain_bwd(torch.tensor(table), torch.tensor(pos), torch.tensor(g), ct,
                             getattr(torch, dtype), need_dpos=False)
    assert dpos is None
    torch.testing.assert_close(dtable, grads[True], rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_guards_raise_before_any_launch():
    ct = th.HashEncodingConfig(**CONFIGS["box_room_tiny"])
    pos, table, _ = _inputs(jh.HashEncodingConfig(**CONFIGS["box_room_tiny"]))
    before = (hash_grid.counts.fwd_launches, hash_grid.counts.bwd_launches)
    out = th.hash_encode(torch.tensor(table), torch.tensor(pos), ct, torch.bfloat16)
    torch.testing.assert_close(out, hash_grid.hash_encode_fwd_plain(
        torch.tensor(table), torch.tensor(pos), ct, torch.bfloat16), rtol=0, atol=0)
    # The kernels index points x levels x 8 corners and the table in 32 bits; meta
    # tensors hold no data, and the guards raise before the library is asked for.
    meta = torch.device("meta")
    big = th.HashEncodingConfig()
    tab = torch.empty((big.total_table_size, 2), device=meta)
    n_max = (2 ** 31 - 1) // (16 * 8)
    hash_grid.check_sizes(n_max, big)
    for n in (n_max + 1, 16384 * 2048):
        with pytest.raises(ValueError, match="blocks of points"):
            hash_grid.hash_encode_fwd_cuda(tab, torch.empty((n, 3), device=meta), big,
                                           torch.float32)
        with pytest.raises(ValueError, match="blocks of points"):
            hash_grid.hash_encode_bwd_cuda(tab, torch.empty((n, 3), device=meta),
                                           torch.empty((n, 32), device=meta), big, torch.bfloat16)
    with pytest.raises(ValueError, match="2 features"):
        hash_grid.check_sizes(8, th.HashEncodingConfig(n_features_per_level=4))
    with pytest.raises(ValueError, match="levels"):
        hash_grid.check_sizes(8, th.HashEncodingConfig(n_levels=33, log2_hashmap_size=10))
    assert (hash_grid.counts.fwd_launches, hash_grid.counts.bwd_launches) == before


def test_occupancy_interpolation_and_update_match_jax():
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(8, 8, 8)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (5, 40, 3)).astype(np.float32)  # some outside the cube
    g = rng.normal(size=(5, 40)).astype(np.float32)
    out_j = np.asarray(jog.interpolate_occ_logits(jnp.asarray(grid), jnp.asarray(pts)))
    out_t = tog.interpolate_occ_logits(torch.tensor(grid), torch.tensor(pts))
    assert out_t.shape == (5, 40)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5)
    new_j = np.asarray(jog.occ_grid_update(jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(g),
                                           0.1))
    new_t = tog.occ_grid_update(torch.tensor(grid), torch.tensor(pts), torch.tensor(g), 0.1)
    np.testing.assert_allclose(new_t.numpy(), new_j, atol=1e-5)
    assert np.abs(new_j - grid).max() > 1e-2
    np.testing.assert_array_equal(tog.init_occ_grid(4, torch.device("cpu")).numpy(),
                                  np.asarray(jog.init_occ_grid(4)))


def _rays(n: int, seed: int):
    """Rays that stay inside the grid's outermost voxel centres (|x| < 0.9)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = np.full((n, 1), 0.05, np.float32)
    far = rng.uniform(0.5, 0.7, (n, 1)).astype(np.float32)
    return np.concatenate([o, d, -d, near, far], axis=1)


@pytest.mark.parametrize("draws", ["jax_key", "deterministic"])
def test_occ_grid_sampler_matches_jax(draws):
    rng = np.random.default_rng(4)
    grid = rng.uniform(0.5, 4.0, (16, 16, 16)).astype(np.float32)
    rays = _rays(24, 5)
    n_samples, perturb = 40, 1.0
    key = jax.random.key(6) if draws == "jax_key" else None
    z_j = np.asarray(jrend.OccGridRaySampler().get_samples(key, jnp.asarray(rays), n_samples,
                                                           perturb, jnp.asarray(grid)))
    jitter = pdf_u = None
    if key is not None:  # JAX's own draws: k_uniform, k_pdf = split(k_sample)
        k_uniform, k_pdf = jax.random.split(key)
        jitter = torch.tensor(np.asarray(jax.random.uniform(k_uniform, (24, n_samples // 2))))
        pdf_u = torch.tensor(np.asarray(jax.random.uniform(k_pdf, (24, n_samples // 2))))
    sampler = trend.make_sampler(torch.tensor(grid))
    assert isinstance(sampler, trend.OccGridRaySampler)
    z_t = sampler.get_samples(torch.tensor(rays), n_samples, perturb if key is not None else 0.0,
                              torch.tensor(grid), jitter, pdf_u)
    assert z_t.shape == (24, n_samples)
    assert torch.all(z_t[:, 1:] >= z_t[:, :-1])
    span = rays[:, 10:11] - rays[:, 9:10]
    np.testing.assert_allclose(z_t.numpy() / span, z_j / span, atol=1e-5)
    # The grid concentrates the importance half: its samples are not uniform.
    assert np.abs(np.diff(z_j, axis=1)).std() > 1e-3
