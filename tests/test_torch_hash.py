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
- the fixed-point table and grid gradients (``ops/fixed_point.py``): equal to
  the bit to themselves under a seeded permutation of the points and under
  splits into 2 and 4 parts whose int64 sums are added; against JAX's sorted
  segment sum (hash) and its vjp's scatter (grid) per entry within ``n_k
  2^-(S+1)`` (each of the entry's n_k terms rounded to the scale) plus JAX's own
  f32 summation, ``n_k 2^-24`` times the sum of the terms' magnitudes, plus the
  conversion's half ulp;
- two single-threaded SLAM runs of box_room_tiny.yaml (the reference's model,
  hash sigma field and OGM sampler, cut to 12 scans): trajectories and every
  checkpoint tensor equal to the bit;
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
from loner_tpu_torch.ops import fixed_point, hash_grid

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

    def recording_bwd(*args, need_dpos=True, **kwargs):
        asked.append(need_dpos)
        return plain_bwd(*args, need_dpos=need_dpos, **kwargs)

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


# -- fixed-point gradients ----------------------------------------------------------
ORDERS = ["permuted", "2_parts", "4_parts"]


def _in_orders(add, n: int, order: str, seed: int = 8) -> torch.Tensor:
    """The int64 sums of ``add(rows, sink)`` over ``n`` points: permuted, or in
    contiguous parts each into a sum of its own, the parts' sums added."""
    if order == "permuted":
        return add(torch.randperm(n, generator=torch.Generator().manual_seed(seed)))
    parts = [add(rows) for rows in torch.arange(n).chunk(int(order[0]))]
    return sum(parts[1:], parts[0])


def _table_sum(table, pos, g, ct, dtype, rows=None) -> torch.Tensor:
    rows = torch.arange(pos.shape[0]) if rows is None else rows
    sink = hash_grid.table_sum(table)
    hash_grid.hash_encode_bwd_plain(table, pos[rows], g[rows], ct, dtype, need_dpos=False,
                                    sink=sink)
    return sink.acc


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_fixed_point_table_gradient_has_one_value_in_any_order(name, dtype, order):
    ct = th.HashEncodingConfig(**CONFIGS[name])
    pos, table, g = (torch.tensor(x) for x in _inputs(jh.HashEncodingConfig(**CONFIGS[name]), 9))
    dt = getattr(torch, dtype)
    whole = _table_sum(table, pos, g, ct, dt)
    assert whole.abs().max() > 0
    got = _in_orders(lambda rows: _table_sum(table, pos, g, ct, dt, rows), N_POINTS, order)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    # The autograd path converts the same sums.
    tt = table.clone().requires_grad_(True)
    (th.hash_encode(tt, pos, ct, dt) * g).sum().backward()
    torch.testing.assert_close(tt.grad, fixed_point.from_fixed(whole, fixed_point.HASH_BITS),
                               rtol=0, atol=0)


def _fixed_point_tolerance(terms: np.ndarray, index: np.ndarray, size: int, got: np.ndarray,
                           bits: int) -> np.ndarray:
    """Per entry: n_k 2^-(bits + 1) + n_k 2^-24 sum|term| + 2^-24 |got|."""
    n_k = np.bincount(index, minlength=size).astype(np.float64)
    mag = np.bincount(index, weights=np.abs(terms.astype(np.float64)), minlength=size)
    return n_k * 2.0 ** -(bits + 1) + n_k * 2.0 ** -24 * mag + 2.0 ** -24 * np.abs(got)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_fixed_point_table_gradient_matches_jax_segment_sum(name, dtype):
    """Against ``hash_encode_vjp``'s sorted ``segment_sum``, with larger and
    smaller gradients than the parity tests' (terms from 1e-9 to 1e2 of a unit)."""
    cj, ct = jh.HashEncodingConfig(**CONFIGS[name]), th.HashEncodingConfig(**CONFIGS[name])
    pos, table, g = _inputs(cj, seed=10)
    g = (g * np.exp(np.random.default_rng(11).uniform(-20.0, 4.0, g.shape))).astype(np.float32)
    jdt = getattr(jnp, dtype)
    dtable_j = np.asarray(jax.grad(lambda t: (jh.hash_encode_vjp(t, jnp.asarray(pos), cj, jdt, jdt)
                                              * g).sum())(jnp.asarray(table)))
    tt = torch.tensor(table, requires_grad=True)
    (th.hash_encode(tt, torch.tensor(pos), ct, getattr(torch, dtype)) * torch.tensor(g)).sum(
    ).backward()
    got = tt.grad.numpy()
    idx, w = hash_grid.corner_indices(torch.tensor(pos), ct)
    terms = (w[..., None] * torch.tensor(g).reshape(N_POINTS, ct.n_levels, 1, 2)).numpy()
    tol = _fixed_point_tolerance(terms.reshape(-1), np.repeat(idx.numpy().reshape(-1) * 2, 2)
                                 + np.tile([0, 1], idx.numel()), table.size, got.reshape(-1),
                                 fixed_point.HASH_BITS)
    err = np.abs(got.reshape(-1).astype(np.float64) - dtable_j.reshape(-1))
    assert (err <= tol).all(), float((err / tol).max())
    assert np.abs(dtable_j).max() > 1e3 * 2.0 ** -fixed_point.HASH_BITS


def _grid_inputs(seed: int = 12):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(8, 8, 8)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)  # some outside the cube
    g = (rng.normal(size=3000) * np.exp(rng.uniform(-20.0, 2.0, 3000))).astype(np.float32)
    return torch.tensor(grid), torch.tensor(pts), torch.tensor(g)


@pytest.mark.parametrize("order", ORDERS)
def test_fixed_point_grid_gradient_has_one_value_in_any_order(order):
    grid, pts, g = _grid_inputs()

    def add(rows=None):
        rows = torch.arange(pts.shape[0]) if rows is None else rows
        sink = tog.grid_sum(grid)
        tog.scatter_occ_grad(grid, pts[rows], g[rows], sink)
        return sink.acc

    whole = add()
    assert whole.abs().max() > 0
    torch.testing.assert_close(_in_orders(add, pts.shape[0], order), whole, rtol=0, atol=0)
    torch.testing.assert_close(tog.occ_grid_grad(grid, pts, g),
                               fixed_point.from_fixed(whole, fixed_point.OGM_BITS),
                               rtol=0, atol=0)


def test_fixed_point_grid_gradient_matches_jax_vjp():
    grid, pts, g = _grid_inputs(13)
    _, vjp = jax.vjp(lambda x: jog.interpolate_occ_logits(x, jnp.asarray(pts.numpy())),
                     jnp.asarray(grid.numpy()))
    (want,) = vjp(jnp.asarray(g.numpy()))
    want = np.asarray(want).reshape(-1)
    got = tog.occ_grid_grad(grid, pts, g).numpy().reshape(-1)
    # The terms: each point's 8 weighted corners inside the grid (recomputed in f64).
    v = grid.shape[0]
    coords = (pts.double().numpy() + 1.0) * 0.5 * v - 0.5
    c0 = np.floor(coords).astype(np.int64)
    frac = coords - c0
    idx, terms = [], []
    for corner in np.ndindex(2, 2, 2):
        cell = c0 + np.array(corner[::-1])  # (iz, iy, ix) -> x, y, z offsets
        w = np.prod(np.where(np.array(corner[::-1]) == 1, frac, 1.0 - frac), axis=1)
        inside = ((cell >= 0) & (cell < v)).all(axis=1)
        idx.append(((cell[:, 2] * v + cell[:, 1]) * v + cell[:, 0])[inside])
        terms.append((g.double().numpy() * w)[inside])
    tol = _fixed_point_tolerance(np.concatenate(terms), np.concatenate(idx), v ** 3, got,
                                 fixed_point.OGM_BITS)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= tol + 4 * 2.0 ** -24 * np.abs(want)).all(), float((err / tol).max())
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("kind", ["hash table", "OGM grid"])
def test_a_contribution_past_the_limit_raises(kind):
    if kind == "hash table":
        ct = th.HashEncodingConfig(**CONFIGS["box_room_tiny"])
        pos, table, g = (torch.tensor(x) for x in
                         _inputs(jh.HashEncodingConfig(**CONFIGS["box_room_tiny"])))
        bits = fixed_point.HASH_BITS
        fine = (g / g.abs().sum() * fixed_point.limit(bits) * 0.5,)
        past = (g * 0 + fixed_point.limit(bits),)

        def run(gg):
            return hash_grid.hash_encode_bwd_plain(table, pos, gg, ct, torch.float32)[0]
    else:
        grid, pts, g = _grid_inputs()
        bits = fixed_point.OGM_BITS
        fine = (g / g.abs().sum() * fixed_point.limit(bits) * 0.5,)
        past = (g * 0 + fixed_point.limit(bits),)

        def run(gg):
            return tog.occ_grid_grad(grid, pts, gg)
    assert torch.isfinite(run(*fine)).all()
    with pytest.raises(OverflowError, match="passed its limit"):
        run(*past)
    with pytest.raises(OverflowError, match="passed its limit"):
        run(torch.full_like(past[0], float("nan")))
    fixed_point.check(torch.device("cpu"))  # the CPU raised at once: nothing left flagged


# -- two runs ------------------------------------------------------------------------
REPEAT_SCANS = 12


@pytest.fixture(scope="module")
def repeated_runs(tmp_path_factory):
    """box_room_tiny.yaml single-threaded twice on one 12-scan dataset, cut as
    tests/test_torch_slam.py cuts it."""
    from loner_tpu_torch.datasets.scan_stream import ScanStreamWriter
    from loner_tpu_torch.datasets.synthetic import VirtualLidar, generate_sequence
    from loner_tpu_torch.run_loner import run_trial
    from test_torch_slam import tiny_hash_settings

    root = str(tmp_path_factory.mktemp("repeat_ds"))
    scans, poses, ts, _, _ = generate_sequence(
        num_scans=REPEAT_SCANS, lidar=VirtualLidar(num_channels=16, num_columns=64, max_range=30.0),
        rate_hz=5.0)
    writer = ScanStreamWriter(root)
    for scan in scans:
        writer.add_scan(scan)
    writer.write_gt(poses, ts)
    runs = []
    for i in range(2):
        settings = tiny_hash_settings(str(tmp_path_factory.mktemp(f"repeat_{i}")))
        settings = settings.augment({"system": {"single_threaded": True}})
        runs.append(run_trial(settings, root, experiment_name=f"repeat_{i}", device="cpu"))
    return runs


def _tensors(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, prefix + (str(i),))
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield "/".join(prefix), np.asarray(tree)


@pytest.mark.parametrize("artifact", ["estimated_trajectory", "tracking_only", "final.tar"])
def test_two_single_threaded_runs_of_the_reference_model_repeat(repeated_runs, artifact):
    from loner_tpu_torch.mapping.mapper import load_checkpoint

    a, b = repeated_runs
    if artifact == "final.tar":
        ta = dict(_tensors(load_checkpoint(f"{a}/checkpoints/final.tar")))
        tb = dict(_tensors(load_checkpoint(f"{b}/checkpoints/final.tar")))
        assert ta.keys() == tb.keys() and any("table" in k for k in ta)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    else:
        ra = np.loadtxt(f"{a}/trajectory/{artifact}.txt")
        rb = np.loadtxt(f"{b}/trajectory/{artifact}.txt")
        assert ra.shape[0] >= 2
        np.testing.assert_array_equal(ra, rb)
