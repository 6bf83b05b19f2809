"""The port's CUDA kernels against their plain PyTorch version, on a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch and the CUDA toolkit:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Without a card the card tests skip; the packing, planning and guard tests run
anywhere. Tolerances, Fourier MLP (bf16, kernel and
plain version differ only in f32 summation order): forward max abs 5e-2 on
O(1)-O(10) sigma; gradients relative L2 1e-2, since a rare flipped ReLU mask
moves single points' gradients. Compositing (f32; the kernel's block scan
multiplies in another order than cumprod): the tolerances of
tests/test_pallas_ops.py, depth and opacity rtol/atol 2e-4, weights rtol 5e-3
atol 2e-4, variance rtol 1e-3 atol 2e-4. Hash-grid encode (the same rounded f32
operations in the same order as the plain version): features and dpos equal,
with dpos and without, at ray-ordered and random points and at the edge cases
of the kernels' warp-level work; the table gradient, summed by float atomics
(combined first over the lanes of a warp) in an order that changes per run over
up to ~10^4 terms an entry (cancelling sums, so no elementwise bound fits),
relative L2 1e-5, as chip_smoke.py holds it. The f32 Fourier-MLP kernels
(csrc/fourier_mlp_f32.cu, split-TF32 products) against the plain version in
f32: forward max abs 1e-4, gradients relative L2 1e-4, two backward calls equal
to the bit; the split products emulated on the CPU meet the same bounds, one
TF32 product does not.
"""
import numpy as np
import pytest
import torch

from loner_tpu_torch.analysis.ab_compare import hash_edge_points, hash_points
from loner_tpu_torch.models.hash_encoding import HashEncodingConfig
from loner_tpu_torch.ops import composite as tc
from loner_tpu_torch.ops import fourier_mlp as tfm
from loner_tpu_torch.ops import hash_grid as thg

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Fourier-MLP kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(f: int, h: int, n_hidden: int, n: int, device):
    rng = np.random.default_rng(4)
    dims = [2 * f + 3] + [h] * n_hidden + [1]
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        ws.append(torch.tensor((rng.uniform(-1, 1, (a, b)) * np.sqrt(6.0 / a)).astype(np.float32),
                               device=device))
        bs.append(torch.tensor((rng.normal(size=b) * 0.1).astype(np.float32), device=device))
    bmat = torch.tensor((rng.normal(size=(3, f)) * 6.0 * 2 * np.pi).astype(np.float32),
                        device=device)
    pts = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=device)
    dout = torch.tensor(rng.normal(size=(n, 1)).astype(np.float32), device=device)
    return ws, bs, bmat, pts, dout


# The sigma shapes of cfg/ as (F, H, hidden layers), at ragged point counts; the
# first three are the earlier cases.
KERNEL_CASES = [(8, 32, 2, 300), (16, 64, 1, 777), (48, 256, 2, 5000), (48, 256, 2, 3001),
                (96, 256, 2, 2000), (128, 256, 2, 2000), (48, 192, 2, 1500), (32, 128, 3, 1500),
                (64, 256, 4, 1000), (32, 64, 2, 999), (24, 64, 2, 700)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,n_hidden,n", KERNEL_CASES)
def test_fourier_mlp_kernels_match_plain(cuda_device, f, h, n_hidden, n):
    ws, bs, bmat, pts, dout = _operands(f, h, n_hidden, n, cuda_device)
    bf = torch.bfloat16
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    out_k = tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, bf)
    out_p = tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, bf)
    assert float((out_k - out_p).abs().max()) <= 5e-2
    dws_k, dbs_k, dpts_k = tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, bf)
    dws_p, dbs_p, dpts_p = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, bf)
    for a, b in zip(dws_k + dbs_k + [dpts_k], dws_p + dbs_p + [dpts_p]):
        b = b.reshape(a.shape)
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-2
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,n_hidden,n", [(48, 256, 2, 70000), (96, 256, 2, 5000), (8, 32, 2, 300)])
def test_backward_is_deterministic(cuda_device, f, h, n_hidden, n):
    # Split-K and per-CTA partials summed in a fixed order, no float atomics.
    ws, bs, bmat, pts, dout = _operands(f, h, n_hidden, n, cuda_device)
    first = tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, torch.bfloat16)
    again = tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, torch.bfloat16)
    for x, y in zip(first[0] + first[1] + [first[2]], again[0] + again[1] + [again[2]]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 63, 129])
def test_tiny_and_ragged_point_counts(cuda_device, n):
    ws, bs, bmat, pts, dout = _operands(48, 256, 2, n, cuda_device)
    bf = torch.bfloat16
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    out_k = tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, bf)
    dws_k, dbs_k, dpts_k = tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, bf)
    dws_p, dbs_p, dpts_p = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, bf)
    def amax(x):
        return float(x.abs().max()) if x.numel() else 0.0

    assert out_k.shape == (n, 1) and dpts_k.shape == (n, 3)
    assert amax(out_k - tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, bf)) <= 5e-2
    for a, b in zip(dws_k + dbs_k + [dpts_k], dws_p + dbs_p + [dpts_p]):
        b = b.reshape(a.shape)
        assert amax(a - b) <= 1e-2 * max(amax(b), 1e-3)
    launched = int(n > 0)
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == (before[0] + launched,
                                                                  before[1] + launched)


@pytest.mark.cuda
def test_wgmma_operand_forms(cuda_device):
    # The three shared-memory operand layouts the kernels read, on 64 x 64 matrices.
    g = torch.Generator().manual_seed(0)
    w, a, x, gg = (torch.randn(64, 64, generator=g).to(torch.bfloat16).to(cuda_device) for _ in range(4))
    out_f, out_b, out_w = tfm.wgmma_selftest(w, a, x, gg)
    torch.cuda.synchronize()
    for got, want in ((out_f, a.float() @ w.float()), (out_b, a.float() @ w.float().T),
                      (out_w, x.float().T @ gg.float())):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_autograd_through_the_kernels(cuda_device):
    ws, bs, bmat, pts, dout = _operands(8, 32, 2, 300, cuda_device)
    mlp = {**{f"w{i}": w.requires_grad_(True) for i, w in enumerate(ws)},
           **{f"b{i}": b.requires_grad_(True) for i, b in enumerate(bs)}}
    pts.requires_grad_(True)
    before = tfm.counts.bwd_launches
    tfm.fourier_sigma_fused(mlp, pts, bmat).backward(dout)
    assert tfm.counts.bwd_launches == before + 1
    with torch.no_grad():
        _, _, dpts_p = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, torch.bfloat16)
    assert float(torch.linalg.norm(pts.grad - dpts_p) / torch.linalg.norm(dpts_p)) <= 1e-2
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in mlp.values())


def _meta(tensors):
    return [t.to(torch.device("meta")) for t in tensors]


@pytest.mark.parametrize("case", ["width 48", "width 512", "width 16", "one layer", "nine layers",
                                  "float32", "no include_input"])
def test_shape_guards_raise_before_any_launch(case):
    # Meta tensors hold no data: a wrapper that got past its guards would fail on them.
    f, h, n_hidden = 8, 32, 2
    if case.startswith("width"):
        h = int(case.split()[1])
    if case == "one layer":
        n_hidden = 0
    if case == "nine layers":
        n_hidden = 8
    ws, bs, bmat, pts, dout = _operands(f, h, n_hidden, 64, torch.device("cpu"))
    ws, bs, (bmat, pts, dout) = _meta(ws), _meta(bs), _meta([bmat, pts, dout])
    if case == "no include_input":
        ws[0] = ws[0][:-3]
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, dtype)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, dout, dtype)
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == before


@pytest.mark.parametrize("f,h,n_layers", [(48, 256, 3), (8, 32, 3), (16, 64, 2), (96, 256, 3),
                                          (64, 256, 5), (33, 192, 4)])
def test_pack_weights_round_trips(f, h, n_layers):
    rng = np.random.default_rng(1)
    dims = [2 * f + 3] + [h] * (n_layers - 1) + [1]
    ws = [torch.tensor(rng.normal(size=(a, b)).astype(np.float32)) for a, b in zip(dims[:-1], dims[1:])]
    img = tfm.pack_weights(ws, f)
    k0 = 2 * tfm.padded_freqs(f) + 16
    assert img.dtype == torch.bfloat16 and img.numel() == (k0 + (n_layers - 2) * h) * h
    back = tfm.unpack_weights(img, f, h, n_layers)
    assert [tuple(w.shape) for w in back] == [tuple(w.shape) for w in ws[:-1]]
    for got, want in zip(back, ws[:-1]):
        assert torch.equal(got, want.to(torch.bfloat16))
    # Chunk 0 of W_1 (after W_0's rows, R = min(64, H) input rows): element (input i,
    # output o) at ((o // 8) * R / 8 + i // 8) * 64 + (o % 8) * 8 + i % 8.
    if n_layers > 2:
        w1, r = img[k0 * h:], min(64, h)
        for i, o in ((0, 0), (5, 3), (9, 17), (r - 1, h - 1)):
            at = ((o // 8) * (r // 8) + i // 8) * 64 + (o % 8) * 8 + i % 8
            assert w1[at] == ws[1][i, o].to(torch.bfloat16)


def test_layer0_rows_order():
    rows = tfm.layer0_rows(20).tolist()  # 20 frequencies, padded to 32
    assert len(rows) == 2 * 32 + 16
    assert rows[:16] == list(range(16)) and rows[16:32] == list(range(20, 36))
    assert rows[32:36] == [16, 17, 18, 19] and rows[36:48] == [-1] * 12
    assert rows[48:52] == [36, 37, 38, 39] and rows[52:64] == [-1] * 12
    assert rows[64:67] == [40, 41, 42] and rows[67:] == [-1] * 13


def test_core_layout_round_trips():
    mat = torch.arange(128 * 24, dtype=torch.float32).reshape(128, 24)
    flat = tfm.core_layout(mat)
    assert torch.equal(tfm.from_core_layout(flat, 128, 24), mat)
    for p, f in ((0, 0), (7, 7), (9, 3), (70, 23), (127, 8)):
        at = ((p // 64 * 3 + f // 8) * 8 + (p // 8) % 8) * 64 + (p % 8) * 8 + f % 8
        assert flat[at] == mat[p, f]


@pytest.mark.parametrize("n,f,h,n_layers,sms", [(2097152, 48, 256, 3, 132), (262144, 48, 256, 3, 132),
                                               (1, 8, 32, 3, 132), (5000, 64, 256, 5, 132),
                                               (777, 16, 64, 2, 8)])
def test_backward_plan_sizes_and_split_order(n, f, h, n_layers, sms):
    plan = tfm.BackwardPlan(n, f, h, n_layers, sms)
    k0 = 2 * tfm.padded_freqs(f) + 16
    assert plan.np % 128 == 0 and n <= plan.np < n + 128
    assert 1 <= plan.grid <= min(sms, plan.np // 128)
    assert plan.work_elems == (k0 + (n_layers - 2) * h + (n_layers - 1) * h) * plan.np
    want_tiles = [(0, m) for m in range(-(-k0 // 128))] + [
        (layer, m) for layer in range(1, n_layers - 1) for m in range(-(-h // 128))]
    assert plan.tiles == want_tiles
    assert plan.count_w == len(want_tiles) * 128 * h
    assert plan.count_b == n_layers * h + 1 and plan.stride_b % 64 == 0
    assert plan.stride_b >= plan.count_b
    # Splits: contiguous, in order, none empty, covering every 64-point block once.
    assert 1 <= plan.splits * len(plan.tiles) <= max(sms, len(plan.tiles))
    edges = [plan.split_blocks(s) for s in range(plan.splits)]
    assert edges[0][0] == 0 and edges[-1][1] == plan.np // 64
    assert all(a < b for a, b in edges) and all(edges[i][1] == edges[i + 1][0] for i in range(len(edges) - 1))
    if n == 2097152:  # the flagship: 3.69 GB of bf16 workspace, 44 splits x 3 tiles
        assert (plan.work_elems * 2, plan.splits, len(plan.tiles)) == (3690987520, 44, 3)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    ws, bs, bmat, pts, _ = _operands(8, 32, 2, 64, cuda_device)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, torch.float32)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_fwd_cuda([ws[0][:-3]] + ws[1:], bs, bmat, pts, torch.bfloat16)


# box_room_camera.yaml's head (32 frequencies, 3 x 128; a resident build) at its
# SLAM call size and at the design's edges: 1 point, a 32-point tile - 1 and + 1,
# 131 and 133 tiles (an H100's 132 SMs - 1 and + 1), one block over all 769 tiles
# and 7 blocks of ~110 tiles each; courtyard_tiny.yaml's head (32, 2 x 64; resident).
# The streamed kernels: the bf16 heads of cfg/ asked for in f32 (48 and 96 x 256 x 2,
# box_room_tpu.yaml's 64 x 256 x 4), box_room_camera's head at 16 frequencies, a
# 384-wide head (forward tiles of 32 points, backward of 16) and smaller heads
# (64-point tiles), at 1 point, a 32-point backward tile + 1, and 3 blocks over ~73
# tiles each.
F32_KERNEL_CASES = [(32, 128, 3, 24581, None), (8, 32, 2, 300, None), (5, 12, 1, 9, None),
                    (32, 64, 2, 5000, None), (32, 128, 3, 1, None), (32, 128, 3, 31, None),
                    (32, 128, 3, 33, None), (32, 128, 3, 32 * 131, None),
                    (32, 128, 3, 32 * 133 - 5, None), (32, 128, 3, 24581, 1),
                    (32, 128, 3, 24581, 7), (48, 256, 2, 7001, None), (96, 256, 2, 1000, None),
                    (64, 256, 4, 3001, None), (16, 128, 3, 2000, None), (48, 256, 2, 1, None),
                    (48, 256, 2, 33, None), (48, 256, 2, 7001, 3), (48, 384, 2, 500, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,n_hidden,n,grid", F32_KERNEL_CASES)
def test_f32_kernels_match_plain(cuda_device, f, h, n_hidden, n, grid):
    """The split-TF32 kernels against the plain version in f32; ``grid`` makes a
    block carry its dW and db accumulators over many tiles."""
    ws, bs, bmat, pts, dout = _operands(f, h, n_hidden, n, cuda_device)
    out = tfm.fourier_mlp_fwd_cuda_f32(ws, bs, bmat, pts)
    ref = tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, torch.float32)
    assert float((out - ref).abs().max()) <= 1e-4
    got = tfm.fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts, dout, grid=grid)
    want = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, torch.float32)
    for a, b in zip(got[0] + got[1] + [got[2]], want[0] + want[1] + [want[2]]):
        b = b.reshape(a.shape)
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-30)) <= 1e-4
    again = tfm.fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts, dout, grid=grid)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1] + [got[2]],
                                                 again[0] + again[1] + [again[2]]))


@pytest.mark.cuda
def test_f32_mma_fragment_layout(cuda_device):
    """One m16n8k8 split-TF32 product in each operand form of the f32 kernels
    (A W, A W^T, G^T H) against float64: a wrong fragment mapping or weight image
    is off by O(1); one TF32 product would be off by ~1e-3."""
    gen = torch.Generator().manual_seed(3)
    a, w, g, h = (torch.randn(shape, generator=gen) for shape in ((16, 8), (8, 8), (8, 16), (8, 8)))
    outs = tfm.mma_tf32_selftest(*(t.to(cuda_device) for t in (a, w, g, h)))
    torch.cuda.synchronize()
    a, w, g, h = (t.double() for t in (a, w, g, h))
    for got, want in zip(outs, (a @ w, a @ w.T, g.T @ h)):
        assert float((got.double().cpu() - want).abs().max()) <= 1e-5


# Which build takes a head (points a block takes per round, forward / backward):
# the resident one for the f32 heads of cfg/ (box_room_camera.yaml and
# box_room_tiny_tpu.yaml: 32 x 128 x 3, and 33 x 120 padded to it; courtyard_tiny:
# 32 x 64 x 2), the streamed one at the largest tile that fits for every other head
# of 2-8 layers (the bf16 heads of cfg/ asked for in f32, F 16 at 128 x 3, eight
# layers of 256, a 384-wide head, the tests' small heads).
@pytest.mark.cuda
@pytest.mark.parametrize("f,h,n_layers,tiles", [
    (32, 128, 4, (128, 32)), (33, 120, 4, (128, 32)), (32, 64, 3, (128, 32)),
    (48, 256, 3, (64, 32)), (96, 256, 3, (64, 32)), (64, 256, 5, (64, 32)),
    (16, 128, 4, (64, 64)), (128, 256, 8, (64, 16)), (48, 384, 3, (32, 16)),
    (8, 32, 3, (64, 64)), (5, 12, 2, (64, 64))])
def test_f32_kernels_choose_their_build(cuda_device, f, h, n_layers, tiles):
    assert tfm.f32_tiles(f, h, n_layers) == tiles
    for backward in (False, True):
        assert tfm.f32_occupancy(f, h, n_layers, backward, cuda_device) >= 1


# Nine layers; F = H = 2048; H = 512, whose streamed forward fits a block and whose
# backward does not: the library takes none of them, and says so before any launch.
@pytest.mark.cuda
@pytest.mark.parametrize("f,h,n_layers", [(8, 32, 9), (2048, 2048, 3), (96, 512, 3)])
def test_f32_guard_raises_for_heads_no_kernel_takes(cuda_device, f, h, n_layers):
    ws, bs, bmat, pts, dout = _operands(f, h, n_layers - 1, 64, cuda_device)
    before = (tfm.counts.fwd_f32_launches, tfm.counts.bwd_f32_launches)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_fwd_cuda_f32(ws, bs, bmat, pts)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts, dout)
    assert (tfm.counts.fwd_f32_launches, tfm.counts.bwd_f32_launches) == before


@pytest.mark.parametrize("case", ["one layer", "w0 rows", "float64 points", "bmat rows",
                                  "last layer width", "dout rows"])
def test_f32_guard_raises_before_any_launch(case):
    """The wrappers' own checks of the call, which need no build of the kernels
    (meta tensors here): a malformed call raises ValueError and counts nothing."""
    ws, bs, bmat, pts, dout = _operands(8, 32, 2, 64, torch.device("cpu"))
    if case == "one layer":
        ws, bs = [torch.zeros(19, 1)], [torch.zeros(1)]
    elif case == "w0 rows":
        ws[0] = ws[0][:-1]
    elif case == "float64 points":
        pts = pts.double()
    elif case == "bmat rows":
        bmat = bmat[:2]
    elif case == "last layer width":
        ws[-1] = torch.zeros(32, 2)
    else:
        dout = dout[:-1]
    ws, bs, (bmat, pts, dout) = _meta(ws), _meta(bs), _meta([bmat, pts, dout])
    before = (tfm.counts.fwd_f32_launches, tfm.counts.bwd_f32_launches)
    if case != "dout rows":
        with pytest.raises(ValueError):
            tfm.fourier_mlp_fwd_cuda_f32(ws, bs, bmat, pts)
    with pytest.raises(ValueError):
        tfm.fourier_mlp_bwd_cuda_f32(ws, bs, bmat, pts, dout)
    assert (tfm.counts.fwd_f32_launches, tfm.counts.bwd_f32_launches) == before


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero, by bit
    arithmetic: what cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the f32 kernels compute it: operands split into hi = tf32(x) and
    lo = tf32(x - hi), lo_a hi_b + hi_a lo_b + hi_a hi_b, each product exact (f64)
    and rounded to f32, the three summed in f32; one product (1xTF32) with
    ``products`` = 1."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    hh = (a_hi.double() @ b_hi.double()).float()
    if products == 1:
        return hh
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return ((a_lo.double() @ b_hi.double()).float() + (a_hi.double() @ b_lo.double()).float()) + hh


def _fwd_emulated(ws, bs, bmat, pts, products):
    h = tfm._features(pts, bmat, torch.float32)
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(_mm(h, w, products) + b)
    return h @ ws[-1] + bs[-1]


def _bwd_emulated(ws, bs, bmat, pts, dout, products):
    """fourier_mlp_bwd_plain in f32 with the backward kernel's tensor-core
    products (g W_i^T, h^T g) emulated; its recomputed forward is the plain
    version's f32 arithmetic (so are its ReLU masks), and W_{L-1}, db and dpts
    stay f32."""
    f = bmat.shape[1]
    x = tfm._features(pts, bmat, torch.float32)
    acts, h = [], x
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(h @ w + b)
        acts.append(h)
    n_layers = len(ws)
    dws, dbs = [None] * n_layers, [None] * n_layers
    dws[-1], dbs[-1] = acts[-1].T @ dout, dout.sum(dim=0)
    g = torch.where(acts[-1] > 0, dout @ ws[-1].T, 0.0)
    for i in range(n_layers - 2, 0, -1):
        dws[i], dbs[i] = _mm(acts[i - 1].T, g, products), g.sum(dim=0)
        g = torch.where(acts[i - 1] > 0, _mm(g, ws[i].T, products), 0.0)
    dws[0], dbs[0] = _mm(x.T, g, products), g.sum(dim=0)
    dx = _mm(g, ws[0].T, products)
    dproj = dx[:, :f] * x[:, f : 2 * f] - dx[:, f : 2 * f] * x[:, :f]
    return dws, dbs, dx[:, 2 * f :] + dproj @ bmat.T


def _f32_distances(f, h, n_hidden, n, products):
    ws, bs, bmat, pts, dout = _operands(f, h, n_hidden, n, torch.device("cpu"))
    fwd = float((_fwd_emulated(ws, bs, bmat, pts, products)
                 - tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, torch.float32)).abs().max())
    got = _bwd_emulated(ws, bs, bmat, pts, dout, products)
    want = tfm.fourier_mlp_bwd_plain(ws, bs, bmat, pts, dout, torch.float32)
    grad = max(_rel_l2(a, b.reshape(a.shape)) for a, b in zip(got[0] + got[1] + [got[2]],
                                                               want[0] + want[1] + [want[2]]))
    return fwd, grad


# The cases of test_f32_kernels_match_plain before the split-TF32 kernels, and two
# heads that only the streamed kernels take (box_room_tpu.yaml's 64 x 256 x 4,
# box_room_camera's head at 16 frequencies).
F32_EMULATION_CASES = [(32, 128, 3, 24581), (8, 32, 2, 300), (48, 256, 2, 7001),
                       (96, 256, 2, 1000), (5, 12, 1, 9), (64, 256, 4, 3001), (16, 128, 3, 2000)]


@pytest.mark.parametrize("f,h,n_hidden,n", F32_EMULATION_CASES)
def test_split_tf32_products_meet_the_f32_bounds(f, h, n_hidden, n):
    """Three TF32 products a product, as the kernels take them, stay within the f32
    kernels' bounds of the plain version: forward max abs 1e-4, gradients
    relative L2 1e-4."""
    fwd, grad = _f32_distances(f, h, n_hidden, n, products=3)
    assert fwd <= 1e-4 and grad <= 1e-4


@pytest.mark.parametrize("f,h,n_hidden,n", F32_EMULATION_CASES)
def test_one_tf32_product_misses_the_f32_bounds(f, h, n_hidden, n):
    """One TF32 product a product misses them: the split is what keeps them."""
    fwd, grad = _f32_distances(f, h, n_hidden, n, products=1)
    assert fwd > 1e-4 and grad > 1e-4


def test_cpu_tensors_take_the_plain_version():
    ws, bs, bmat, pts, dout = _operands(8, 32, 2, 64, torch.device("cpu"))
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    mlp = {**{f"w{i}": w for i, w in enumerate(ws)}, **{f"b{i}": b for i, b in enumerate(bs)}}
    out = tfm.fourier_sigma_fused(mlp, pts, bmat)
    torch.testing.assert_close(out, tfm.fourier_mlp_fwd_plain(ws, bs, bmat, pts, torch.bfloat16))
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == before


def test_guards_take_the_courtyard_width():
    """cfg/synthetic/courtyard_tpu_r5f.yaml's sigma head: 96 frequencies, a first
    layer of K = 2 * 96 + 3 = 195 rows, 256 x 2 hidden. The CUDA wrappers' checks
    and packing accept it on the CPU (no launch), the packed first layer holds
    every row of W_0, and the backward's plan has the chunks and tiles of it."""
    ws, bs, bmat, pts, _ = _operands(96, 256, 2, 5000, torch.device("cpu"))
    assert ws[0].shape == (195, 256)
    tfm.check_shape(96, 256, 3)
    _, bpad, wimg, wl, bias, f, h, n_layers = tfm._cuda_args(ws, bs, bmat, pts, torch.bfloat16)
    assert (f, h, n_layers, tuple(bpad.shape)) == (96, 256, 3, (3, 96))
    back = tfm.unpack_weights(wimg, f, h, n_layers)
    assert torch.equal(back[0], ws[0].to(torch.bfloat16)) and wl.shape == (256,)
    plan = tfm.BackwardPlan(2_097_152, 96, 256, 3, 132)
    assert plan.k0 == 208 and len(plan.tiles) == 4 and plan.np == 2_097_152
    assert plan.work_elems == (208 + 256 + 512) * 2_097_152


def test_point_count_guard_raises_before_any_launch():
    # The kernels offset points in 64 bits and count a CTA's 128-point tile pairs in
    # 32 bits; meta tensors hold no data.
    ws, bs, bmat, _, _ = _operands(8, 32, 2, 4, torch.device("cpu"))
    meta = torch.device("meta")
    ws, bs, bmat = [w.to(meta) for w in ws], [b.to(meta) for b in bs], bmat.to(meta)
    n_max = 128 * tfm.MAX_TILE_PAIRS
    tfm.check_point_count(n_max)
    tfm.check_point_count(16384 * 2048 * 32)  # past the earlier 32-bit offset limit
    before = (tfm.counts.fwd_launches, tfm.counts.bwd_launches)
    for n in (n_max + 1, 2 ** 40):
        pts = torch.empty((n, 3), dtype=torch.float32, device=meta)
        with pytest.raises(ValueError, match="32-bit tile-pair counts"):
            tfm.fourier_mlp_fwd_cuda(ws, bs, bmat, pts, torch.bfloat16)
        with pytest.raises(ValueError, match="32-bit tile-pair counts"):
            tfm.fourier_mlp_bwd_cuda(ws, bs, bmat, pts, torch.empty((n, 1), device=meta),
                                     torch.bfloat16)
    assert (tfm.counts.fwd_launches, tfm.counts.bwd_launches) == before


TOL = {"depth": (2e-4, 2e-4), "opacity": (2e-4, 2e-4), "var": (1e-3, 2e-4),
       "weights": (5e-3, 2e-4)}


def _composite_case(b, s, seed, wall=False):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(1.0 / 12, 10.0 / 12, (b, s)).astype(np.float32), axis=1)
    sigma = rng.normal(0.0, 3.0, (b, s)).astype(np.float32)
    if wall:
        sigma[: b // 2] = 0.0
        sigma[: b // 2, s // 2] = 1e8
    far = np.full((b,), 10.0 / 12, np.float32)
    dnorm = rng.uniform(0.5, 1.5, b).astype(np.float32)
    return z, sigma, far, dnorm


# (B, S, softplus, opaque wall): the earlier cases; the kernel table's shapes
# (16384 x 1024 and 2048), a virtual scan's and a depth frame's render chunks
# (2048 x 1024 and 2048); ragged B and S (S = 1; 33 and 1030, not multiples of
# 4; S = 5000 over three tiles).
COMPOSITE_CASES = [
    (300, 128, False, False), (1000, 1000, True, False), (17, 33, True, False),
    (256, 2048, False, True), (5, 1, True, False),
    (16384, 1024, True, False), (16384, 2048, False, True), (2048, 1024, True, True),
    (2048, 2048, True, False), (1, 1024, False, False), (2047, 1024, True, False),
    (2047, 33, False, True), (2047, 1, False, False), (3, 1030, True, True),
    (7, 1030, False, False), (5, 5000, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,softplus,wall", COMPOSITE_CASES)
def test_composite_kernel_matches_plain(cuda_device, b, s, softplus, wall):
    args = [torch.tensor(a, device=cuda_device) for a in _composite_case(b, s, 2, wall)]
    before = tc.counts.composite_launches
    out_k = tc.composite_cuda(*args, softplus=softplus)
    out_p = tc.composite_plain(*args, softplus=softplus)
    torch.cuda.synchronize()
    assert tc.counts.composite_launches == before + 1
    for name, a, p in zip(("depth", "opacity", "var", "weights"), out_k, out_p):
        rtol, atol = TOL[name]
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, p, rtol=rtol, atol=atol, msg=name)
    # composite_rays picks the kernel for a CUDA tensor.
    out_r = tc.composite_rays(*args, softplus=softplus)
    assert tc.counts.composite_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(out_r, out_k))


@pytest.mark.cuda
def test_composite_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    z, sigma, far, dnorm = [torch.tensor(a, device=cuda_device)
                            for a in _composite_case(8, 16, 3)]
    with pytest.raises(ValueError):
        tc.composite_cuda(z.double(), sigma, far, dnorm)
    with pytest.raises(ValueError):
        tc.composite_cuda(z, sigma, far.cpu(), dnorm)
    with pytest.raises(ValueError):
        tc.composite_cuda(z, sigma.clone().requires_grad_(True), far, dnorm)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(2048, 1024), (16384, 2048), (7, 1030), (5, 5000)])
def test_composite_kernel_is_deterministic(cuda_device, b, s):
    # Scans and sums in a fixed order, no atomics: two calls give the same bits.
    args = [torch.tensor(a, device=cuda_device) for a in _composite_case(b, s, 6, True)]
    first = tc.composite_cuda(*args, softplus=True)
    again = tc.composite_cuda(*args, softplus=True)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_composite_kernel_takes_misaligned_rows(cuda_device):
    # Rows that do not start on 16 bytes take the scalar path.
    b, s = 64, 1024
    z, sigma, far, dnorm = [torch.tensor(a, device=cuda_device) for a in _composite_case(b, s, 7)]
    z_off = torch.empty(b * s + 1, device=cuda_device)[1:].view(b, s)
    z_off.copy_(z)
    assert z_off.is_contiguous() and z_off.data_ptr() % 16
    out = tc.composite_cuda(z_off, sigma, far, dnorm, softplus=True)
    assert all(torch.equal(x, y) for x, y in zip(out, tc.composite_cuda(z, sigma, far, dnorm,
                                                                        softplus=True)))


@pytest.mark.parametrize("s", [1, 3, 4, 33, 128, 255, 256, 1000, 1024, 1030, 2048, 2049, 5000,
                               100_000])
def test_composite_plan_covers_each_row_once(s):
    for aligned in (True, False):
        plan = tc.composite_plan(s, aligned)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= tc.MAX_THREADS
        assert plan.v in (4, 8) and plan.v == (8 if s >= 256 else 4)
        tile = plan.threads * plan.v
        assert plan.tiles * tile >= s > (plan.tiles - 1) * tile
        assert plan.vec == (aligned and s % 4 == 0)
        # A row of up to 2048 samples is one tile, read once into registers.
        assert (plan.tiles == 1) == (s <= 2048)
    assert tc.composite_plan(1024) == tc.CompositePlan(128, 8, 1, True)
    assert tc.composite_plan(2048) == tc.CompositePlan(256, 8, 1, True)


def test_composite_plan_fields_and_guard():
    assert [f for f in tc.CompositePlan.__dataclass_fields__] == ["threads", "v", "tiles", "vec"]
    meta = torch.device("meta")
    far = torch.empty(2, device=meta)
    for s in (2 ** 31 - 8 * tc.MAX_THREADS + 1, 2 ** 31):
        z = torch.empty((2, s), device=meta)
        with pytest.raises(ValueError, match="samples"):
            tc.check_operands(z, z, far, far)
    z = torch.empty((2, 2 ** 31 - 8 * tc.MAX_THREADS), device=meta)
    assert tc.check_operands(z, z, far, far) == (2, 2 ** 31 - 8 * tc.MAX_THREADS)


HASH_CASES = [  # (grid, points): box_room_tiny's and the reference's, and an odd level count
    (dict(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5), 1),
    (dict(n_levels=6, log2_hashmap_size=14, per_level_scale=1.5), 70000),
    (dict(), 1000),
    (dict(), 262144),
    (dict(n_levels=5, log2_hashmap_size=12, per_level_scale=1.7), 3001),
]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def _hash_operands(grid: dict, n: int, device, seed: int = 0):
    cfg = HashEncodingConfig(**grid)
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.rand((cfg.total_table_size, 2), generator=gen, device=device) * 2 - 1
    pos = torch.rand((n, 3), generator=gen, device=device) * 1.1 - 0.05
    pos[: n // 8] = torch.round(pos[: n // 8])  # exact 0s and 1s, and some past them
    dout = torch.randn((n, cfg.output_dim), generator=gen, device=device)
    return cfg, table, pos, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,n", HASH_CASES)
def test_hash_kernels_match_plain(cuda_device, grid, n, dtype):
    cfg, table, pos, dout = _hash_operands(grid, n, cuda_device)
    before = (thg.counts.fwd_launches, thg.counts.bwd_launches)
    out = thg.hash_encode_fwd_cuda(table, pos, cfg, dtype)
    dtable, dpos = thg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype)
    assert (thg.counts.fwd_launches, thg.counts.bwd_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, thg.hash_encode_fwd_plain(table, pos, cfg, dtype),
                               rtol=0, atol=0)
    dtable_p, dpos_p = thg.hash_encode_bwd_plain(table, pos, dout, cfg, dtype)
    torch.testing.assert_close(dpos, dpos_p, rtol=0, atol=0)
    assert _rel_l2(dtable, dtable_p) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_kernels_take_operands_that_are_only_8_byte_aligned(cuda_device, dtype):
    """A table and an upstream gradient 8 bytes off a 16-byte boundary: no float4
    pairs, 8-byte staging."""
    cfg, table, pos, dout = _hash_operands({}, 3001, cuda_device, seed=5)
    table8 = torch.empty((table.shape[0] + 1, 2), device=cuda_device)[1:]
    dout8 = torch.empty(dout.numel() + 2, device=cuda_device)[2:].view(dout.shape)
    table8.copy_(table)
    dout8.copy_(dout)
    assert table8.data_ptr() % 16 == 8 and dout8.data_ptr() % 16 == 8
    assert torch.equal(thg.hash_encode_fwd_cuda(table8, pos, cfg, dtype),
                       thg.hash_encode_fwd_plain(table, pos, cfg, dtype))
    dtable_p, dpos_p = thg.hash_encode_bwd_plain(table, pos, dout, cfg, dtype)
    dtable, dpos = thg.hash_encode_bwd_cuda(table8, pos, dout8, cfg, dtype)
    assert torch.equal(dpos, dpos_p) and _rel_l2(dtable, dtable_p) <= 1e-5


@pytest.mark.cuda
def test_hash_autograd_takes_the_kernels_and_zero_points(cuda_device):
    cfg, table, pos, dout = _hash_operands({}, 5000, cuda_device, seed=3)
    table.requires_grad_(True)
    pos.requires_grad_(True)
    before = (thg.counts.fwd_launches, thg.counts.bwd_launches)
    (thg.hash_encode(table, pos, cfg, torch.bfloat16) * dout).sum().backward()
    assert (thg.counts.fwd_launches, thg.counts.bwd_launches) == (before[0] + 1, before[1] + 1)
    dtable_p, dpos_p = thg.hash_encode_bwd_plain(table.detach(), pos.detach(), dout, cfg,
                                                 torch.bfloat16)
    assert _rel_l2(table.grad, dtable_p) <= 1e-5
    torch.testing.assert_close(pos.grad, dpos_p, rtol=0, atol=0)
    empty = torch.zeros((0, 3), device=cuda_device)
    assert thg.hash_encode_fwd_cuda(table.detach(), empty, cfg, torch.float32).shape == (0, 32)


@pytest.mark.cuda
def test_hash_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    cfg, table, pos, dout = _hash_operands({}, 64, cuda_device)
    with pytest.raises(ValueError):
        thg.hash_encode_fwd_cuda(table, pos, cfg, torch.float16)
    with pytest.raises(ValueError):
        thg.hash_encode_fwd_cuda(table[:-1], pos, cfg, torch.float32)
    with pytest.raises(ValueError):
        thg.hash_encode_fwd_cuda(table, pos.double(), cfg, torch.float32)
    with pytest.raises(ValueError):
        thg.hash_encode_bwd_cuda(table, pos, dout[:, :8], cfg, torch.float32)
    with pytest.raises(ValueError):
        thg.hash_encode_fwd_cuda(table, pos.t().contiguous().t(), cfg, torch.float32)


# The redesigned kernels' warp-level work: ray-ordered and random points at the
# mapping path's counts and the edge cases of ab_compare.hash_edge_points.
HASH_INPUTS = [("ray", 2097152), ("ray", 262144), ("random", 262144), ("one_index", 0),
               ("runs_across_warps_and_blocks", 0), ("ragged_4133_random", 0), ("ragged_1", 0),
               ("ragged_31", 0), ("ragged_129", 0), ("faces_and_outside", 0)]


def _hash_input(case: str, n: int, device):
    points = hash_points(n, case) if n else hash_edge_points()[case]
    pos = torch.tensor(points, device=device)
    gen = torch.Generator(device=device).manual_seed(9)
    cfg = HashEncodingConfig()
    table = torch.rand((cfg.total_table_size, 2), generator=gen, device=device) * 2e-2 - 1e-2
    dout = torch.randn((pos.shape[0], cfg.output_dim), generator=gen, device=device)
    return cfg, table, pos, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,n", HASH_INPUTS)
def test_hash_kernels_match_plain_to_the_bit_with_and_without_dpos(cuda_device, case, n, dtype):
    cfg, table, pos, dout = _hash_input(case, n, cuda_device)
    out = thg.hash_encode_fwd_cuda(table, pos, cfg, dtype)
    assert torch.equal(out, thg.hash_encode_fwd_plain(table, pos, cfg, dtype))
    assert torch.equal(thg.hash_encode_fwd_cuda(table, pos, cfg, dtype), out)
    dtable_p, dpos_p = thg.hash_encode_bwd_plain(table, pos, dout, cfg, dtype)
    dtable, dpos = thg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype)
    assert torch.equal(dpos, dpos_p)
    assert _rel_l2(dtable, dtable_p) <= 1e-5
    before = (thg.counts.bwd_launches, thg.counts.bwd_no_dpos_launches)
    dtable_n, none = thg.hash_encode_bwd_cuda(table, pos, dout, cfg, dtype, need_dpos=False)
    assert none is None and _rel_l2(dtable_n, dtable_p) <= 1e-5
    assert (thg.counts.bwd_launches, thg.counts.bwd_no_dpos_launches) == (before[0] + 1,
                                                                          before[1] + 1)


def test_hash_inputs_follow_the_rays_and_the_edge_cases():
    ray = hash_points(4 * 512, "ray").reshape(4, 512, 3).astype(np.float64)
    step = np.linalg.norm(ray - ray[:, :1], axis=-1)  # distance from each ray's first sample
    assert np.all(np.diff(step, axis=1) >= -1e-6)  # sorted along the ray
    direction = (ray[:, -1] - ray[:, 0]) / step[:, -1:]
    off_line = ray - ray[:, :1] - step[..., None] * direction[:, None]
    assert np.abs(off_line).max() < 1e-5  # one straight ray of 512 samples
    assert ray.min() > -0.1 and ray.max() < 1.1
    rnd = hash_points(1000, "random")
    assert rnd.dtype == np.float32 and np.all(rnd[:64] == 0) and np.all(rnd[64:128] == 1)
    assert rnd.min() >= -0.01 and rnd.max() <= 1.01
    edges = hash_edge_points()
    assert [len(edges[c]) for c, _ in HASH_INPUTS[3:]] == [1000, 4096, 4133, 1, 31, 129, 343]
    runs = edges["runs_across_warps_and_blocks"]
    assert np.all(runs[16:48] == runs[16]) and np.all(runs[100:164] == runs[100])
    assert {0.0, 1.0} <= set(edges["faces_and_outside"].ravel().tolist())
