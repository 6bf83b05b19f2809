"""The yardstick's counts against hand arithmetic at the cells' shapes, and the
readers on a made-up trace."""
import pytest

from portbench import harness
from portbench.costs import hash_cost, hash_table_entries, sigma_macs
from portbench.peaks import PEAK_F32_FLOPS, bound_s, kernels
from portbench.trace import Trace

FLAGSHIP = harness.load_json(harness.PKG / "configs" / "flagship.json")
REFERENCE = harness.load_json(harness.PKG / "configs" / "reference.json")
TRAFFIC = harness.load_json(harness.PKG / "traffic" / "train-w8.json")
N = 8 * 512 * 512  # field points of a W=8 iteration


def test_flagship_iteration_flops():
    assert sigma_macs(FLAGSHIP["field"]) == 99 * 256 + 256 * 256 + 256
    assert 6 * 91136 * N == 1_146_756_268_032  # the sigma MLP, about 1.147e12
    proposal = 12896 * 4096 * 33 + 38688 * 4096 * 64  # (2 M + 6 F) ctrl + (6 M + 18 F) trained
    total = 1_146_756_268_032 + 18 * 48 * N + proposal
    assert harness.load_metric("step_mfu").flops_per_iteration(FLAGSHIP, TRAFFIC) == total
    assert total == 1_160_453_160_960


def test_reference_iteration_flops():
    assert sigma_macs(REFERENCE["field"]) == 32 * 64 + 64
    total = 6 * 2112 * N + (57 + 135) * 16 * N
    assert harness.load_metric("step_mfu").flops_per_iteration(REFERENCE, TRAFFIC) == total
    assert total == 33_017_561_088


def test_kernel_bounds():
    fwd = harness.load_metric("fourier_fwd_roofline").cost(N, FLAGSHIP["field"])
    bwd = harness.load_metric("fourier_bwd_roofline").cost(N, FLAGSHIP["field"])
    assert bound_s(*fwd) == (pytest.approx(0.3865e-3, rel=1e-3), "operations")
    assert bound_s(*bwd) == (pytest.approx(1.1595e-3, rel=1e-3), "operations")
    enc = REFERENCE["field"]["pos_encoding_sigma"]
    assert hash_table_entries(enc) == 3_710_866
    cost = hash_cost(N, enc)
    assert cost["fwd"][1] == 140 * N + 8 * 3_710_866
    assert bound_s(*cost["fwd"], PEAK_F32_FLOPS) == (pytest.approx(0.0965e-3, rel=1e-3), "bytes")
    assert bound_s(*cost["bwd"], PEAK_F32_FLOPS) == (pytest.approx(0.11288e-3, rel=1e-3), "bytes")


def test_kernel_names_match_whole():
    match = kernels(["fwd_kernel"])
    assert match("void (anonymous namespace)::fwd_kernel<256>(float const*, long long)")
    assert not match("void (anonymous namespace)::hash_fwd_kernel<true>(float const*)")
    assert not match("void (anonymous namespace)::fwd_f32_kernel<128>(float const*)")


def _trace(kernels, window_s=1.0):
    return Trace(kernels, [("cudaGraphLaunch", 0.0, 1e6)], window_s)


def test_busy_is_a_union_and_readers_divide_by_iterations():
    # Two streams' kernels overlap: busy is their union, 0.6 s of a 1 s window.
    tr = _trace([("void ns::fwd_kernel<256>(x)", 0.0, 4e5), ("gemm", 2e5, 6e5)])
    assert tr.busy_s == pytest.approx(0.6)
    ctx = {"trace": tr, "traced_iterations": 100, "points_per_iteration": N,
           "config": FLAGSHIP, "traffic": TRAFFIC, "chips": 1, "iteration_s": 0.01}
    assert harness.load_metric("device_idle_pct.train").read(ctx) == pytest.approx(40.0)
    # fwd_kernel: 0.4 s over 100 iterations, 4 ms an iteration, bound 0.3865 ms.
    share = harness.load_metric("fourier_fwd_roofline").read(ctx)
    assert share == pytest.approx(100 * 0.38652e-3 / 4e-3, rel=1e-3)
    mfu = harness.load_metric("step_mfu").read(ctx)
    assert mfu == pytest.approx(100 * 1_160_453_160_960 / (0.01 * 989e12))
    # No hash kernel ran, and the flagship has no hash grid: nothing to read.
    assert harness.load_metric("hash_fwd_roofline").read(ctx) is None
    assert harness.load_metric("fourier_bwd_roofline").read(ctx) is None
    assert harness.load_metric("allreduce_ms_per_iter").read(ctx) is None


def test_mesh_readers_take_a_rank_share():
    tr = _trace([("void ns::fwd_kernel<256>(x)", 0.0, 1e5), ("ncclDevKernel_AllReduce", 1e5, 1.2e5)])
    ctx = {"trace": tr, "traced_iterations": 100, "points_per_iteration": N,
           "config": FLAGSHIP, "traffic": TRAFFIC, "chips": 4, "iteration_s": 0.004}
    assert harness.load_metric("allreduce_ms_per_iter").read(ctx) == pytest.approx(0.2)
    share = harness.load_metric("fourier_fwd_roofline").read(ctx)
    assert share == pytest.approx(100 * 0.38652e-3 / 4 / 1e-3, rel=1e-3)
    mfu = harness.load_metric("step_mfu.mesh4").read(ctx)
    assert mfu == pytest.approx(100 * 1_160_453_160_960 / (0.004 * 4 * 989e12))
    assert harness.load_metric("device_idle_pct.mesh4").read(ctx) == pytest.approx(
        100 * (1 - 0.12 / 1.0))


def test_a_split_metric_reads_with_its_quantitys_reader():
    assert harness.metric_file("step_mfu.mesh4") == harness.PKG / "metrics" / "step_mfu.py"
    assert harness.metric_file("device_idle_pct.train").name == "device_idle_pct.py"
    assert harness.metric_file("hash_bwd_roofline").name == "hash_bwd_roofline.py"


FILL_INT64 = ("void at::native::vectorized_elementwise_kernel<2, at::native::FillFunctor<long>, "
              "std::array<char*, 1ul> >(int, at::native::FillFunctor<long>, std::array<char*, 1ul>)")
TO_F32 = ("void at::native::unrolled_elementwise_kernel<at::native::AUnaryFunctor<float, float, "
          "float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 2ul>, 4, "
          "TrivialOffsetCalculator<1, unsigned int>, TrivialOffsetCalculator<1, unsigned int>, "
          "at::native::memory::LoadWithCast<1>, at::native::memory::StoreWithCast<1> >(int)")
HASH_BWD = "void (anonymous namespace)::hash_bwd_kernel<true, true>(float const*)"


def test_the_hash_backward_takes_its_own_zeroing_and_conversion():
    """The table's int64 fill just before the backward's launches and the first
    casting multiply after them count; the occupancy grid's fill and conversion,
    of the same kernel names elsewhere in the iteration, do not."""
    ks = [(FILL_INT64, 0, 10),           # the table's sums zeroed
          ("gemm", 10, 20),
          (HASH_BWD, 20, 120), (HASH_BWD, 120, 220), (HASH_BWD, 220, 320),  # level groups
          ("void at::native::CompareFunctor<float>(x)", 320, 321),
          (TO_F32, 321, 341),            # the table's sums to f32
          (TO_F32, 341, 400),            # another casting multiply: not the table's
          (FILL_INT64, 400, 500),        # the occupancy grid's sums zeroed
          (TO_F32, 500, 600)]            # and converted
    tr = _trace(ks)
    assert harness.load_metric("hash_bwd_roofline").table_gradient_s(tr) == pytest.approx(
        (10 + 300 + 20) / 1e6)
    ctx = {"trace": tr, "traced_iterations": 1, "points_per_iteration": N,
           "config": REFERENCE, "traffic": TRAFFIC, "chips": 1}
    flops, nbytes = hash_cost(N, REFERENCE["field"]["pos_encoding_sigma"])["bwd"]
    assert harness.load_metric("hash_bwd_roofline").read(ctx) == pytest.approx(
        100 * bound_s(flops, nbytes, PEAK_F32_FLOPS)[0] / 330e-6)
    assert harness.load_metric("hash_bwd_roofline").read(dict(ctx, config=FLAGSHIP)) is None
