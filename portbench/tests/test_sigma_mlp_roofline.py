"""``sigma_mlp_roofline`` against hand arithmetic at the reference cell's shape,
and its reader on a made-up trace."""
import pytest

from portbench import harness
from portbench.peaks import PEAK_TF32_FLOPS, f32_bound_s, kernels
from portbench.trace import Trace

FLAGSHIP = harness.load_json(harness.PKG / "configs" / "flagship.json")
REFERENCE = harness.load_json(harness.PKG / "configs" / "reference.json")
TRAFFIC = harness.load_json(harness.PKG / "traffic" / "train-w8.json")
N = 8 * 512 * 512  # field points of a W=8 iteration

HASH_BWD = "void (anonymous namespace)::hash_bwd_kernel<true, true>(float const*)"
SIGMA_FWD = ("void (anonymous namespace)::sigma_mlp_fwd_kernel<32>(float const*, float const*, "
             "float const*, long long, long long, float*)")
SIGMA_BWD = ("void (anonymous namespace)::sigma_mlp_bwd_kernel<32>(float const*, float const*, "
             "float const*, float const*, long long, long long, int, int, float*, float*)")
SIGMA_REDUCE = ("(anonymous namespace)::sigma_mlp_dw_reduce_kernel(float const*, int, int, "
                "float*)")


def _trace(kernels, window_s=1.0):
    return Trace(kernels, [("cudaGraphLaunch", 0.0, 1e6)], window_s)


def test_the_sigma_mlp_roofline_takes_the_pair_over_the_step_mfu_count():
    """The bound is ``f32_bound_s`` of the count ``step_mfu`` gives the sigma MLP
    (6 n MACs) and of 264 bytes a point at D = 32; the time is the three kernels'
    alone, not the Fourier kernels' nor the products'. Without the pair (a tree
    before it), or for the Fourier field, there is nothing to read."""
    reader = harness.load_metric("sigma_mlp_roofline")
    flops, nbytes = reader.cost(N, REFERENCE["field"])
    assert flops == 6 * 2112 * N == 26_575_110_144
    assert nbytes == (4 * 32 + 4 + 4 + 4 * 32) * N
    assert f32_bound_s(flops, nbytes) == (pytest.approx(0.16526e-3, rel=1e-4), "bytes")
    assert 3 * flops / PEAK_TF32_FLOPS == pytest.approx(0.16106e-3, rel=1e-4)
    match = kernels(reader.KERNELS)
    assert match(SIGMA_FWD) and match(SIGMA_BWD) and match(SIGMA_REDUCE)
    assert not kernels(["fwd_kernel", "reduce_kernel", "dw_kernel"])(SIGMA_FWD + SIGMA_REDUCE)
    ks = [(SIGMA_FWD, 0, 300), ("sm80_xmma_gemm_f32f32", 300, 400), (HASH_BWD, 400, 600),
          (SIGMA_BWD, 600, 1400), (SIGMA_REDUCE, 1400, 1410),
          ("void ns::fwd_kernel<256>(x)", 1410, 2000)]
    ctx = {"trace": _trace(ks), "traced_iterations": 2, "points_per_iteration": N,
           "config": REFERENCE, "traffic": TRAFFIC, "chips": 1}
    assert reader.read(ctx) == pytest.approx(
        100 * f32_bound_s(flops, nbytes)[0] / (1110e-6 / 2))
    assert reader.read(dict(ctx, trace=_trace(ks[1:3] + ks[5:]))) is None
    assert reader.read(dict(ctx, config=FLAGSHIP)) is None
