"""``hash_bwd_roofline``: the hash grid's table gradient as a share of its
roofline, in %: ``csrc/hash_grid.cu::hash_bwd_kernel`` (every level group's
launch) and the fixed-point sums' zeroing and conversion to f32
(``ops/fixed_point.py``), which the same gradient needs.

The zeroing (PyTorch's int64 fill) and the conversion (a multiply by a scalar
that casts its int64 operand to f32) run under the same kernel names as other
int64 fills and casting multiplies, such as the occupancy grid's sums. So they
are picked by where they are launched, not by name alone: for each run of
consecutive ``hash_bwd_kernel`` launches, the last int64 fill before it and the
first casting multiply after it, neither past another run of the backward.

Bound: ``costs.hash_cost``'s backward with dpos (f32 operations at the f32
peak, or its bytes, whichever is larger; the table's gradient counted once, as
f32, whatever workspace the kernels use), over their device seconds a traced
iteration.
"""
import re

from portbench.costs import hash_cost
from portbench.peaks import PEAK_F32_FLOPS, bound_s, kernels, rank_points

KERNELS = ("hash_bwd_kernel",)
ZEROING = re.compile(r"(?<![A-Za-z0-9_])FillFunctor<long>")
CONVERSION = re.compile(r"(?<![A-Za-z0-9_])AUnaryFunctor<float, float, float, "
                        r"at::native::binary_internal::MulFunctor<float> >.*LoadWithCast")


def table_gradient_s(trace) -> float:
    """Seconds of every hash backward with its own zeroing and conversion."""
    ks = trace.kernels  # in order of start
    is_bwd = kernels(KERNELS)
    total, i = 0.0, 0
    while i < len(ks):
        if not is_bwd(ks[i][0]):
            i += 1
            continue
        j = i
        while j < len(ks) and is_bwd(ks[j][0]):
            j += 1
        total += sum(e - s for _, s, e in ks[i:j])
        for k in range(i - 1, -1, -1):
            if is_bwd(ks[k][0]):
                break
            if ZEROING.search(ks[k][0]):
                total += ks[k][2] - ks[k][1]
                break
        for k in range(j, len(ks)):
            if is_bwd(ks[k][0]):
                break
            if CONVERSION.search(ks[k][0]):
                total += ks[k][2] - ks[k][1]
                break
        i = j
    return total / 1e6


def read(ctx: dict):
    field = ctx["config"]["field"]
    tr = ctx.get("trace")
    if field["encoding_sigma"] != "hash" or tr is None or not ctx.get("traced_iterations"):
        return None
    t = table_gradient_s(tr) / ctx["traced_iterations"]
    if t <= 0:
        return None
    flops, nbytes = hash_cost(rank_points(ctx), field["pos_encoding_sigma"])["bwd"]
    return 100.0 * bound_s(flops, nbytes, PEAK_F32_FLOPS)[0] / t
