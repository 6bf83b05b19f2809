"""``hash_fwd_roofline``: the hash grid's forward kernel
(``csrc/hash_grid.cu::hash_fwd_kernel``) as a share of its roofline, in %.

Bound: ``costs.hash_cost``'s forward (f32 operations at the f32 peak, or its
bytes at the HBM rate, whichever is larger) at the field points a rank
evaluates an iteration, over the kernel's device seconds a traced iteration.
"""
from portbench.costs import hash_cost
from portbench.peaks import PEAK_F32_FLOPS, bound_s, per_iteration_s, rank_points

KERNELS = ("hash_fwd_kernel",)


def read(ctx: dict):
    field = ctx["config"]["field"]
    if field["encoding_sigma"] != "hash":
        return None
    t = per_iteration_s(ctx, KERNELS)
    if t is None:
        return None
    flops, nbytes = hash_cost(rank_points(ctx), field["pos_encoding_sigma"])["fwd"]
    return 100.0 * bound_s(flops, nbytes, PEAK_F32_FLOPS)[0] / t
