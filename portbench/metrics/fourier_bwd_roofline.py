"""``fourier_bwd_roofline``: the Fourier sigma field's backward
(``csrc/fourier_mlp.cu``: ``features_kernel``, ``bwd_tile_kernel``,
``dw_kernel``, ``reduce_kernel``; in f32 ``bwd_f32_kernel``,
``reduce_f32_kernel``) as a share of its roofline, in %.

Bound: 6 n MACs operations (the forward's products, dX and dW of every layer;
the kernels' recomputation of the forward is not counted), or 28 n bytes
(points and the sigma cotangent in, the points' gradient out) plus twice the
parameters' bytes, whichever is larger. Divided by the kernels' summed device
seconds a traced iteration.
"""
from portbench.costs import fourier_param_bytes, sigma_macs
from portbench.peaks import bound_s, f32_bound_s, per_iteration_s, rank_points

KERNELS = ("features_kernel", "bwd_tile_kernel", "dw_kernel", "reduce_kernel",
           "bwd_f32_kernel", "reduce_f32_kernel")


def cost(n: float, field: dict):
    return 6 * n * sigma_macs(field), 28 * n + 2 * fourier_param_bytes(field)


def read(ctx: dict):
    field = ctx["config"]["field"]
    if field["encoding_sigma"] != "fourier":
        return None
    t = per_iteration_s(ctx, KERNELS)
    if t is None:
        return None
    flops, nbytes = cost(rank_points(ctx), field)
    least = f32_bound_s(flops, nbytes) if field["compute_dtype"] == "float32" else bound_s(flops, nbytes)
    return 100.0 * least[0] / t
