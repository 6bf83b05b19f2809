"""``fourier_fwd_roofline``: the Fourier sigma field's forward kernel
(``csrc/fourier_mlp.cu::fwd_kernel``; in f32 ``fwd_f32_kernel``) as a share of
its roofline, in %.

Bound: 2 n MACs operations at the bf16 peak (f32: ``f32_bound_s``), or 16 n
bytes (points in, sigma out) plus the parameters' bytes, whichever is larger;
n is the field points a rank evaluates an iteration, MACs the MLP's
multiply-adds a point. Divided by the kernel's device seconds a traced
iteration.
"""
from portbench.costs import fourier_param_bytes, sigma_macs
from portbench.peaks import bound_s, f32_bound_s, per_iteration_s, rank_points

KERNELS = ("fwd_kernel", "fwd_f32_kernel")


def cost(n: float, field: dict):
    return 2 * n * sigma_macs(field), 16 * n + fourier_param_bytes(field)


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
