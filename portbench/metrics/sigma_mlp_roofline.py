"""``sigma_mlp_roofline``: the hash field's f32 sigma MLP as a share of its
roofline, in %: the kernel pair of ``csrc/sigma_mlp.cu`` (``sigma_mlp_fwd_kernel``,
``sigma_mlp_bwd_kernel`` and ``sigma_mlp_dw_reduce_kernel``).

Bound: ``peaks.f32_bound_s`` of the MLP's forward and backward, the count
``step_mfu`` takes (6 n MACs operations, the backward's recomputation not
counted), and its bytes (the features and the upstream gradient read once,
sigma and the features' gradient written once: 8 D + 8 bytes a point), at the
field points a rank evaluates an iteration, over the three kernels' device
seconds a traced iteration. Nothing to read for a Fourier field, or where the
kernels did not run.
"""
from portbench.costs import sigma_in_dim, sigma_macs
from portbench.peaks import f32_bound_s, per_iteration_s, rank_points

KERNELS = ("sigma_mlp_fwd_kernel", "sigma_mlp_bwd_kernel", "sigma_mlp_dw_reduce_kernel")


def cost(n: float, field: dict):
    return 6 * n * sigma_macs(field), (8 * sigma_in_dim(field) + 8) * n


def read(ctx: dict):
    field = ctx["config"]["field"]
    if field["encoding_sigma"] != "hash":
        return None
    t = per_iteration_s(ctx, KERNELS)
    if t is None:
        return None
    return 100.0 * f32_bound_s(*cost(rank_points(ctx), field))[0] / t
