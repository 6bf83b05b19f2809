"""``step_mfu``: the model's operations in one joint iteration as a share of the
chip's peak over the iteration's time, in % (also ``step_mfu.mesh4``, the
mesh's, which moves that cell's own end-to-end metric).

Operations: ``costs.flops_per_iteration``. The iteration's time is the untraced
window's seconds over its iterations; the peak is the one the configuration
file names for its compute dtype, times the chips.
"""
from portbench.costs import flops_per_iteration


def read(ctx: dict):
    t = ctx.get("iteration_s")
    if not t:
        return None
    peak = ctx["config"]["peak"]["flops_per_s"] * ctx.get("chips", 1)
    return 100.0 * flops_per_iteration(ctx["config"], ctx["traffic"]) / (t * peak)
