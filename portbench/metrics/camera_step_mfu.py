"""``camera_step_mfu``: ``step_mfu`` of a cell whose phases train the camera
branch: the model's operations in one joint iteration, the camera branch's
counted too (``costs_camera.flops_per_iteration``), as a share of the chip's
peak over the iteration's time, in %. The iteration's time is the untraced
window's seconds over its iterations; the peak is the one the configuration
file names for its compute dtype, times the chips."""
from portbench.costs_camera import flops_per_iteration


def read(ctx: dict):
    t = ctx.get("iteration_s")
    if not t or not ctx["config"]["optimizer"].get("n_camera_samples"):
        return None
    peak = ctx["config"]["peak"]["flops_per_s"] * ctx.get("chips", 1)
    return 100.0 * flops_per_iteration(ctx["config"], ctx["traffic"]) / (t * peak)
