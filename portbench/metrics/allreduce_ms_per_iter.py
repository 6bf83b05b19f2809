"""``allreduce_ms_per_iter``: rank 0's NCCL kernels, device milliseconds a traced
iteration of the mesh's joint phase (the gradient all-reduces inside the
captured iteration and the phase's broadcasts)."""

KERNELS_CONTAIN = "nccl"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or ctx.get("chips", 1) < 2 or not ctx.get("traced_iterations"):
        return None
    t = tr.device_s(lambda n: KERNELS_CONTAIN in n.lower())
    return 1e3 * t / ctx["traced_iterations"] if t > 0 else None
