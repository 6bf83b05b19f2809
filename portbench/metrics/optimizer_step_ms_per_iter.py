"""``optimizer_step_ms_per_iter``: device milliseconds a traced iteration in the
optimizer step (``layers.py``): the fixed-point sums' zeroing at the
iteration's start and, after the backward, the gradient masks, the fixed-point
conversions, Adam, the OGM step and the iteration's record."""
from portbench.layers import layer_ms_per_iter

LAYER = "optimizer step"


def read(ctx: dict):
    return layer_ms_per_iter(ctx, LAYER)
