"""``composite_loss_ms_per_iter``: device milliseconds a traced iteration in
compositing and the LiDAR loss (``layers.py``), forward and backward."""
from portbench.layers import layer_ms_per_iter

LAYER = "compositing and loss"


def read(ctx: dict):
    return layer_ms_per_iter(ctx, LAYER)
