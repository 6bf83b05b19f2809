"""``camera_branch_ms_per_iter``: device milliseconds a traced iteration in the
camera branch layer (``layers.py``): the segments between the port's camera
marks, forward and backward: the camera rays, their proposal samples, sigma at
their points, the intensity head, the colours' compositing and the weighted
MSE. Nothing where the port has no such layer."""
from portbench.layers import layer_ms_per_iter, layer_table

LAYER = "camera branch"


def read(ctx: dict):
    if LAYER not in (layer_table() or ()):
        return None
    return layer_ms_per_iter(ctx, LAYER)
