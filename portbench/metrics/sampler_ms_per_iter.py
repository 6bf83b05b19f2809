"""``sampler_ms_per_iter``: device milliseconds a traced iteration in the ray
build and sampler layer (``layers.py``): the segments between the port's layer
marks from the ray build to the sigma field's start, the proposal's linear loss
(forward and backward), and the backward from the points to the twists."""
from portbench.layers import layer_ms_per_iter

LAYER = "ray build and sampler"


def read(ctx: dict):
    return layer_ms_per_iter(ctx, LAYER)
