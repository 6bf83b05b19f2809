"""``sigma_field_ms_per_iter``: device milliseconds a traced iteration in the
sigma field (``layers.py``): from the points to the field's output in the
forward and back again in the backward, the encoding (Fourier or hash), its
MLP and their casts. In the reference, this less the ``hash_*`` kernels is the
f32 MLP with its elementwise operations."""
from portbench.layers import layer_ms_per_iter

LAYER = "sigma field"


def read(ctx: dict):
    return layer_ms_per_iter(ctx, LAYER)
