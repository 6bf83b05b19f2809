"""``phase_seam_idle_ms_per_iter``: milliseconds a traced iteration in which the
card idled while the host was in the port's phase outside its dispatches: the
span ``phase`` and its other children (the seat, the capture, the collection
of the debug record, the overflow check, the marks' read, the copy out) and
rank 0's wait on the mesh at the phase's end (``mesh.wait``). The rule is
``dispatch_idle_ms_per_iter``'s (``layers.py``); also
``phase_seam_idle_ms_per_iter.mesh4``."""
import sys

from portbench.layers import idle_ms_per_iter


def read(ctx: dict):
    return idle_ms_per_iter(ctx, False, err=lambda s: print(s, file=sys.stderr))
