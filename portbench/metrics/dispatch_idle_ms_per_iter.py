"""``dispatch_idle_ms_per_iter``: milliseconds a traced iteration in which the
card idled while the host was in a dispatch span of the port: the wait on
dispatch n - d (``dispatch.wait``, with rank 0's poll of the mesh inside it) or
the enqueue of a dispatch's replays (``dispatch.enqueue``). Each idle
microsecond of the trace goes to the innermost program span that covers it
(``layers.py``). Also ``dispatch_idle_ms_per_iter.mesh4``: rank 0's, on the
mesh. Standard error gets the idle by span, the idle in no span (the generator's
own Python between phases) and the dispatch waits that found their dispatch
done."""
import sys

from portbench.layers import idle_ms_per_iter


def read(ctx: dict):
    return idle_ms_per_iter(ctx, True, err=lambda s: print(s, file=sys.stderr))
