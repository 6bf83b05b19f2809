"""``graph_capture_s``: seconds of set-up spent capturing CUDA graphs: the sum of
the port's ``graph.capture`` spans in this process (rank 0's on the mesh),
which ``common/cuda_graphs.py::CountedGraph.capture`` records always. Standard
error gets the other set-up spans beside it (``warm_up``, ``kernels.build``)."""
import sys


def read(ctx: dict):
    try:
        from loner_tpu_torch.runtime import profiling
    except ImportError:
        return None
    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    spans = totals()
    print("set-up spans (count, s): " + ", ".join(
        f"{name} {spans[name]}" for name in ("graph.capture", "warm_up", "kernels.build")
        if name in spans), file=sys.stderr)
    n, seconds = spans.get("graph.capture", (0, 0.0))
    return seconds if n else None
