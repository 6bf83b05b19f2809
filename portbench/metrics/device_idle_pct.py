"""``device_idle_pct.<cells>``: the share of a training cell's traced window in
which no operation ran on the card (rank 0's on a mesh, from its own trace), in
%: one minus the union of the device operations' intervals (not their sum:
streams overlap) over the window's wall. ``device_idle_pct.train`` and
``device_idle_pct.mesh4`` both read here: two metrics because they move two
end-to-end metrics."""


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
