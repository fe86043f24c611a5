"""The device's idle share over the traced frames, 100 x (1 - busy /
wall): busy is the union of every device operation's interval (kernels
and copies), wall the traced stretch's own, ended by a synchronise.  The
render loop keeps the next frame queued behind the one rendering, so the
profiler's cost on the host does not reach the card unless it outlasts a
frame."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("iterations") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
