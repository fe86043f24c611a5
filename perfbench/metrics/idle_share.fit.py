"""The device's idle share of a step, 100 x (1 - busy / wall): busy is
the union of every device operation's interval over the traced steps, a
step's share of it; wall is a step's host time over the untraced steps
that ran before them, ended by a synchronise.  The profiler slows the
host (about twice the step's wall time here), so the traced stretch's own
wall time would overstate the idle share; its kernels' times it leaves
as they are."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("iterations") or not tr.get("untraced_s_per_iteration"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["iterations"] / tr["untraced_s_per_iteration"])
