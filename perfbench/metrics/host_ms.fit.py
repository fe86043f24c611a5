"""Host milliseconds a step inside the program's step call
(``parallel/sharded.make_train_step``), from perfbench's own spans
around the call, no synchronise inside; the mean over the window's
untraced steps."""


def read(ctx):
    spans = ctx.get("host_ms") or []
    return sum(spans) / len(spans) if spans else None
