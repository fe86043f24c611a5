"""The program's own spans in a torch.profiler trace: which of them
launched each device operation, how long the host waited on the device
inside them, and four per-layer readings of that.

The program (``ascendpathtracing_tpu_torch``) wraps its layers in ranges
named ``apt.`` ...: ``apt.train_step`` and its parts, ``apt.mesh_diff.*``,
``apt.replay.chunk`` and ``apt.kernel.<key>`` around each kernel wrapper.
They are host events of the trace.  The attribution rule:

1. a device operation (kernel, memcpy or memset) is linked to the host
   runtime call that launched it by the profiler's correlation id
   (``FunctionEvent.id``, shared by the two);
2. it belongs to the chain of ``apt.`` spans open on the launching
   thread when that call began, outermost first;
3. where none is open there, to the chain open on another thread, the
   one whose innermost span began last: the thread that waits on the
   launching one.  The autograd engine runs a CUDA backward on a device
   thread of its own while the caller's thread holds
   ``apt.train_step.backward`` open.

Host waits are the ``Command Buffer Full`` events (a launch that waited
for room in the device's queue) and the runtime's synchronise calls,
their union clipped to the union of the ``apt.`` spans.

``summary(prof)`` gives all of that as one dict (seconds from the same
origin as the harness's ``device_events``), for a traced stretch's
context under ``ctx["trace"]["spans"]``; the readers below read it and
give None where it is absent (a program without spans).  The harness
does not put it there yet; until it does,

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``perfbench.run --trace 1`` does, with the traced
stretch's summary widened by ``spans``, and prints after the result
line one JSON object: the four readings and the device milliseconds a
step of each innermost span.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import bisect
import json
import sys

from perfbench import trace

PREFIX = "apt."
KERNEL = "apt.kernel."
TRAINER = "apt.train_step"
REPLAY = "apt.mesh_diff.backward"
BUFFER_FULL = "Command Buffer Full"
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize"})


def attribute(spans, launches) -> list[tuple[str, ...]]:
    """spans [(name, thread, start, end)] and launches [(thread, t)] ->
    each launch's chain of span names, outermost first (() where no span
    is open on any thread).  Per thread the spans nest; a launch at a
    span's start or end is inside it."""
    # Sweep in time order: starts, then launches, then ends at one time.
    events = [(s[2], 0, i) for i, s in enumerate(spans)]
    events += [(t, 1, i) for i, (_, t) in enumerate(launches)]
    events += [(s[3], 2, i) for i, s in enumerate(spans)]
    open_on: dict = {}
    out: list[tuple[str, ...]] = [()] * len(launches)
    for _, kind, i in sorted(events):
        if kind == 0:
            open_on.setdefault(spans[i][1], []).append(i)
        elif kind == 2:
            open_on[spans[i][1]].remove(i)
        else:
            stack = open_on.get(launches[i][0])
            if not stack:
                waiting = [s for s in open_on.values() if s]
                stack = max(waiting, key=lambda s: spans[s[-1]][2], default=[])
            out[i] = tuple(spans[j][0] for j in stack)
    return out


def clip(intervals, to) -> list[tuple[float, float]]:
    """The union of ``intervals`` inside the union of ``to``."""
    cover = trace.union(to)
    starts = [a for a, _ in cover]
    out = []
    for a, b in trace.union(intervals):
        for c, d in cover[max(0, bisect.bisect_right(starts, a) - 1):]:
            if c >= b:
                break
            if min(b, d) > max(a, c):
                out.append((max(a, c), min(b, d)))
    return out


def records(events):
    """Profiler events (``prof.events()``) -> (spans, ops, launches,
    waits), times in microseconds: spans [(name, thread, start, end)];
    device operations [(name, id, start, end)], device-typed annotations
    left out; host runtime calls {id: (thread, start)}; host waits
    [(start, end)]."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, ops, launches, waits = [], [], {}, []
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                ops.append((e.name, e.id, a, b))
        elif e.name.startswith(PREFIX):
            spans.append((e.name, e.thread, a, b))
        elif e.name.startswith("cu"):
            launches[e.id] = (e.thread, a)
        if e.name in SYNCS or e.name == BUFFER_FULL:
            waits.append((a, b))
    return spans, ops, launches, waits


def summary(prof) -> dict:
    """A finished profiler -> {"spans": [[name, thread, start, end]],
    "ops": [[name, start, end, [span chain]]], "waits": [[start, end]]},
    in seconds from the earliest event's start (the origin of the
    harness's ``device_events``)."""
    events = list(prof.events())
    t0 = min((float(e.time_range.start) for e in events), default=0.0)
    spans, ops, launches, waits = records(events)
    linked = [launches.get(op[1]) for op in ops]
    found = [i for i, ln in enumerate(linked) if ln is not None]
    chains = attribute(spans, [linked[i] for i in found])
    chain_of = dict(zip(found, chains))

    def s(t):
        return (t - t0) * 1e-6

    return {
        "spans": [[n, th, s(a), s(b)] for n, th, a, b in spans],
        "ops": [[n, s(a), s(b), list(chain_of.get(i, ()))]
                for i, (n, _, a, b) in enumerate(ops)],
        "waits": [[s(a), s(b)] for a, b in clip(waits, [(a, b) for _, _, a, b in spans])],
    }


# ------------------------------------------------------------- readers ----
def _read(ctx):
    tr = ctx.get("trace") or {}
    sp = tr.get("spans")
    if not tr.get("iterations") or not sp or not sp["spans"]:
        return None, 0
    return sp, tr["iterations"]


def launches_per_step(ctx):
    """Device operations a step launched under any ``apt.`` span."""
    sp, n = _read(ctx)
    return None if sp is None else sum(1 for op in sp["ops"] if op[3]) / n


def host_wait_ms(ctx):
    """Host milliseconds a step that the program's spans spent blocked
    on the device."""
    sp, n = _read(ctx)
    return None if sp is None else sum(b - a for a, b in sp["waits"]) / n * 1e3


def span_ms(ctx, root: str):
    """Device milliseconds a step of the operations launched under
    ``root`` (at any depth) and outside every ``apt.kernel.*`` span; None
    where nothing was launched under ``root``."""
    sp, n = _read(ctx)
    if sp is None:
        return None
    under = [op for op in sp["ops"] if root in op[3]]
    if not under:
        return None
    return sum(b - a for _, a, b, chain in under
               if not any(c.startswith(KERNEL) for c in chain)) / n * 1e3


READERS = {
    "launches_per_step.fit": launches_per_step,
    "host_wait_ms.fit": host_wait_ms,
    "trainer_span_ms": lambda ctx: span_ms(ctx, TRAINER),
    "replay_span_ms": lambda ctx: span_ms(ctx, REPLAY),
}


def by_span(ctx) -> dict:
    """Device milliseconds a step by each operation's innermost span
    ("outside" for none)."""
    sp, n = _read(ctx)
    if sp is None:
        return {}
    out: dict = {}
    for _, a, b, chain in sp["ops"]:
        key = chain[-1] if chain else "outside"
        out[key] = out.get(key, 0.0) + (b - a) / n * 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    from perfbench import harness, run

    argv = list(sys.argv[1:] if argv is None else argv)
    plain = harness.Tracer.summary
    seen: dict = {}

    def with_spans(self):
        out = plain(self)
        if out:
            out["spans"] = summary(self.prof)
            seen.update(out)
        return out

    harness.Tracer.summary = with_spans
    rc = run.main(argv + ["--trace", "1"])
    ctx = {"trace": seen}
    line = {name: read(ctx) for name, read in READERS.items()}
    line["by_span_ms"] = by_span(ctx)
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
