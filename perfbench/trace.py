"""Reading a torch.profiler trace: device intervals, their union, the
idle gaps between them and what the host was doing in each.

The union is ``ascendpathtracing_tpu_torch/bench.py``'s ``busy_us``
arithmetic, copied: every device operation (kernel, memset, memcpy)
counts, overlaps once.
"""

from __future__ import annotations

import bisect
import re

#: A kernel of the program's own ``csrc/`` libraries: they all live in
#: an anonymous namespace, which torch's kernels do not open at top level.
CSRC = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)|_GLOBAL__N_\w*)::(\w+)")


def csrc_kernel(name: str) -> str | None:
    """The ``csrc/`` kernel's function name, or None for any other
    device operation."""
    m = CSRC.match(name)
    return m.group(1) if m else None


def union(intervals) -> list[tuple[float, float]]:
    """(start, end) intervals -> their union, sorted and disjoint."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy(intervals) -> float:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for a, b in union(intervals):
        if a > reach:
            out.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def by_name(events, top: int = 10) -> list[list]:
    """(name, start, end) events -> [[name, total], ...], the ``top``
    largest totals."""
    tot: dict[str, float] = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def label_gaps(gap_list, host_events, top: int = 10, longest: int = 400) -> list[list]:
    """Each of the ``longest`` gaps named by the innermost host event
    (name, start, end) that covers its middle ("idle" where none does)
    -> [[name, total length], ...], the ``top`` largest."""
    host = sorted(host_events, key=lambda e: e[1])
    starts = [e[1] for e in host]
    named = []
    for a, b in sorted(gap_list, key=lambda g: g[0] - g[1])[:longest]:
        mid = (a + b) / 2
        name = "idle"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        named.append((name, a, b))
    return by_name(named, top)


def profiler_events(prof):
    """A finished torch.profiler.profile -> (device events, host events),
    each a list of (name, start_us, end_us)."""
    import torch

    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    return dev, host
