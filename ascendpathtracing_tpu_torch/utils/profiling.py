"""Profiling and timing of the port.

Counterpart of ``ascendpathtracing_tpu/utils/profiling.py``:

- :func:`span` and :func:`spanned` — the program's own named ranges
  (``apt.`` ...) at its layer boundaries, recorded while a torch profiler
  records and free otherwise.
- :func:`trace` — a context manager around ``torch.profiler`` (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace into
  a directory.
- :func:`device_fence` — a sync that provably waits for device work.
- :func:`benchmark` — steady-state timing with value-fetch fencing.
- :func:`benchmark_fit` — the two-point fit that separates the per-step
  time from the fixed per-batch overhead.
- :func:`mrays` — the BASELINE throughput metric helper.
- :func:`roofline` — a back-of-envelope arithmetic intensity of the
  sphere megakernel (``utils/roofline.count_ops`` counts ops instead).

TIMING ON CUDA: kernel launches return before the card runs them; they
queue on a CUDA stream in order.  Fetching a scalar reduction of the
last output (``float(x.sum())``) waits for that stream, so it fences
every step launched before it on the stream.  :func:`benchmark` and
:func:`benchmark_fit` therefore launch a batch of steps back to back,
fence once, and take the fence's own round trip out of the time (the
first by subtracting it, the second by fitting two batch sizes).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils import _pytree as pytree

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``name`` (``apt.`` then the
    layer) in the trace of a torch profiler that is recording, and the
    shared null context when none is (one attribute read: the profiler's
    own flag, no environment variable).

    The range is a function-scope record function: a host event on the
    thread that ran it, to which the profiler links the device operations
    launched inside it.  ``torch.profiler.record_function`` (a user scope)
    would also put a device-typed annotation over those operations into
    the trace, which a reader that sums device events counts as device
    work; this one adds none."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def spanned(name: str):
    """Decorator: the whole call of the function inside :func:`span`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host and, where there is a card, of its
    CUDA kernels; written as ``trace.json`` (Chrome trace format, viewable
    in Perfetto or chrome://tracing) into ``logdir`` on exit.  The trace
    carries the program's :func:`span` ranges (``apt.train_step`` and its
    parts, ``apt.mesh_diff.*``, ``apt.replay.chunk``, ``apt.kernel.<key>``
    around each kernel wrapper) as host events, the kernels they launched
    linked to them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
    leaves = pytree.tree_leaves(out)
    return next((x for x in leaves if isinstance(x, torch.Tensor)), None)


def device_fence(out) -> float:
    """Wait until ``out`` (a tensor or a pytree of them) is computed, by
    fetching a scalar sum of its first tensor leaf (a bool tensor as
    int).  Returns the fetched scalar (so the call cannot be optimized
    away).  With no tensor leaf it synchronizes the card, if one is in
    use, and returns 0.0."""
    x = _first_tensor(out)
    if x is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return 0.0
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return float(x.sum())


def fetch_rtt(iters: int = 5, device="cuda") -> float:
    """Measured round trip of one scalar fetch on ``device`` (the fencing
    overhead to subtract from asynchronous timings).  ``device`` is
    ``"cuda"`` unless the caller asks for the CPU; it raises when CUDA is
    asked for and absent."""
    from ascendpathtracing_tpu_torch.device import resolve_device

    if not isinstance(device, torch.device):
        device = resolve_device(device)
    one = torch.ones((8,), dtype=torch.float32, device=device)
    float(one.sum())
    t0 = time.perf_counter()
    for _ in range(iters):
        float(one.sum())
    return (time.perf_counter() - t0) / iters


def benchmark(fn, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """Steady-state timing (one batch).  Returns ``mean_s`` only: the
    batch is fenced once, so no per-call distribution exists to report.

    Launches ``iters`` calls back to back (they queue on the stream),
    fences ONCE on a scalar reduction of the last output, and subtracts
    the scalar-fetch round trip, measured on the output's device.  The
    residual fixed overhead (the first launch's latency and the like) is
    NOT removed here; for headline numbers use :func:`benchmark_fit`,
    which fits it out.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    device_fence(out)
    x = _first_tensor(out)
    rtt = fetch_rtt(device=x.device if x is not None else "cuda")

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    device_fence(out)
    total = time.perf_counter() - t0
    mean = max(total - rtt, 1e-9) / iters
    return {
        "mean_s": mean,
        "iters": iters,
        "fence_rtt_s": rtt,
    }


def benchmark_fit(
    fn,
    iters: int = 8,
    warmup: int = 2,
    agree: float = 0.05,
    max_rounds: int = 4,
    max_seconds: float = 180.0,
):
    """Two-point-fit timing: separates the TRUE per-step device time from
    the fixed per-batch overhead (the fence's round trip, the first
    launch's latency, the host's turnaround).

    ``fn(i)`` launches step ``i`` (the argument lets callers vary a seed
    from step to step).  Batches of ``k`` and ``3k`` launches are each
    fenced once and timed; the slope ``(t2 - t1) / (3k - k)`` is the
    per-step time with ALL fixed costs cancelled, and the intercept is
    the overhead.  The pair measurement repeats until two consecutive
    slope estimates agree within ``agree`` (default 5%), doubling ``k``
    on disagreement; the result is their mean.

    ``max_seconds`` bounds the total measuring time: once exceeded, the
    current pair's estimate is returned (rel_spread reports whatever
    agreement was reached) instead of doubling again — slow steps
    (multi-second renders) would otherwise grow the pair geometrically.

    A round whose slope comes out non-positive (timing noise made
    ``t2 <= t1``) is INVALID: it is discarded and the pair size doubles
    — a clamped 1e-12 slope must never become a headline number.  If the
    loop exhausts without two consecutive slopes agreeing, ``fit_ok`` is
    False and the result falls back to the last valid slope, or — when
    no round ever produced a valid slope — to the conservative
    single-batch estimate ``t2 / (3k)`` (which still contains the
    per-batch overhead, i.e. an upper bound on the step time).

    Returns dict: step_s, overhead_s, rel_spread, iters, rounds,
    fit_ok, fenced_batches (list of (k, seconds) actually measured).
    """
    out = None
    step_i = 0
    for _ in range(max(warmup, 1)):
        out = fn(step_i)
        step_i += 1

    device_fence(out)

    def batch(k):
        nonlocal step_i, out
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn(step_i)
            step_i += 1
        device_fence(out)
        return time.perf_counter() - t0

    k = max(int(iters), 2)
    batches = []
    prev_slope = None
    slope = None
    overhead = 0.0
    rel = float("inf")
    rounds = 0
    fit_ok = False
    last_t2 = last_k = None
    t_begin = time.perf_counter()
    for rounds in range(1, max_rounds + 1):
        t1 = batch(k)
        t2 = batch(3 * k)
        batches += [(k, t1), (3 * k, t2)]
        last_t2, last_k = t2, k
        raw = (t2 - t1) / (2 * k)
        if raw <= 0.0:
            # noise made t2 <= t1: this round proves nothing — discard it
            # and retry with a larger pair
            k *= 2
            if time.perf_counter() - t_begin > max_seconds:
                break
            continue
        overhead = max(t1 - k * raw, 0.0)
        if prev_slope is not None:
            rel = abs(raw - prev_slope) / max(raw, prev_slope)
            if rel <= agree:
                slope = (raw + prev_slope) / 2.0
                fit_ok = True
                break
            k *= 2
        slope = raw
        prev_slope = raw
        if time.perf_counter() - t_begin > max_seconds:
            break
    if slope is None:
        # every round was invalid: the conservative upper bound (it holds
        # the per-batch overhead) rather than a fabricated slope
        slope = last_t2 / (3 * last_k)
    return {
        "step_s": slope,
        "overhead_s": overhead,
        "rel_spread": rel if rel != float("inf") else None,
        "iters": k,
        "rounds": rounds,
        "fit_ok": fit_ok,
        "fenced_batches": batches,
    }


def mrays(n_rays: int, seconds: float) -> float:
    """Primary Mrays/s (the BASELINE.json metric counts primary rays)."""
    return n_rays / max(seconds, 1e-12) / 1e6


def roofline(n_rays: int, bounces: int, n_spheres: int = 8):
    """Back-of-envelope FLOPs/bytes for the sphere megakernel:
    ~14 flops per ray-sphere quadratic + ~30 for shading per bounce;
    memory traffic is 24B in + 12B out per ray (everything else stays on
    chip in the kernel)."""
    flops = n_rays * bounces * (n_spheres * 14 + 30)
    bytes_ = n_rays * (24 + 12)
    return {
        "flops": flops,
        "bytes": bytes_,
        "arithmetic_intensity": flops / bytes_,
    }
