"""A kernel's share of its roofline.

``perfbench/roofline/<kernel>.py`` defines ``work(ctx) -> (operations,
bytes)`` for one call of the kernel at the cell's inputs, from the
inputs' sizes and the reference's counts (never the program's).  The
bound is the larger of operations over the float32 peak and bytes over
the HBM peak (``peaks.json``); the share is the bound over the kernel's
device seconds a call in the traced stretch of the window.

The hand model charges operations as the program's card checks do: 20
a ray-sphere test, 30 a reference-mode bounce's shading, 60 a live
path-tracing bounce's shading, 40 a camera ray, 30 a ray-triangle test;
each input byte is read once and each output byte written once.
"""

from __future__ import annotations

import json
from pathlib import Path

from perfbench import trace

SPHERE_OPS, REF_SHADE_OPS, PT_SHADE_OPS, CAMERA_OPS, TRIANGLE_OPS = 20, 30, 60, 40, 30


def peaks() -> dict:
    return json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes": the term that binds)."""
    pk = peaks()
    o, b = ops / pk["fp32_ops_per_s"], nbytes / pk["hbm_bytes_per_s"]
    return (o, "operations") if o >= b else (b, "bytes")


def kernel_seconds(ctx: dict, names) -> float | None:
    """Device seconds a call of the ``csrc/`` kernels ``names`` in the
    traced stretch (one call an iteration), or None where none ran."""
    tr = ctx.get("trace") or {}
    total = sum(b - a for n, a, b in tr.get("device_events", ())
                if trace.csrc_kernel(n) in names)
    if not total or not tr.get("iterations"):
        return None
    return total / tr["iterations"]


def share(ctx: dict, kernel: str, names) -> float | None:
    """100 x bound / device seconds a call, or None where the kernel did
    not run in the traced stretch."""
    from perfbench.harness import load_by_path

    t = kernel_seconds(ctx, names)
    if t is None:
        return None
    ops, nbytes = load_by_path("roofline", kernel).work(ctx)
    return 100.0 * bound_s(ops, nbytes)[0] / t
