"""Debug guards and host dumps: the port of
``ascendpathtracing_tpu/utils/debug.py``.

- :func:`print_data` is the typed host dump (``PrintData``), on tensors
  or arrays, with the JAX package's text.
- :func:`assert_finite` is the host post-condition; it raises
  :class:`NonFiniteRenderError`.
- :func:`checkify_render` stands in for ``jax.experimental.checkify``'s
  float checks: torch has no checkify, so it runs the render under a
  ``TorchDispatchMode`` that checks the floating outputs of every aten op
  and raises at the first NaN or inf.
- ``kernel_dump`` (a ``pl.debug_print`` gated to grid cell 0) has no
  function here: its counterpart is the ``debug`` option of the kernels
  that had one, whose CUDA instantiations print with device ``printf``
  (``ops/pt_kernels.render_pt``, ``ops/wbvh_kernels.intersect_chunks``,
  ``ops/mesh_pt_kernels.render_pt_mesh``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def print_data(name: str, x, *, max_items: int = 16, file=None) -> str:
    """Typed host dump of a tensor or array: dtype, shape, min/max/mean,
    finite count, and the first ``max_items`` values.  Returns the
    formatted string (and prints it to ``file``/stderr)."""
    arr = _numpy(x)
    flat = arr.reshape(-1)
    head = ", ".join(f"{v:.6g}" for v in flat[:max_items].astype(np.float64))
    if flat.size > max_items:
        head += ", ..."
    finite = int(np.isfinite(flat.astype(np.float64)).sum()) if flat.size else 0
    stats = ""
    if flat.size and np.issubdtype(arr.dtype, np.number):
        f64 = flat.astype(np.float64)
        stats = (f" min={np.nanmin(f64):.6g} max={np.nanmax(f64):.6g}"
                 f" mean={np.nanmean(f64):.6g}")
    msg = (f"[dump] {name}: dtype={arr.dtype} shape={arr.shape}"
           f" finite={finite}/{flat.size}{stats}\n        [{head}]")
    print(msg, file=file or sys.stderr)
    return msg


class NonFiniteRenderError(RuntimeError):
    pass


def assert_finite(x, name="output"):
    """Host-side post-condition; raises with basic stats on failure."""
    arr = _numpy(x)
    bad = ~np.isfinite(arr)
    if bad.any():
        raise NonFiniteRenderError(
            f"{name}: {bad.sum()} non-finite of {arr.size} "
            f"(nan={np.isnan(arr).sum()}, inf={np.isinf(arr).sum()})"
        )
    return x


class _FloatGuard(TorchDispatchMode):
    """Raises at the first aten op whose floating output holds a NaN or
    an inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise NonFiniteRenderError(
                    f"{func}: {int((~torch.isfinite(t)).sum())} non-finite of "
                    f"{t.numel()} (nan={int(torch.isnan(t).sum())}, "
                    f"inf={int(torch.isinf(t).sum())})"
                )
        return out


def checkify_render(fn):
    """Wrap a render function so that a NaN or inf made by any torch op
    inside it raises :class:`NonFiniteRenderError` where it appears,
    instead of propagating silently.  Returns wrapped(fn) -> output."""

    def run(*args, **kwargs):
        with _FloatGuard():
            return fn(*args, **kwargs)

    return run
