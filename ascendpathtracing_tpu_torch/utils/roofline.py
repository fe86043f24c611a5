"""Mechanical op accounting of eager torch code (roofline inputs).

Counterpart of ``ascendpathtracing_tpu/utils/roofline.py``'s ``OpCounts``
and ``count_ops``.  The JAX module walks the jaxpr that is compiled; here
a ``TorchDispatchMode`` sees every aten op that ``fn(*args, **kwargs)``
executes — the forward, and the backward when ``fn`` runs one — and
classes it by its overload packet's name into the JAX module's classes:

- ``flops``      — one-slot vector arithmetic (add/mul/sub/maximum/…),
                   one per output element.
- ``hard``       — multi-cycle ops (div, sqrt, exp, log, sin/cos, pow…),
                   one per output element, also by name in
                   ``hard_by_prim``.
- ``vops``       — non-arithmetic element ops: compares, selects
                   (``where``), boolean and bit algebra, dtype converts,
                   random draws.
- ``mxu_flops``  — matrix products (``mm``, ``bmm``, ``addmm``, ``matmul``
                   and their kin): 2·B·M·N·K.
- ``mem_elems``  — layout, copy, gather and scatter work and the tensors
                   that factory ops fill, by output elements.  Unlike
                   JAX's ``copy`` (an arithmetic op there), torch's
                   ``clone``/``copy_`` are layout moves and land here.
- reductions (sum, amax, argmin, cumsum, …) count their INPUT elements
  as ``flops``, as in JAX.
- in-place variants (``add_``) count like their out-of-place ops.
- anything unclassified lands in ``other``, by name.

The counts become time bounds with the card's measured ceilings:
:func:`measure_ceilings` (the port of ``benchmarks/roofline.
measure_ceilings``) times the probe kernels of ``csrc/ceiling.cu`` on the
card, and :func:`bound` (the port of ``benchmarks/roofline._bound_row``'s
bound composition) divides counts and bytes by them.

What eager torch changes: every Python loop runs at its real trip count,
so there is nothing to assign — JAX's ``while_trips``,
``default_while_trips``, ``whiles``, ``dma_bytes`` and the ``pallas_call``
grid multiplier have no counterpart here.  The count is that of these
inputs: a twin that masks dead rays counts them, one that compacts them
does not.

The hand-written CUDA kernels launch through ctypes, so the mode sees
only their torch glue.  A kernel's count is its plain twin's count at the
kernel's inputs: count the ``*_plain`` function.  On the CPU,
``ops.intersect.sqrt_rn`` runs NumPy behind the custom op
``aptport::sqrt_rn``; it counts as one ``sqrt`` per element, as
``torch.sqrt`` does on a card, so the count of a twin is the same on
every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# one-slot vector arithmetic: op -> flops per output element (a cross
# product's component is two multiplies and a subtract)
_FLOPS = dict.fromkeys((
    "add", "sub", "rsub", "mul", "maximum", "minimum", "fmax", "fmin", "neg",
    "abs", "sign", "sgn", "floor", "ceil", "round", "trunc", "frac",
    "nextafter", "copysign"), 1) | {"linalg_cross": 3}
# multi-cycle ops; the name each counts under in ``hard_by_prim``
_HARD = {
    "div": "div", "sqrt": "sqrt", "sqrt_rn": "sqrt", "rsqrt": "rsqrt",
    "reciprocal": "reciprocal", "exp": "exp", "exp2": "exp2", "expm1": "expm1",
    "log": "log", "log1p": "log1p", "log2": "log2", "log10": "log10", "sin": "sin",
    "cos": "cos", "tan": "tan", "asin": "asin", "acos": "acos", "atan": "atan",
    "atan2": "atan2", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "erf": "erf",
    "erfc": "erfc", "erfinv": "erfinv", "sigmoid": "logistic", "pow": "pow",
    "remainder": "rem", "fmod": "rem", "floor_divide": "div", "lgamma": "lgamma",
    "digamma": "digamma",
}
# non-arithmetic element ops
_VOPS = {
    "lt", "le", "gt", "ge", "eq", "ne", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift", "__and__",
    "__or__", "__xor__", "__lshift__", "__rshift__", "__ilshift__",
    "__irshift__", "__iand__", "__ior__", "__ixor__", "where", "isfinite",
    "isnan", "isinf", "signbit", "clamp", "clamp_min", "clamp_max",
    "masked_fill", "rand", "randn", "randint", "rand_like", "randn_like",
    "uniform", "normal", "bernoulli", "random",
}
# layout / memory movement / factories
_MEM = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "slice", "select", "squeeze", "unsqueeze", "cat",
    "stack", "constant_pad_nd", "flip", "arange", "linspace", "index",
    "index_select", "gather", "scatter", "scatter_add", "scatter_reduce",
    "index_put", "_index_put_impl", "index_add", "index_copy", "index_fill",
    "masked_scatter", "masked_select", "nonzero", "take", "empty",
    "empty_strided", "empty_like", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "fill", "zero", "new_zeros", "new_empty", "new_ones",
    "new_full", "new_empty_strided", "as_strided", "split", "split_with_sizes",
    "unbind", "narrow", "diagonal", "repeat", "repeat_interleave", "roll",
    "unfold", "alias", "lift_fresh", "lift_fresh_copy", "clone", "copy",
    "contiguous", "scalar_tensor", "view_as_real", "view_as_complex",
    "slice_scatter", "select_scatter", "as_strided_scatter",
    # autograd's backward of views: the gradient placed into zeros
    "select_backward", "slice_backward", "index_select_backward",
    "diagonal_backward", "unfold_backward",
}
# reductions: count input elements as flops (a tree of adds/compares)
_REDUCE = {
    "sum", "mean", "amax", "amin", "aminmax", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "any", "all",
    "logsumexp", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "nansum", "count_nonzero",
}
# matrix products -> mxu_flops
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "vdot", "matmul"}
_ZERO_COST = {
    "detach", "_local_scalar_dense", "item", "is_nonzero", "set", "resize",
    "record_stream", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "_assert_async", "_assert_scalar",
    "_functional_assert_async", "_has_compatible_shallow_copy_type",
}


@dataclasses.dataclass
class OpCounts:
    flops: float = 0.0
    hard: float = 0.0
    vops: float = 0.0
    mxu_flops: float = 0.0
    mem_elems: float = 0.0
    hard_by_prim: dict = dataclasses.field(default_factory=dict)
    other: dict = dataclasses.field(default_factory=dict)

    @property
    def vpu_slots(self) -> float:
        """Element ops (flops + hard + vops; the JAX module's name, after
        the TPU's vector unit).  ``hard`` costs more than one issue slot
        on any device: weigh it when turning counts into time bounds."""
        return self.flops + self.hard + self.vops

    def as_dict(self):
        return {
            "flops": self.flops,
            "hard": self.hard,
            "vops": self.vops,
            "vpu_slots": self.vpu_slots,
            "mxu_flops": self.mxu_flops,
            "mem_elems": self.mem_elems,
            "hard_by_prim": dict(self.hard_by_prim),
            "other": dict(self.other),
        }


def _numel(tree) -> int:
    return sum(x.numel() for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor))


def _matmul_flops(name: str, args) -> float:
    """2·B·M·N·K: twice the output's elements times the contracted size
    (``addbmm`` also sums its B products into one [M, N])."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addbmm", "addmv") else args[:2]
    m = a.shape[-2] if a.dim() >= 2 else 1
    n = b.shape[-1] if b.dim() >= 2 else 1
    batch = a.shape[0] if name == "addbmm" else math.prod(torch.broadcast_shapes(
        a.shape[:-2], b.shape[:-2]))
    return 2.0 * batch * m * n * a.shape[-1]


def _classify(counts: OpCounts, func, args, kwargs, out) -> None:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # in place: as its out-of-place op
    if name in ("max", "min"):  # binary with another tensor, else a reduction
        if func._overloadname == "other":
            counts.flops += _numel(out)
        else:
            counts.flops += _numel((args, kwargs))
    elif name == "_to_copy":  # a dtype convert, or a copy to a device
        src = args[0]
        converts = kwargs.get("dtype") not in (None, src.dtype)
        if converts:
            counts.vops += _numel(out)
        else:
            counts.mem_elems += _numel(out)
    elif name in _MATMUL:
        counts.mxu_flops += _matmul_flops(name, args)
    elif name in _REDUCE:
        counts.flops += _numel((args, kwargs))
    elif name in _FLOPS:
        counts.flops += _FLOPS[name] * _numel(out)
    elif name in _HARD:
        e = _numel(out)
        key = _HARD[name]
        counts.hard += e
        counts.hard_by_prim[key] = counts.hard_by_prim.get(key, 0.0) + e
    elif name in _VOPS:
        counts.vops += _numel(out)
    elif name in _MEM:
        counts.mem_elems += _numel(out)
    elif name not in _ZERO_COST:
        counts.other[name] = counts.other.get(name, 0.0) + _numel(out)


class _Counter(TorchDispatchMode):
    def __init__(self, counts: OpCounts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        _classify(self.counts, func, args, kwargs, out)
        return out


def count_ops(fn: Callable, *args, **kwargs) -> OpCounts:
    """Count the element ops of ``fn(*args, **kwargs)`` as it runs (on
    whatever device its tensors are; the backward too, where ``fn``
    calls ``backward`` or ``torch.autograd.grad``: the autograd engine
    carries the mode to the thread that runs a card's backward)."""
    counts = OpCounts()
    with _Counter(counts):
        fn(*args, **kwargs)
    return counts


# ------------------------------------------------------------ ceilings --
#: The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).
DATASHEET_H100 = {"hbm_gb_per_s": 3350, "fp32_tflops": 67}
# Elementwise ops a chain step counts (benchmarks/roofline.py:154-179):
# the fma's multiply and add, cmpsel's compare, select, subtract and add,
# mix's multiply besides those; sqrt is a sqrt and a multiply, div one
# division, and the fused multiply-add two flops in one instruction.
_CHAIN_SLOTS = {"mul": 1, "fma": 2, "cmpsel": 4, "mix": 5, "sqrt": 2, "div": 1,
                "fma_fused": 2}
# benchmark_fit's limit a probe (a round may run past it), and the least
# seconds of its smaller batch: a 0.2 ms copy needs hundreds of launches
# a batch before host jitter is small beside the batch
_PROBE_SECONDS, _MIN_BATCH_SECONDS = 4.0, 0.05


def _fit_fields(fit) -> dict:
    return {"fit_ok": fit["fit_ok"], "fit_rel_spread": fit["rel_spread"],
            "fit_iters": fit["iters"], "fit_rounds": fit["rounds"]}


def measure_ceilings(device="cuda", iters: int = 6) -> dict:
    """The card's measured ceilings, the keys of ``benchmarks/roofline.
    measure_ceilings``: each chain of ``csrc/ceiling.cu`` (mul, mix, fma,
    cmpsel, sqrt, div; and the fused multiply-add, informational) over
    every element that fills the card, ``ops.ceiling_kernels.LOOP`` trips
    of 8 x 32 steps, and the HBM copy and read of a [128, 8, 65536]
    float32 array (256 MB, five times the 50 MB L2).

    Each probe is timed by ``utils/profiling.benchmark_fit`` in batches of
    at least ``iters`` launches and at least 50 ms (one launch timed by
    CUDA events sets the count), for at most about 4 s a probe.
    ``r_issue_gslots`` is the best issue rate (element op slots a second:
    JAX's ops, which nvcc may merge into fewer instructions) among the
    fit-validated chains mix, fma and cmpsel; ``mul`` stays informational
    as in JAX, and so does the fused multiply-add, which counts two flops
    in one instruction.  sqrt's and div's weights are in those slots.
    ``model`` holds what :func:`bound` takes, and ``r_insn_ginsns``, the
    instruction rate of the unfused fma chain (two instructions a step),
    beside ``r_issue_gslots``.  Raises unless ``device`` is a CUDA card."""
    from ascendpathtracing_tpu_torch.device import resolve_device
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck
    from ascendpathtracing_tpu_torch.utils import profiling

    if not isinstance(device, torch.device):
        device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_ceilings measures a CUDA card, not {device}")

    def timed(fn):
        fn(0)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(0)
        e1.record()
        e1.synchronize()
        one_s = e0.elapsed_time(e1) / 1e3
        k = max(iters, math.ceil(_MIN_BATCH_SECONDS / max(one_s, 1e-9)))
        return profiling.benchmark_fit(fn, iters=k, max_seconds=_PROBE_SECONDS)

    def run_chain(op):
        n = ck.fill_elements(op, device)
        x = ck.chain_inputs(op, (n,), device)
        fit = timed(lambda i: ck.chain(op, x, ck.LOOP))
        elems = ck.STREAMS * ck.LOOP * ck.UNROLL * n
        row = {"step_ms": fit["step_s"] * 1e3, "chain_elem_iters": elems, "elements": n,
               **_fit_fields(fit)}
        return row, elems / fit["step_s"], fit["fit_ok"]

    out = {}
    row, rate, _ = run_chain("mul")
    out["vpu_mul"] = {**row, "gelems_per_s": rate / 1e9,
                      "note": "informational, as in JAX (where the unrolled mul "
                              "chain reassociated); the ceiling comes from the "
                              "chains below"}
    candidates = []
    for op, key, unit in (("mix", "vpu_mix", "gslots_per_s"), ("fma", "vpu_fma", "gflops"),
                          ("cmpsel", "vpu_cmpsel", "gslots_per_s")):
        row, rate, ok = run_chain(op)
        out[key] = {**row, unit: _CHAIN_SLOTS[op] * rate / 1e9}
        if ok:
            candidates.append(_CHAIN_SLOTS[op] * rate)
    r_issue = max(candidates) if candidates else _CHAIN_SLOTS["cmpsel"] * rate
    out["r_issue_gslots"] = r_issue / 1e9

    row, sqrt_rate, _ = run_chain("sqrt")  # a sqrt and a multiply per step
    w_sqrt = max(r_issue / sqrt_rate - 1.0, 1.0)
    out["vpu_sqrt"] = {**row, "weight_in_slots": w_sqrt}
    row, div_rate, _ = run_chain("div")
    w_div = max(r_issue / div_rate, 1.0)
    out["vpu_div"] = {**row, "weight_in_slots": w_div}
    row, rate, _ = run_chain("fma_fused")
    out["vpu_fma_fused"] = {**row, "gflops": 2 * rate / 1e9,
                            "note": "informational: one FFMA counted as two flops; "
                                    "-fmad=false keeps the port's kernels from it"}

    nb, sub = 128, 65536  # 128 x 2 MB blocks = 256 MB (roofline.py:182)
    big = torch.ones((nb, 8, sub), dtype=torch.float32, device=device)
    nbytes = big.numel() * 4
    fit = timed(lambda i: ck.copy_scale(big))
    bw_copy = 2 * nbytes / fit["step_s"]
    out["hbm_copy"] = {"gb_per_s": bw_copy / 1e9, "bytes": 2 * nbytes,
                       "step_ms": fit["step_s"] * 1e3, **_fit_fields(fit)}
    fit = timed(lambda i: ck.read_sum(big))
    bw_read = nbytes / fit["step_s"]
    out["hbm_read"] = {"gb_per_s": bw_read / 1e9, "bytes": nbytes,
                       "step_ms": fit["step_s"] * 1e3, **_fit_fields(fit)}
    del big

    out["datasheet_h100"] = {**DATASHEET_H100,
                             "note": "NVIDIA's published H100 SXM figures, for reference "
                                     "only: bounds use the MEASURED ceilings"}
    # The unfused fma chain issues an FMUL and an FADD a step, so its slot
    # rate is the card's FP32 instruction rate.  r_issue counts JAX's
    # nominal slots, which nvcc may issue as fewer instructions (mix's
    # five as four), so it can stand above that rate: it prices JAX's
    # counts, and is no plain peak of the card.
    out["model"] = {"r_issue_gslots": r_issue / 1e9, "w_hard_sqrt": w_sqrt,
                    "w_hard_div": w_div, "bw_gb_per_s": bw_copy / 1e9,
                    "bw_read_gb_per_s": bw_read / 1e9,
                    "r_insn_ginsns": out["vpu_fma"]["gflops"]}
    out["device"] = {"name": torch.cuda.get_device_name(device),
                     "sms": torch.cuda.get_device_properties(device).multi_processor_count,
                     "chain_trips": ck.LOOP, "unroll": ck.UNROLL, "streams": ck.STREAMS}
    return out


def bound(counts: OpCounts, bytes_hbm: float, model: dict, dma_bytes: float = 0.0) -> dict:
    """Time lower bounds of ``counts`` and ``bytes_hbm`` at the measured
    ceilings ``model`` (``measure_ceilings()["model"]``), the composition
    of ``benchmarks/roofline._bound_row``: issue slots (flops + vops + each
    hard op at its weight: sqrt, rsqrt and cbrt at sqrt's, div and rem at
    div's, any other at the smaller of the two) over ``r_issue``, bytes and
    ``dma_bytes`` over the copy bandwidth.  -> ms of each ("vpu", "hbm",
    "dma"), ``bound_ms`` (the largest), ``binding`` (its name) and
    ``eff_slots``."""
    r_issue = model["r_issue_gslots"] * 1e9
    w_sqrt, w_div = model["w_hard_sqrt"], model["w_hard_div"]
    w_min = min(w_sqrt, w_div)
    hard_eff = 0.0
    for prim, e in counts.hard_by_prim.items():
        if prim in ("sqrt", "rsqrt", "cbrt"):
            hard_eff += e * w_sqrt
        elif prim in ("div", "rem"):
            hard_eff += e * w_div
        else:
            hard_eff += e * w_min
    slots = counts.flops + counts.vops + hard_eff
    bw = model["bw_gb_per_s"] * 1e9
    t = {"vpu": slots / r_issue * 1e3, "hbm": bytes_hbm / bw * 1e3, "dma": dma_bytes / bw * 1e3}
    bound_ms = max(t.values())
    binding = "vpu" if bound_ms == t["vpu"] else ("hbm" if bound_ms == t["hbm"] else "dma")
    return {**t, "bound_ms": bound_ms, "binding": binding, "eff_slots": slots}
