"""The roofline ceiling probes: CUDA wrappers and plain twins.

Counterpart of the three Pallas kernels of ``measure_ceilings`` in
``benchmarks/roofline.py``, which ``utils/roofline.measure_ceilings``
times.  Each wrapper checks its inputs, then:

- for tensors on the CPU, runs its ``*_plain`` twin (plain torch ops
  written from the TPU kernel's semantics);
- for tensors on a CUDA device, launches the hand-written kernel of
  ``csrc/ceiling.cu`` on the current stream, adds one to its entry of
  ``LAUNCHES``, and raises if the launch fails.  There is no fallback.

| wrapper | CUDA kernel | replaces (benchmarks/roofline.py) |
|---|---|---|
| :func:`chain` | ``chain_kernel<Op>`` | ``chain_kernel`` (:76) |
| :func:`copy_scale` | ``copy_kernel`` | ``copy_kernel`` (:185) |
| :func:`read_sum` | ``read_partials_kernel`` + ``read_reduce_kernel`` | ``read_kernel`` (:201) |

The chain: 32 independent streams of a ``[34, ...]`` float32 input, each
taken ``steps`` x ``UNROLL`` times through one op (:data:`OPS`), then
summed in stream order.  The JAX probe runs ``LOOP`` (4,096) trips on a
``[34, 8, 128]`` input; the card's probe runs the same trips on as many
elements as fill the card (:func:`fill_elements`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn
from ascendpathtracing_tpu_torch.ops.render_kernels import on_cpu

STREAMS, UNROLL, LOOP = 32, 8, 4096  # benchmarks/roofline.py:74
BLOCK = 256  # csrc/ceiling.cu kBlock: threads a CTA
#: The chain ops, in csrc/ceiling.cu's order.  ``fma`` is a multiply and an
#: add, unfused, as the port's kernels issue them under -fmad=false;
#: ``fma_fused`` is one fused multiply-add (informational).
OPS = ("mul", "fma", "cmpsel", "mix", "sqrt", "div", "fma_fused")
#: (c, d) of each chain's input (benchmarks/roofline.py:115-128); every
#: stream starts at 1.5, and a row the op does not read stays 1.5.
CHAIN_CD = {"mul": (1.0000001, 1.5), "fma": (0.999, 0.0015), "cmpsel": (1.5, 0.001),
            "mix": (1.001, 1.0), "sqrt": (2.0, 1.5), "div": (2.25, 1.5),
            "fma_fused": (0.999, 0.0015)}
COPY_SCALE = np.float32(1.0000001)  # the HBM copy's factor (roofline.py:186), float32
READ_ROWS, READ_LANES = 8, 128  # the read's output [8, 128]
READ_MAX_CTAS = 128  # CTAs a read output row at most (partials [ctas, 8, 128])

#: Kernel launches per wrapper, counted where the launch succeeded.
LAUNCHES = {"chain": 0, "copy": 0, "read": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/ceiling.cu`` and declares its C interface.
    Checks that the library's compile-time sizes match this module's."""
    lib = build.load("ceiling")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_ceiling_error_string.argtypes = (_I,)
    lib.apt_ceiling_error_string.restype = ctypes.c_char_p
    lib.apt_ceiling_sizes.argtypes = (_P,)
    lib.apt_ceiling_sizes.restype = None
    lib.apt_ceiling_chain_blocks_per_sm.argtypes = (_I, _P)
    lib.apt_ceiling_chain.argtypes = (_I, _P, _P, _N, _I, _P)
    lib.apt_ceiling_copy.argtypes = (_P, _P, _N, ctypes.c_float, _P)
    lib.apt_ceiling_read.argtypes = (_P, _P, _P, _N, _N, _I, _P)
    for name in ("chain_blocks_per_sm", "chain", "copy", "read"):
        getattr(lib, f"apt_ceiling_{name}").restype = _I
    sizes = (ctypes.c_int * 4)()
    lib.apt_ceiling_sizes(sizes)
    if tuple(sizes) != (BLOCK, STREAMS, UNROLL, len(OPS)):
        raise RuntimeError(f"library sizes {tuple(sizes)} != module sizes "
                           f"{(BLOCK, STREAMS, UNROLL, len(OPS))}")
    lib._apt_declared = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.apt_ceiling_error_string(err).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fill_elements(op: str, device) -> int:
    """Chain elements (a thread each) that fill ``device``: every SM at the
    occupancy the chain kernel's registers allow (the CUDA occupancy
    calculator), blocks of ``BLOCK`` threads."""
    lib = load_library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.apt_ceiling_chain_blocks_per_sm(OPS.index(op), ctypes.byref(blocks)),
               "apt_ceiling_chain_blocks_per_sm")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms * BLOCK


# ------------------------------------------------------------ inputs ----
def chain_inputs(op: str, shape=(8, 128), device="cpu") -> torch.Tensor:
    """The chain's input ``[34, *shape]`` float32, as ``run_chain`` builds
    it (roofline.py:116-128): 1.5 everywhere, row 32 c, row 33 d."""
    c, d = CHAIN_CD[op]
    x = np.full((STREAMS + 2, *shape), 1.5, np.float32)
    x[STREAMS], x[STREAMS + 1] = np.float32(c), np.float32(d)
    return torch.tensor(x, device=device)


# ------------------------------------------------------------- twins ----
def _step(op, s, c, d):
    if op == "mul":
        return s * c
    if op == "fma":
        return s * c + d
    if op == "cmpsel":
        return torch.where(s > c, s - d, s + d)
    if op == "mix":
        b = s * c
        return torch.where(b > d, b - d, s + d)
    if op == "sqrt":
        return sqrt_rn(s) * c
    if op == "div":
        return c / s
    # fused: a * c + d rounded once.  A float32 product is exact in
    # float64, and so is the sum where d's exponent lies from 28 below to 4
    # above the product's (the probe's d = 0.0015 lies 10 below a * c ~
    # 1.5): then this is __fmaf_rn's result
    return (s.double() * c.double() + d.double()).float()


def chain_plain(op: str, x: torch.Tensor, steps: int = LOOP) -> torch.Tensor:
    """The chain in plain torch: the 32 streams as one ``[32, ...]``
    tensor, ``steps`` x ``UNROLL`` applications of the op (each element's
    arithmetic as in the kernel), then the streams added in order."""
    s, c, d = x[:STREAMS], x[STREAMS], x[STREAMS + 1]
    for _ in range(steps * UNROLL):
        s = _step(op, s, c, d)
    acc = s[0]
    for j in range(1, STREAMS):
        acc = acc + s[j]
    return acc


def copy_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.0000001`` with the factor a float32 tensor (JAX's weakly
    typed scalar is float32 here)."""
    return x * torch.full((), float(COPY_SCALE), dtype=torch.float32, device=x.device)


def read_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """``[nb, 8, sub] -> [8, 128]``: each block folded ``(8, sub / 128,
    128) -> (8, 128)`` and the blocks added in grid order, as
    ``read_kernel`` accumulates them."""
    nb, rows, sub = x.shape
    acc = x[0].reshape(rows, sub // READ_LANES, READ_LANES).sum(dim=1)
    for b in range(1, nb):
        acc = acc + x[b].reshape(rows, sub // READ_LANES, READ_LANES).sum(dim=1)
    return acc


# ---------------------------------------------------------- wrappers ----
def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def chain(op: str, x: torch.Tensor, steps: int = LOOP) -> torch.Tensor:
    """The op chain of ``x`` [34, ...] float32 -> [...]: ``steps`` trips
    of ``UNROLL`` steps on each of the 32 streams, then their sum."""
    if op not in OPS:
        raise ValueError(f"unknown chain op {op!r}; expected one of {OPS}")
    _check_f32("x", x)
    if x.dim() < 1 or x.shape[0] != STREAMS + 2:
        raise ValueError(f"expected x [{STREAMS + 2}, ...], got {tuple(x.shape)}")
    if not 0 <= steps < 2 ** 31:
        raise ValueError(f"steps must be in [0, 2^31), got {steps}")
    if on_cpu(x):
        return chain_plain(op, x, steps)
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.apt_ceiling_chain(OPS.index(op), x.data_ptr(), out.data_ptr(), out.numel(),
                                    steps, _stream(x))
    _check(lib, err, f"apt_ceiling_chain({op})")
    LAUNCHES["chain"] += 1
    return out


def copy_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.0000001`` (float32, any shape with a multiple of 4
    elements), read and written once."""
    _check_f32("x", x)
    if x.numel() % 4:
        raise ValueError(f"x must hold a multiple of 4 elements, got {x.numel()}")
    if on_cpu(x):
        return copy_scale_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.apt_ceiling_copy(x.data_ptr(), y.data_ptr(), x.numel(),
                                   float(COPY_SCALE), _stream(x))
    _check(lib, err, "apt_ceiling_copy")
    LAUNCHES["copy"] += 1
    return y


def read_ctas(x: torch.Tensor) -> int:
    """CTAs a read output row: one per 512 rows of 512 bytes, 1 to
    ``READ_MAX_CTAS``."""
    rows = x.shape[0] * (x.shape[2] // READ_LANES)
    return max(1, min(READ_MAX_CTAS, rows // 512))


def read_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` [nb, 8, sub] float32 (sub a multiple of 128) -> [8, 128]:
    ``out[r, l]`` the sum over b and k of ``x[b, r, k * 128 + l]``."""
    _check_f32("x", x)
    if (x.dim() != 3 or x.shape[0] < 1 or x.shape[1] != READ_ROWS
            or x.shape[2] < READ_LANES or x.shape[2] % READ_LANES):
        raise ValueError(f"expected x [nb, {READ_ROWS}, k * {READ_LANES}], got {tuple(x.shape)}")
    if on_cpu(x):
        return read_sum_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    ctas = read_ctas(x)
    partials = torch.empty((ctas, READ_ROWS, READ_LANES), dtype=torch.float32, device=x.device)
    out = torch.empty((READ_ROWS, READ_LANES), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.apt_ceiling_read(x.data_ptr(), partials.data_ptr(), out.data_ptr(),
                                   x.shape[0], x.shape[2], ctas, _stream(x))
    _check(lib, err, "apt_ceiling_read")
    LAUNCHES["read"] += 1
    return out
