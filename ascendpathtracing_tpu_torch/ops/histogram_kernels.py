"""The segment-sum: CUDA wrapper, plain twins and launch count.

Counterpart of ``ascendpathtracing_tpu/ops/pallas_histogram.py``: its two
TPU kernels, ``_paged_kernel`` (``segment_rows_paged``) and
``_hist_kernel`` (``segment_rows_matmul``), share one contract,

    acc[s, r] = sum of vals[r, n] over seg[n] == s,   0 <= s < n_slots,

for seg [N] int32 and vals [R <= 8, N]; ids outside [0, n_slots) are
dropped.  One Hopper kernel (``csrc/segsum.cu``) serves both wrappers,
which keep the JAX names and signatures:

- for tensors on the CPU they run the plain twins
  :func:`segment_rows_plain` (``index_add_``) and :func:`occupancy_plain`;
- for tensors on a CUDA device they launch ``segsum_kernel`` on the
  current stream, add one to ``LAUNCHES["segsum"]``, and raise if the
  launch fails.  There is no fallback.

``segment_rows_paged`` also returns ``kocc``: for each block of
``sample_block`` rows, the number of distinct slot blocks ``seg >>
log2(slot_block)`` in ``[0, ceil(n_slots / slot_block))`` that it touches
-- the TPU kernel's occupancy count, the same value.  Both wrappers take
an ``out=`` accumulator [n_slots, R] that the kernel adds into, so a
chunked caller makes one accumulator.  float32 (the TPU contract) and
float64 rows are taken.  The kernel sums in float64 for both (a float32
running sum of the replay's tens of thousands of per-tile partials
drifts by ~1e-5 relative).  So ``out`` is float64 whatever the rows'
dtype; without one, the wrappers accumulate into a float64 tensor of
their own and return the sums in the dtype of ``vals``.

The accumulator lives in device memory, so the port has no counterpart of
the TPU's 8 MB VMEM ceiling: no ``_PAGED_MAX_SLOTS`` and no scatter
fallback beyond it.  The kernel's occupancy flags (one bit per slot
block) are in shared memory, which bounds ``n_slots`` to 131,072 slot
blocks (16.7M slots at ``slot_block`` 128).  The kernel's sums repeat
bit for bit on the same inputs and card (no atomics: a sort of each
2048-row tile by slot, fixed-order scans, per-CTA float64 accumulators in
scratch the wrapper allocates, summed in CTA order); they equal the twins'
``index_add_`` to rounding.
"""

from __future__ import annotations

import ctypes

import torch

from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.ops.render_kernels import on_cpu

MAX_ROWS = 8  # R <= 8, the TPU kernel's sublane block
MAX_SLOT_BLOCKS = 4096 * 32  # csrc/segsum.cu MAX_FLAG_WORDS * 32

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"segsum": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = (_P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P, _I, _P)


def reset_launches() -> None:
    LAUNCHES["segsum"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/segsum.cu`` and declares its C interface."""
    lib = build.load("segsum")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_segsum_error_string.argtypes = (_I,)
    lib.apt_segsum_error_string.restype = ctypes.c_char_p
    lib.apt_segsum_groups.argtypes = (ctypes.c_longlong, _I, _I)
    lib.apt_segsum_groups.restype = _I
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"apt_segsum_{suffix}")
        fn.argtypes = _SIGNATURE
        fn.restype = _I
    lib._apt_declared = True
    return lib


def _blocks(n: int, block: int) -> int:
    return -(-n // block)


def _check(seg, vals, n_slots, slot_block, sample_block, out):
    if seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32, got {seg.dtype}")
    if vals.dtype not in _DTYPES:
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if seg.dim() != 1 or vals.dim() != 2 or vals.shape[1] != seg.shape[0]:
        raise ValueError(f"expected seg [N] and vals [R, N], got {tuple(seg.shape)} "
                         f"and {tuple(vals.shape)}")
    r = vals.shape[0]
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"R must be 1..{MAX_ROWS} (one sublane block), got {r}")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    if slot_block < 1 or slot_block & (slot_block - 1):
        raise ValueError("slot_block must be a power of two")
    if _blocks(n_slots, slot_block) > MAX_SLOT_BLOCKS:
        raise ValueError(f"{n_slots} slots make more than {MAX_SLOT_BLOCKS} slot blocks "
                         f"of {slot_block}")
    if sample_block < 32 or sample_block % 32:
        raise ValueError(f"sample_block must be a positive multiple of 32, got {sample_block}")
    if not (seg.is_contiguous() and vals.is_contiguous()):
        raise ValueError("seg and vals must be contiguous")
    if out is not None and (tuple(out.shape) != (n_slots, r) or out.dtype != torch.float64
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{n_slots}, {r}] float64 tensor")
    acc = torch.zeros((n_slots, r), dtype=torch.float64, device=vals.device) if out is None else out
    return acc, on_cpu(seg, vals, acc)


def _result(acc, vals, out):
    """The sums: ``out`` itself, or the wrapper's own float64 accumulator in
    the dtype of ``vals``."""
    return acc if out is not None else acc.to(vals.dtype)


# ------------------------------------------------------- plain twins ----
def segment_rows_plain(seg, vals, *, n_slots, out=None):
    """Plain twin of the segment-sum: ``index_add_`` of the in-range rows
    into ``out`` (zeros [n_slots, R] in the dtype of ``vals`` when None),
    in ``out``'s dtype -> ``out``."""
    if out is None:
        out = torch.zeros((n_slots, vals.shape[0]), dtype=vals.dtype, device=vals.device)
    keep = (seg >= 0) & (seg < n_slots)
    return out.index_add_(0, seg[keep].long(), vals[:, keep].T.to(out.dtype))


def occupancy_plain(seg, *, n_slots, slot_block=128, sample_block=2048):
    """Plain twin of ``kocc``: per block of ``sample_block`` rows, the
    number of distinct slot blocks in [0, ceil(n_slots / slot_block))
    that ``seg >> log2(slot_block)`` touches -> int32
    [ceil(N / sample_block)]."""
    n = seg.shape[0]
    n_sb, n_jb = _blocks(n, sample_block), _blocks(n_slots, slot_block)
    coarse = seg.long() >> (slot_block.bit_length() - 1)
    blk = torch.arange(n, device=seg.device) // sample_block
    ok = (coarse >= 0) & (coarse < n_jb)
    keys = torch.unique(blk[ok] * n_jb + coarse[ok])
    return torch.bincount(keys // n_jb, minlength=n_sb).to(torch.int32)


# ---------------------------------------------------------- wrappers ----
def _launch(seg, vals, acc, kocc, *, n_slots, slot_block, sample_block):
    """Launches the kernels, adding into the float64 ``acc``; the per-CTA
    accumulators are scratch of ``apt_segsum_groups`` x [n_slots, R]."""
    lib = load_library()
    n, r = seg.shape[0], vals.shape[0]
    with torch.cuda.device(acc.device):
        groups = lib.apt_segsum_groups(n, r, n_slots)
        part = torch.empty((groups * n_slots * r,), dtype=torch.float64, device=acc.device)
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = getattr(lib, f"apt_segsum_{_DTYPES[vals.dtype]}")(
            seg.data_ptr(), vals.data_ptr(), n, r, n_slots, slot_block, sample_block,
            acc.data_ptr(), None if kocc is None else kocc.data_ptr(),
            part.data_ptr() if groups else None, groups, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"apt_segsum: CUDA error {err} ({lib.apt_segsum_error_string(err).decode()})"
        )
    LAUNCHES["segsum"] += 1


def segment_rows_paged(seg, vals, *, n_slots, slot_block=128, sample_block=2048,
                       out=None):
    """Occupancy-gated segment-sum (``_paged_kernel``'s contract) ->
    (sums [n_slots, R] added into ``out``, kocc int32
    [ceil(N / sample_block)])."""
    acc, cpu = _check(seg, vals, n_slots, slot_block, sample_block, out)
    if cpu:
        kocc = occupancy_plain(seg, n_slots=n_slots, slot_block=slot_block,
                               sample_block=sample_block)
        segment_rows_plain(seg, vals, n_slots=n_slots, out=acc)
    else:
        kocc = torch.empty((_blocks(seg.shape[0], sample_block),), dtype=torch.int32,
                           device=seg.device)
        _launch(seg, vals, acc, kocc, n_slots=n_slots, slot_block=slot_block,
                sample_block=sample_block)
    return _result(acc, vals, out), kocc


def segment_rows_matmul(seg, vals, *, n_slots, slot_block=512, sample_block=2048,
                        out=None):
    """Dense segment-sum (``_hist_kernel``'s contract) -> sums [n_slots,
    R] added into ``out``.  The same kernel as :func:`segment_rows_paged`,
    without the occupancy output."""
    acc, cpu = _check(seg, vals, n_slots, slot_block, sample_block, out)
    if cpu:
        segment_rows_plain(seg, vals, n_slots=n_slots, out=acc)
    else:
        _launch(seg, vals, acc, None, n_slots=n_slots, slot_block=slot_block,
                sample_block=sample_block)
    return _result(acc, vals, out)
