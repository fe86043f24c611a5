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
| :func:`read_sum` | ``read_kernel`` | ``read_kernel`` (:201) |

The chain: 32 independent streams of a ``[34, ...]`` float32 input, each
taken ``steps`` x ``UNROLL`` times through one op (:data:`OPS`), then
summed in stream order.  The JAX probe runs ``LOOP`` (4,096) trips on a
``[34, 8, 128]`` input; the card's probe runs the same trips on as many
elements as fill the card (:func:`fill_elements`).

The read is one launch over a persistent grid (:func:`read_grid`), each
CTA a contiguous share of the input's 512-byte rows (:func:`read_shares`);
the CTAs' partials are added in a fixed order by the CTAs that complete
each (range of CTAs, output row) and then each output row, counted by
int32 tickets (:func:`read_sum_ordered` models that order,
:func:`read_chain` gives its longest chain of additions).  Its scratch
and tickets are kept for each (device, stream), so calls on two streams
share nothing.  It is launched so that a read queued behind another read
starts while the first one's last sums finish (csrc/ceiling.cu's note).
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
WARPS = BLOCK // 32  # warps a CTA
#: The read's reduction: 8 ranges of CTAs, a warp a sub-range of at most
#: 16 CTAs of each, so at most 8 x 8 x 16 CTAs; its tickets, int32: one a
#: (range, output row), then one an output row.
READ_RANGES, READ_MAX_CTAS = 8, 1024
READ_TICKETS = READ_RANGES * READ_ROWS + READ_ROWS

#: Kernel launches per wrapper, counted where the launch succeeded.
LAUNCHES = {"chain": 0, "copy": 0, "read": 0}

_READ_GRID: dict = {}  # device -> CTAs of the read's persistent grid
#: (device, stream) -> the read's partials [ctas, 8, 128], range sums [8,
#: 8, 128] and tickets [READ_TICKETS]
_READ_SCRATCH: dict = {}

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
    lib.apt_ceiling_read_grid.argtypes = (_P,)
    lib.apt_ceiling_read.argtypes = (_P, _P, _P, _P, _P, _N, _N, _I, _P)
    for name in ("chain_blocks_per_sm", "chain", "copy", "read_grid", "read"):
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


def read_grid(device) -> int:
    """CTAs of the read's persistent grid on ``device``: every SM at the
    occupancy of the read kernel (the CUDA occupancy calculator), at most
    ``READ_MAX_CTAS``."""
    device = torch.device(device)
    if device not in _READ_GRID:
        lib = load_library()
        grid = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            _check(lib, lib.apt_ceiling_read_grid(grid), "apt_ceiling_read_grid")
        if (grid[1], grid[2]) != (READ_MAX_CTAS, READ_TICKETS):
            raise RuntimeError(f"library read sizes {tuple(grid[1:])} != module sizes "
                               f"{(READ_MAX_CTAS, READ_TICKETS)}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _READ_GRID[device] = min(grid[0] * sms, READ_MAX_CTAS)
    return _READ_GRID[device]


# ------------------------------------------------- the read's order ----
def read_shares(rows: int, ctas: int) -> np.ndarray:
    """The read's split of ``rows`` 512-byte rows over ``ctas`` CTAs, as
    ``read_kernel`` computes it: CTA c takes rows [c * base + min(c, rem),
    (c + 1) * base + min(c + 1, rem)) with base, rem = divmod(rows, ctas),
    so contiguous shares in CTA order of ``base`` or ``base + 1`` rows.
    -> int64 [ctas, 2] of (start, stop)."""
    base, rem = divmod(rows, ctas)
    c = np.arange(ctas + 1, dtype=np.int64)
    edges = c * base + np.minimum(c, rem)
    return np.stack([edges[:-1], edges[1:]], axis=1)


def read_touched(start: int, stop: int, k_rows: int) -> int:
    """The output rows that rows [start, stop) add into, a bit each
    (``touched_rows`` of csrc/ceiling.cu): row q adds into (q // k_rows)
    % 8."""
    if stop <= start:
        return 0
    j0, j1 = start // k_rows, (stop - 1) // k_rows
    if j1 - j0 >= READ_ROWS - 1:
        return (1 << READ_ROWS) - 1
    mask = 0
    for j in range(j0, j1 + 1):
        mask |= 1 << (j % READ_ROWS)
    return mask


def _read_order(nb: int, sub: int, ctas: int) -> dict:
    """``read_kernel``'s order of additions for x [nb, 8, sub] on ``ctas``
    CTAs (csrc/ceiling.cu's note), as int64 arrays:

    - ``chain`` [rows]: the running sum a row of x goes into, (c * 8 + w)
      * 8 + r for CTA c, warp w and output row r (in each run of its
      share, a CTA's warps take rows w, w + 8, ... from the run's first
      row there), ``pos`` its place in that sum, ``length`` the sum's
      length (runs in order);
    - ``range`` and ``sub`` [ctas]: the range v = [ctas v / 8, ctas (v +
      1) / 8) that holds CTA c and the sub-range w of it, [lo + (hi - lo)
      w / 8, lo + (hi - lo) (w + 1) / 8), whose warp adds c's partials;
      ``slot`` [ctas, 8]: the place of CTA c's partial of output row r in
      that warp's sum (ascending c over the CTAs that touched r), -1 where
      c did not touch r; ``count`` [8, 8, 8]: the partials of each (v, w,
      r);
    - ``ranges`` [8, 8]: range v holds rows of output row r (its sum is
      one term of r's), and ``rank`` [8, 8] its place among them."""
    k_rows = sub // READ_LANES
    rows = nb * READ_ROWS * k_rows
    shares = read_shares(rows, ctas)
    q = np.arange(rows, dtype=np.int64)
    c = np.searchsorted(shares[:, 0], q, side="right") - 1
    run = q // k_rows
    first = np.maximum(shares[c, 0], run * k_rows)  # the run's first row in the share
    chain = (c * WARPS + (q - first) % WARPS) * READ_ROWS + run % READ_ROWS
    order = np.argsort(chain, kind="stable")
    heads = np.flatnonzero(np.r_[True, np.diff(chain[order]) != 0])
    lengths = np.diff(np.r_[heads, rows])
    pos, length = np.empty(rows, np.int64), np.empty(rows, np.int64)
    pos[order] = np.arange(rows) - np.repeat(heads, lengths)
    length[order] = np.repeat(lengths, lengths)
    touched = np.bincount(c * READ_ROWS + run % READ_ROWS,
                          minlength=ctas * READ_ROWS).reshape(ctas, READ_ROWS) > 0
    lo = ctas * np.arange(READ_RANGES + 1) // READ_RANGES
    rng, sub_ = np.empty(ctas, np.int64), np.empty(ctas, np.int64)
    for v in range(READ_RANGES):
        members = np.arange(lo[v], lo[v + 1])
        bounds = lo[v] + (lo[v + 1] - lo[v]) * np.arange(WARPS + 1) // WARPS
        rng[members] = v
        sub_[members] = np.searchsorted(bounds, members, side="right") - 1
    group = rng * WARPS + sub_
    slot = np.full((ctas, READ_ROWS), -1, np.int64)
    count = np.zeros((READ_RANGES * WARPS, READ_ROWS), np.int64)
    for g in np.unique(group):
        members = np.flatnonzero(group == g)
        t = touched[members]
        slot[members] = np.where(t, np.cumsum(t, axis=0) - 1, -1)
        count[g] = t.sum(axis=0)
    ranges = np.stack([touched[lo[v]:lo[v + 1]].any(axis=0) for v in range(READ_RANGES)])
    rank = np.where(ranges, np.cumsum(ranges, axis=0) - 1, -1)
    return {"chain": chain, "pos": pos, "length": length, "range": rng, "sub": sub_,
            "slot": slot, "count": count.reshape(READ_RANGES, WARPS, READ_ROWS),
            "ranges": ranges, "rank": rank}


def read_chain(nb: int, sub: int, ctas: int) -> int:
    """The longest chain of float32 additions on one output's path in
    ``read_kernel`` for x [nb, 8, sub] on ``ctas`` CTAs: a row's adds in
    its warp's running sum (from its own to the sum's last), then in its
    CTA's partial (8 warp sums added in order: warp 0's passes 7 adds,
    warp w's 8 - w), in its sub-range's sum of partials, in its range's
    sum (8 sub-range sums in order, likewise) and in the output's sum of
    the ranges' sums (from 0).  Its error bound is this x 2^-24 x the sum
    of |x| over the output's terms."""
    o = _read_order(nb, sub, ctas)
    c, w_r = np.divmod(o["chain"], WARPS * READ_ROWS)
    w, r = np.divmod(w_r, READ_ROWS)
    v, u = o["range"][c], o["sub"][c]
    n_ranges = o["ranges"].sum(axis=0)
    adds = (o["length"] - o["pos"] + WARPS - np.maximum(w, 1)
            + o["count"][v, u, r] - o["slot"][c, r] + WARPS - np.maximum(u, 1)
            + n_ranges[r] - o["rank"][v, r])
    return int(adds.max())


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


def read_sum_ordered(x: torch.Tensor, ctas: int) -> torch.Tensor:
    """The read in ``read_kernel``'s order of additions on ``ctas`` CTAs
    (:func:`_read_order`): every warp's running sums, each CTA's partials
    (its warps in order), each sub-range's sum of partials in CTA order,
    each range's sum (its 8 sub-ranges in order), and each output's sum of
    the ranges' in range order.  For ``read_grid(x.device)`` CTAs it
    equals the kernel bit for bit; it is slow, for tests."""
    nb, _, sub = x.shape
    o = _read_order(nb, sub, ctas)
    dev = x.device
    xr = x.reshape(-1, READ_LANES)
    sums = torch.zeros((ctas * WARPS * READ_ROWS, READ_LANES), dtype=x.dtype, device=dev)
    by_pos = np.argsort(o["pos"], kind="stable")
    cuts = np.cumsum(np.bincount(o["pos"]))[:-1]
    for rows in np.split(by_pos, cuts):  # each sum's i-th add, every sum at once
        idx = torch.from_numpy(rows).to(dev)
        chain = torch.from_numpy(o["chain"][rows]).to(dev)
        sums[chain] = sums[chain] + xr[idx]
    sums = sums.view(ctas, WARPS, READ_ROWS, READ_LANES)
    part = sums[:, 0]
    for w in range(1, WARPS):
        part = part + sums[:, w]
    subs = torch.zeros((READ_RANGES, WARPS, READ_ROWS, READ_LANES), dtype=x.dtype, device=dev)
    for i in range(int(o["slot"].max()) + 1):
        c, r = np.nonzero(o["slot"] == i)
        v, u = (torch.from_numpy(o[k][c]).to(dev) for k in ("range", "sub"))
        c, r = torch.from_numpy(c).to(dev), torch.from_numpy(r).to(dev)
        subs[v, u, r] = subs[v, u, r] + part[c, r]
    ranges = subs[:, 0]
    for u in range(1, WARPS):
        ranges = ranges + subs[:, u]
    out = torch.zeros((READ_ROWS, READ_LANES), dtype=x.dtype, device=dev)
    for v in range(READ_RANGES):
        has = torch.from_numpy(o["ranges"][v]).to(dev)[:, None]
        out = torch.where(has, out + ranges[v], out)
    return out


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
    if x.numel() // READ_LANES >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)}: 2^31 or more rows of 128")
    stream = _stream(x)
    scratch = _READ_SCRATCH.get((x.device, stream))
    if scratch is None:  # the tickets start at 0, and each launch leaves them so
        ctas = read_grid(x.device)
        scratch = _READ_SCRATCH[(x.device, stream)] = (
            torch.empty((ctas, READ_ROWS, READ_LANES), dtype=torch.float32, device=x.device),
            torch.empty((READ_RANGES, READ_ROWS, READ_LANES), dtype=torch.float32,
                        device=x.device),
            torch.zeros(READ_TICKETS, dtype=torch.int32, device=x.device))
    partials, range_sums, tickets = scratch
    out = torch.empty((READ_ROWS, READ_LANES), dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.apt_ceiling_read(x.data_ptr(), partials.data_ptr(), range_sums.data_ptr(),
                                   tickets.data_ptr(), out.data_ptr(), x.shape[0], x.shape[2],
                                   partials.shape[0], stream)
    _check(lib, err, "apt_ceiling_read")
    LAUNCHES["read"] += 1
    return out
