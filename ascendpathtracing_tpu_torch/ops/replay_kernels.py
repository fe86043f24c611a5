"""The fused mesh renderer's replay rows: CUDA wrapper, plain twin and
launch count.

One chunk of sample layers of the residuals that the fused mesh forward
stores (``wid`` int32 [B, spp4, P], ``resv`` [B, 7, spp4, P]: each
bounce's winner code and its albedo a, emission e and scalar s) and the
per-sample cotangent ``g_cell`` [3, P] (already scaled by 1 / spp4) ->
the rows [6, B, L, P] of the layers [layer0, layer0 + L): the albedo
gradients ``ga`` (rows 0-2) and emission gradients ``ge`` (rows 3-5) of
each sample-bounce, which ``diff/mesh_fused.replay_backward`` hands to
the segment-sum.  The product chain is the one that module's docstring
sets out.

No TPU kernel stands behind it: the JAX package leaves the chain to XLA,
which fuses it into one pass.  Here :func:`replay_rows`

- for tensors on the CPU runs the plain twin :func:`replay_rows_plain`
  (plain torch, chunk-sized temporaries);
- for tensors on a CUDA device launches ``replay_rows_kernel``
  (``csrc/mesh_replay.cu``: one pass, the chain in registers, the chunk
  read in place from the whole arrays) on the current stream, adds one to
  ``LAUNCHES["replay_rows"]``, and raises if the launch fails.  There is
  no fallback.

Either way the call runs inside the span ``apt.kernel.replay_rows``.  The
kernel follows the twin's order of operations, so the rows are the
twin's bit for bit in float32 and float64.
"""

from __future__ import annotations

import ctypes

import torch

from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.ops.render_kernels import on_cpu
from ascendpathtracing_tpu_torch.utils.profiling import spanned

#: Bounce counts the kernel takes at compile time (csrc/mesh_replay.cu
#: MAX_UNROLLED); more take its instantiation that reads B at run time.
MAX_UNROLLED = 16

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"replay_rows": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong


def reset_launches() -> None:
    LAUNCHES["replay_rows"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/mesh_replay.cu`` and declares its C
    interface."""
    lib = build.load("mesh_replay")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_replay_error_string.argtypes = (_I,)
    lib.apt_replay_error_string.restype = ctypes.c_char_p
    lib.apt_replay_max_unrolled.argtypes = ()
    lib.apt_replay_max_unrolled.restype = _I
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"apt_replay_rows_{suffix}")
        fn.argtypes = (_P, _P, _P, _P, _I, _N, _N, _I, _I, _P)
        fn.restype = _I
    if lib.apt_replay_max_unrolled() != MAX_UNROLLED:
        raise RuntimeError(f"mesh_replay MAX_UNROLLED {lib.apt_replay_max_unrolled()} != "
                           f"{MAX_UNROLLED}")
    lib._apt_declared = True
    return lib


def _check(wid, resv, g_cell, layer0, layers, out) -> bool:
    """Raises on what the kernel does not take; True for CPU tensors."""
    if wid.dtype != torch.int32:
        raise TypeError(f"wid must be int32, got {wid.dtype}")
    if resv.dtype not in _DTYPES:
        raise TypeError(f"resv must be float32 or float64, got {resv.dtype}")
    if g_cell.dtype != resv.dtype:
        raise TypeError(f"g_cell must be {resv.dtype} like resv, got {g_cell.dtype}")
    if wid.dim() != 3:
        raise ValueError(f"expected wid [B, spp4, P], got {tuple(wid.shape)}")
    bounces, spp4, pix = wid.shape
    if tuple(resv.shape) != (bounces, 7, spp4, pix) or tuple(g_cell.shape) != (3, pix):
        raise ValueError(f"expected resv [{bounces}, 7, {spp4}, {pix}] and g_cell [3, {pix}], "
                         f"got {tuple(resv.shape)} and {tuple(g_cell.shape)}")
    if not (0 <= layer0 and 1 <= layers and layer0 + layers <= spp4):
        raise ValueError(f"layers [{layer0}, {layer0 + layers}) outside [0, {spp4})")
    if not (wid.is_contiguous() and resv.is_contiguous() and g_cell.is_contiguous()):
        raise ValueError("wid, resv and g_cell must be contiguous")
    tensors = (wid, resv, g_cell)
    if out is not None:
        if (tuple(out.shape) != (6, bounces, layers, pix) or out.dtype != resv.dtype
                or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous [6, {bounces}, {layers}, {pix}] "
                             f"{resv.dtype} tensor")
        tensors += (out,)
    return on_cpu(*tensors)


def replay_rows_plain(wid, resv, g_cell, *, layer0, layers, out=None):
    """Plain twin of :func:`replay_rows`, in the JAX op order: the
    layers [layer0, layer0 + layers) of ``wid`` [B, spp4, P] and ``resv``
    [B, 7, spp4, P], the cotangent ``g_cell`` [3, P] -> the rows [6, B,
    layers, P] (into ``out`` when given), in the order of
    ``wid[:, layer0:layer0 + layers].reshape(-1)``."""
    widc = wid[:, layer0:layer0 + layers]
    resvc = resv[:, :, layer0:layer0 + layers]
    g_cell = g_cell[:, None, :]  # [3, 1, P]
    bounces = widc.shape[0]
    rows = (torch.empty((6,) + tuple(widc.shape), dtype=resvc.dtype, device=resvc.device)
            if out is None else out)
    if bounces == 0:
        return rows
    a3 = resvc[:, 0:3]
    e3 = resvc[:, 3:6]
    s = resvc[:, 6]
    livef = (widc >= 0).to(resvc.dtype)[:, None]  # [B, 1, L, P]
    m = torch.where(livef > 0, a3 * s[:, None], 1.0)
    e_live = e3 * livef

    tput_prev = []
    t = torch.ones_like(m[0])
    for b in range(bounces):
        tput_prev.append(t)
        t = t * m[b]
    suffix = [None] * bounces
    suffix[bounces - 1] = torch.zeros_like(m[0])
    for b in range(bounces - 2, -1, -1):
        suffix[b] = e_live[b + 1] + m[b + 1] * suffix[b + 1]

    for b in range(bounces):
        rows[3:6, b] = g_cell * livef[b] * tput_prev[b]
        rows[0:3, b] = g_cell * livef[b] * s[b][None] * tput_prev[b] * suffix[b]
    return rows


@spanned("apt.kernel.replay_rows")
def replay_rows(wid, resv, g_cell, *, layer0, layers, out=None):
    """The rows [6, B, layers, P] of the layers [layer0, layer0 + layers)
    (into ``out`` when given; else allocated at the chunk's size): one
    launch of ``csrc/mesh_replay.cu`` for CUDA tensors, the plain twin for
    CPU tensors.  ``wid``, ``resv`` and ``g_cell`` are the whole contiguous
    arrays; the kernel reads the chunk in place."""
    if _check(wid, resv, g_cell, layer0, layers, out):
        return replay_rows_plain(wid, resv, g_cell, layer0=layer0, layers=layers, out=out)
    bounces, spp4, pix = wid.shape
    rows = (torch.empty((6, bounces, layers, pix), dtype=resv.dtype, device=resv.device)
            if out is None else out)
    if bounces == 0 or pix == 0:
        return rows
    lib = load_library()
    with torch.cuda.device(resv.device):
        stream = torch.cuda.current_stream(resv.device).cuda_stream
        err = getattr(lib, f"apt_replay_rows_{_DTYPES[resv.dtype]}")(
            wid.data_ptr(), resv.data_ptr(), g_cell.data_ptr(), rows.data_ptr(), bounces,
            spp4, pix, layer0, layers, stream)
    if err != 0:
        raise RuntimeError(
            f"apt_replay_rows: CUDA error {err} ({lib.apt_replay_error_string(err).decode()})")
    LAUNCHES["replay_rows"] += 1
    return rows
