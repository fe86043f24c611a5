"""The stackless BVH traversal: CUDA wrapper and plain twin.

Counterpart of ``ascendpathtracing_tpu/ops/pallas_bvh.py``
(``intersect_bvh_pallas``, its kernel ``_traverse_kernel`` and
``pack_bvh_for_pallas``).  :func:`intersect_bvh` checks its inputs, then:

- for tensors on the CPU, runs :func:`intersect_bvh_plain`;
- for tensors on a CUDA device, launches ``bvh_kernel`` of
  ``csrc/bvh.cu`` on the current stream, adds one to ``LAUNCHES["bvh"]``,
  and raises if the launch fails.  There is no fallback.

Either way the call runs inside the span ``apt.kernel.bvh``
(``utils/profiling.span``).

Both run each ray's own stackless walk (the nodes the lockstep Pallas
kernel visits for it, in the same order) and keep a running (tmin, hit)
with a strict ``t < tmin``.  The twin is ``accel/bvh.walk`` over the
packed tables.  The TPU kernel's tile size, ``jump_every`` and SMEM/VMEM
table placement have no counterpart, and any N is taken.

Tables (:func:`pack_bvh`): ``nodesf`` [M, 6] float32 (bmin xyz, bmax xyz),
``nodesi`` [M, 3] int32 (first, count, miss), ``tris9`` [F, 9] float32
(v0 xyz, e1 xyz, e2 xyz) in leaf order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.ops.render_kernels import on_cpu
from ascendpathtracing_tpu_torch.utils.profiling import spanned

MISS_T = bvh_mod.MISS_T

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"bvh": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = (_P,) * 6 + (ctypes.c_longlong, _I, _I, _I, ctypes.c_double, _P)


def reset_launches() -> None:
    LAUNCHES["bvh"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/bvh.cu`` and declares its C interface."""
    lib = build.load("bvh")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_bvh_error_string.argtypes = (_I,)
    lib.apt_bvh_error_string.restype = ctypes.c_char_p
    lib.apt_bvh_f32.argtypes = _SIGNATURE
    lib.apt_bvh_f32.restype = _I
    lib._apt_declared = True
    return lib


def pack_bvh(bvh: bvh_mod.FlatBVH, tri_planes_ordered, device="cpu"):
    """FlatBVH + leaf-ordered (v0, e1, e2) planes -> (nodesf, nodesi,
    tris9) tensors on ``device``, as ``pack_bvh_for_pallas`` builds them."""
    nodesf = np.concatenate([bvh.bmin, bvh.bmax], axis=1).astype(np.float32)
    nodesi = np.stack([bvh.first, bvh.count, bvh.miss], axis=1).astype(np.int32)
    tris9 = np.stack([np.asarray(c, np.float32) for t in tri_planes_ordered for c in t],
                     axis=1)
    return tuple(torch.tensor(a, device=device) for a in (nodesf, nodesi, tris9))


def check_tables(nodesf, nodesi, tris9, max_leaf):
    """Checks the packed tables -> (M, F).  Raises TypeError/ValueError on
    what the kernel does not take."""
    for name, t, dtype, width in (("nodesf", nodesf, torch.float32, 6),
                                  ("nodesi", nodesi, torch.int32, 3),
                                  ("tris9", tris9, torch.float32, 9)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != width or t.shape[0] < 1:
            raise ValueError(f"expected [*, {width}] {name}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodesi.shape[0] != nodesf.shape[0]:
        raise ValueError(f"nodesf [{nodesf.shape[0]}] and nodesi [{nodesi.shape[0]}] differ")
    if max_leaf < 1:
        raise ValueError(f"max_leaf must be >= 1, got {max_leaf}")
    return nodesf.shape[0], tris9.shape[0]


def intersect_bvh_plain(rays_planes, nodesf, nodesi, tris9, *, max_leaf, eps=1e-4,
                        counts=None):
    """Plain twin of :func:`intersect_bvh` in the rays' dtype (float32 or
    float64; the tables are widened).  ``counts`` [2, N] int64 (nodes
    visited, triangles tested) is added to in place."""
    check_tables(nodesf, nodesi, tris9, max_leaf)
    tri = tris9.T
    planes = (tuple(tri[0:3]), tuple(tri[3:6]), tuple(tri[6:9]))
    tmin, hit = bvh_mod.walk(
        tuple(rays_planes[0:3]), tuple(rays_planes[3:6]), nodesf[:, 0:3], nodesf[:, 3:6],
        nodesi[:, 0], nodesi[:, 1].clamp_max(max_leaf), nodesi[:, 2], planes, eps,
        counts=counts,
    )
    return tmin, hit.to(torch.int32)


@spanned("apt.kernel.bvh")
def intersect_bvh(rays_planes, nodesf, nodesi, tris9, *, max_leaf, eps=1e-4):
    """Closest hit of float32 rays [6, N] (ox oy oz dx dy dz) against the
    packed BVH -> (tmin [N] float32, hit [N] int32): hit is the LEAF-ORDER
    triangle index (map to faces with ``FlatBVH.tri_order``), 0 on a miss,
    where tmin stays 1e20.  A leaf tests at most ``max_leaf`` triangles.
    Any N."""
    if rays_planes.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got {rays_planes.dtype}")
    if rays_planes.dim() != 2 or rays_planes.shape[0] != 6 or rays_planes.shape[1] < 1:
        raise ValueError(f"expected [6, N] rays, got {tuple(rays_planes.shape)}")
    if not rays_planes.is_contiguous():
        raise ValueError("rays must be contiguous")
    m, f = check_tables(nodesf, nodesi, tris9, max_leaf)
    if on_cpu(rays_planes, nodesf, nodesi, tris9):
        return intersect_bvh_plain(rays_planes, nodesf, nodesi, tris9, max_leaf=max_leaf,
                                   eps=eps)

    n = rays_planes.shape[1]
    device = rays_planes.device
    tmin = torch.empty((n,), dtype=torch.float32, device=device)
    hit = torch.empty((n,), dtype=torch.int32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.apt_bvh_f32(
            rays_planes.data_ptr(), nodesf.data_ptr(), nodesi.data_ptr(), tris9.data_ptr(),
            tmin.data_ptr(), hit.data_ptr(), n, m, f, max_leaf, eps, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"apt_bvh: CUDA error {err} ({lib.apt_bvh_error_string(err).decode()})"
        )
    LAUNCHES["bvh"] += 1
    return tmin, hit
