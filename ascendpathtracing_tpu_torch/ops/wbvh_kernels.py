"""The chunk-grid traversal: CUDA wrapper and plain twin.

Counterpart of ``ascendpathtracing_tpu/ops/pallas_wbvh.py``
(``intersect_chunks_pallas`` and its kernel ``_wbvh_kernel``).
:func:`intersect_chunks` checks its inputs, then:

- for tensors on the CPU, runs :func:`intersect_chunks_plain`;
- for tensors on a CUDA device, launches ``wbvh_kernel`` of
  ``csrc/wbvh.cu`` on the current stream, adds one to
  ``LAUNCHES["wbvh"]``, and raises if the launch fails.  There is no
  fallback.

Both gate each ray by its own slab tests and visit chunks in increasing
index (``csrc/chunk_walk.cuh`` says why that keeps the Pallas kernel's
winners), and keep a running (tmin, slot) with a strict ``t < tmin``.
The walk here (:func:`walk_plain`) is shared with the mesh path
tracer's twin (``ops/mesh_pt_kernels``).

Tables are the chunk grid's (``ops/chunk_grid``): float32 boxes and
13- or 24-float rows.  Rays [6, N] are float32 or float64; the rows are
read widened in float64.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.ops.chunk_grid import MISS_T, TRI_ATTR_F, TRI_F
from ascendpathtracing_tpu_torch.ops.render_kernels import on_cpu

N_ATTR = TRI_ATTR_F - TRI_F  # winner planes: nx ny nz ar ag ab er eg eb is_diff is_refr

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"wbvh": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = (_P,) * 9 + (ctypes.c_longlong,) + (_I,) * 7 + (ctypes.c_double, _P)


def reset_launches() -> None:
    LAUNCHES["wbvh"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/wbvh.cu`` and declares its C interface."""
    lib = build.load("wbvh")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_wbvh_attr_count.argtypes = ()
    lib.apt_wbvh_attr_count.restype = _I
    lib.apt_wbvh_error_string.argtypes = (_I,)
    lib.apt_wbvh_error_string.restype = ctypes.c_char_p
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"apt_wbvh_{suffix}")
        fn.argtypes = _SIGNATURE
        fn.restype = _I
    if lib.apt_wbvh_attr_count() != N_ATTR:
        raise RuntimeError(f"library attr count {lib.apt_wbvh_attr_count()} != {N_ATTR}")
    lib._apt_declared = True
    return lib


def check_grid(cboxes, sboxes, ssboxes, tris, *, tris_per_chunk, supers_per,
               supers2_per, widths=(TRI_F, TRI_ATTR_F)):
    """Checks a chunk grid's tensors -> (C, Cs, Css, ssboxes), ssboxes a
    [0, 6] tensor when absent.  Raises TypeError/ValueError on what the
    kernels do not take."""
    if ssboxes is None:
        ssboxes = torch.zeros((0, 6), dtype=torch.float32, device=cboxes.device)
    for name, t in (("cboxes", cboxes), ("sboxes", sboxes), ("ssboxes", ssboxes),
                    ("tris", tris)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("cboxes", cboxes), ("sboxes", sboxes), ("ssboxes", ssboxes)):
        if t.dim() != 2 or t.shape[1] != 6:
            raise ValueError(f"expected [*, 6] {name}, got {tuple(t.shape)}")
    c, cs, css = cboxes.shape[0], sboxes.shape[0], ssboxes.shape[0]
    if c < 1 or tris_per_chunk < 1:
        raise ValueError(f"need chunks and tris_per_chunk >= 1, got {c}, {tris_per_chunk}")
    if cs and (supers_per < 1 or cs * supers_per != c):
        raise ValueError(f"sboxes [{cs}] x supers_per {supers_per} != {c} chunks")
    if css and (not cs or supers2_per < 1 or css * supers2_per != cs):
        raise ValueError(f"ssboxes [{css}] x supers2_per {supers2_per} != {cs} supers")
    if tris.dim() != 2 or tris.shape[0] != c * tris_per_chunk or tris.shape[1] not in widths:
        raise ValueError(
            f"expected tris [{c * tris_per_chunk}, {' or '.join(map(str, widths))}], "
            f"got {tuple(tris.shape)}"
        )
    return c, cs, css, ssboxes


# ------------------------------------------------------- plain twin ----
class PlainGrid(NamedTuple):
    """A chunk grid for :func:`walk_plain`: boxes as Python floats (exact
    float32 values) and the rows in the compute dtype."""

    cboxes: list
    sboxes: list
    ssboxes: list
    rows: torch.Tensor
    tris_per_chunk: int
    supers_per: int
    supers2_per: int


def plain_grid(cboxes, sboxes, ssboxes, tris, dtype, *, tris_per_chunk,
               supers_per, supers2_per) -> PlainGrid:
    return PlainGrid(cboxes.tolist(), sboxes.tolist(), ssboxes.tolist(),
                     tris.to(dtype), tris_per_chunk, supers_per, supers2_per)


def _slab(r, b, zero):
    """_slab (or _slab_tmin where the rays carry a "gate") of box b for
    the rays of r, with NaN-propagating min/max as jnp's."""
    t1x = (b[0] - r["ox"]) * r["ix"]
    t2x = (b[3] - r["ox"]) * r["ix"]
    t1y = (b[1] - r["oy"]) * r["iy"]
    t2y = (b[4] - r["oy"]) * r["iy"]
    t1z = (b[2] - r["oz"]) * r["iz"]
    t2z = (b[5] - r["oz"]) * r["iz"]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    hit = tfar >= torch.maximum(tnear, zero)
    if "gate" in r:
        hit = hit & (tnear < r["gate"])
    return hit


def _subset(r, mask):
    sel = mask.nonzero()[:, 0]
    return {k: v[sel] for k, v in r.items()}


def _test_chunk(grid, r, c, eps, tmin, slot):
    """The triangles of chunk c against the rays of r: the first minimum
    of the valid t of the chunk replaces the running winner where it is
    strictly smaller (the kernel's running minimum over the rows, in row
    order)."""
    T = grid.tris_per_chunk
    rows = grid.rows[c * T:(c + 1) * T]
    col = [rows[:, k:k + 1] for k in range(TRI_F)]  # [T, 1] each
    ox, oy, oz = r["ox"][None], r["oy"][None], r["oz"][None]
    dx, dy, dz = r["dx"][None], r["dy"][None], r["dz"][None]
    nd = col[3] * dx + col[4] * dy + col[5] * dz
    no = col[3] * ox + col[4] * oy + col[5] * oz
    t = (col[12] - no) / nd
    wx = (ox - col[0]) + t * dx
    wy = (oy - col[1]) + t * dy
    wz = (oz - col[2]) + t * dz
    u = col[6] * wx + col[7] * wy + col[8] * wz
    v = col[9] * wx + col[10] * wy + col[11] * wz
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    tt = torch.where(ok, t, float("inf"))
    j = torch.argmin(tt, dim=0)  # first minimum: the lowest slot on a tie
    tbest = tt.gather(0, j[None])[0]
    ids = r["ids"]
    better = tbest < tmin[ids]
    tmin[ids] = torch.where(better, tbest, tmin[ids])
    slot[ids] = torch.where(better, c * T + j, slot[ids])


def walk_plain(grid: PlainGrid, o3, d3, tmin, *, eps, gate=None, counts=None,
               marks=None):
    """The kernels' per-ray walk (``chunk_walk.cuh``) as torch ops: loop
    over the boxes in index order, keep the rays whose slab test passes,
    test the listed chunks' rows on those rays.  ``tmin`` [M] is the
    running minimum (updated in place); ``gate`` [M] the mesh path
    tracer's entry bound; ``counts`` [3, M] int32 (chunks tested, supers
    hit, super-supers hit) are added to in place.  ``marks`` = (group [M]
    int64, (chunks [G, C], supers [G, Cs], super-supers [G, Css]) bool):
    each box a ray enters is set for the ray's group, so each row ends as
    the union over the group's rays (the mesh kernel's with_stats).
    Returns slot [M] int64, -1 where no triangle won."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    m = ox.shape[0]
    r = {
        "ox": ox, "oy": oy, "oz": oz, "dx": dx, "dy": dy, "dz": dz,
        "ix": 1.0 / torch.where(dx == 0, 1e-30, dx),
        "iy": 1.0 / torch.where(dy == 0, 1e-30, dy),
        "iz": 1.0 / torch.where(dz == 0, 1e-30, dz),
        "ids": torch.arange(m, device=ox.device),
    }
    if gate is not None:
        r["gate"] = gate
    slot = torch.full((m,), -1, dtype=torch.int64, device=ox.device)
    zero = torch.zeros((), dtype=ox.dtype, device=ox.device)

    def visit(boxes, lo, hi, r, level, inner):
        for b in range(lo, hi):
            sub = _subset(r, _slab(r, boxes[b], zero))
            if sub["ids"].numel() == 0:
                continue
            if counts is not None:
                counts[level, sub["ids"]] += 1
            if marks is not None:
                marks[1][level][marks[0][sub["ids"]], b] = True
            inner(b, sub)

    def chunk(c, sub):
        _test_chunk(grid, sub, c, eps, tmin, slot)

    def chunks(lo, hi, r):
        visit(grid.cboxes, lo, hi, r, 0, chunk)

    def supers(lo, hi, r):
        per = grid.supers_per
        visit(grid.sboxes, lo, hi, r, 1, lambda s, sub: chunks(s * per, (s + 1) * per, sub))

    if not grid.sboxes:
        chunks(0, len(grid.cboxes), r)
    elif not grid.ssboxes:
        supers(0, len(grid.sboxes), r)
    else:
        per2 = grid.supers2_per
        visit(grid.ssboxes, 0, len(grid.ssboxes), r, 2,
              lambda s2, sub: supers(s2 * per2, (s2 + 1) * per2, sub))
    return slot


def intersect_chunks_plain(rays_planes, cboxes, sboxes, tris, ssboxes=None, *,
                           tris_per_chunk, supers_per=0, supers2_per=0,
                           eps=1e-4, attrs=False, stats=False):
    """Plain twin of :func:`intersect_chunks`, same arguments and
    results."""
    _, _, _, ssboxes = check_grid(
        cboxes, sboxes, ssboxes, tris, tris_per_chunk=tris_per_chunk,
        supers_per=supers_per, supers2_per=supers2_per,
    )
    dtype, device = rays_planes.dtype, rays_planes.device
    n = rays_planes.shape[1]
    grid = plain_grid(cboxes, sboxes, ssboxes, tris, dtype,
                      tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                      supers2_per=supers2_per)
    tmin = torch.full((n,), MISS_T, dtype=dtype, device=device)
    counts = torch.zeros((3, n), dtype=torch.int32, device=device) if stats else None
    slot = walk_plain(grid, tuple(rays_planes[0:3]), tuple(rays_planes[3:6]), tmin,
                      eps=eps, counts=counts)
    won = slot >= 0
    res = (tmin, torch.where(won, slot, 0).to(torch.int32))
    if attrs:
        planes = grid.rows[slot.clamp_min(0), TRI_F:].T
        res = res + (tuple(torch.where(won, planes, 0.0)),)
    return res + (counts,) if stats else res


# ---------------------------------------------------------- wrapper ----
def intersect_chunks(rays_planes, cboxes, sboxes, tris, ssboxes=None, *,
                     tris_per_chunk, supers_per=0, supers2_per=0, eps=1e-4,
                     attrs=False, stats=False):
    """Closest hit of rays [6, N] (ox oy oz dx dy dz; float32 or float64)
    against a chunk grid -> (tmin [N], hit [N] int32): hit is the winning
    SLOT (index into the chunk-ordered rows; map to faces with
    ``ChunkGrid.face_of_slot``), 0 on a miss, where tmin stays 1e20.

    ``attrs=True`` (24-float rows, ``chunk_grid.attr_triangle_rows``)
    appends a tuple of the 11 winner planes (nx ny nz ar ag ab er eg eb
    is_diff is_refr; zeros on a miss).  ``stats=True`` appends an int32
    [3, N] of per-ray counts: chunks tested, supers hit, super-supers hit.
    Any N."""
    if rays_planes.dtype not in _DTYPES:
        raise TypeError(f"rays must be float32 or float64, got {rays_planes.dtype}")
    if rays_planes.dim() != 2 or rays_planes.shape[0] != 6 or rays_planes.shape[1] < 1:
        raise ValueError(f"expected [6, N] rays, got {tuple(rays_planes.shape)}")
    if not rays_planes.is_contiguous():
        raise ValueError("rays must be contiguous")
    c, cs, css, ssboxes = check_grid(
        cboxes, sboxes, ssboxes, tris, tris_per_chunk=tris_per_chunk,
        supers_per=supers_per, supers2_per=supers2_per,
    )
    if attrs and tris.shape[1] != TRI_ATTR_F:
        raise ValueError(f"attrs=True needs [C*T, {TRI_ATTR_F}] rows")
    kw = dict(tris_per_chunk=tris_per_chunk, supers_per=supers_per,
              supers2_per=supers2_per, eps=eps, attrs=attrs, stats=stats)
    if on_cpu(rays_planes, cboxes, sboxes, ssboxes, tris):
        return intersect_chunks_plain(rays_planes, cboxes, sboxes, tris, ssboxes, **kw)

    n = rays_planes.shape[1]
    dtype, device = rays_planes.dtype, rays_planes.device
    tmin = torch.empty((n,), dtype=dtype, device=device)
    hit = torch.empty((n,), dtype=torch.int32, device=device)
    attr_out = torch.empty((N_ATTR, n), dtype=dtype, device=device) if attrs else None
    stats_out = torch.empty((3, n), dtype=torch.int32, device=device) if stats else None

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"apt_wbvh_{_DTYPES[dtype]}")(
            rays_planes.data_ptr(), cboxes.data_ptr(), ptr(sboxes), ptr(ssboxes),
            tris.data_ptr(), tmin.data_ptr(), hit.data_ptr(), ptr(attr_out),
            ptr(stats_out), n, c, cs, css, tris_per_chunk, supers_per,
            supers2_per, tris.shape[1], eps, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"apt_wbvh: CUDA error {err} ({lib.apt_wbvh_error_string(err).decode()})"
        )
    LAUNCHES["wbvh"] += 1
    res = (tmin, hit)
    if attrs:
        res = res + (tuple(attr_out),)
    return res + (stats_out,) if stats else res
