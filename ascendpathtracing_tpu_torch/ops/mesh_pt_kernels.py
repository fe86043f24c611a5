"""The fused sphere+mesh path tracer: CUDA wrapper, plain twin and tables.

Counterpart of ``ascendpathtracing_tpu/ops/pallas_mesh_pt.py``
(``render_pt_mesh_pallas`` and its kernel ``_mesh_pt_kernel``, with its
replay residuals, camera and stats outputs and its debug dump).
:func:`render_pt_mesh` checks its inputs, then:

- for tensors on the CPU, runs :func:`render_pt_mesh_plain`;
- for tensors on a CUDA device, launches ``render_pt_mesh_kernel`` of
  ``csrc/mesh_pt.cu`` on the current stream, adds one to
  ``LAUNCHES["mesh_pt"]``, and raises if the launch fails.  There is no
  fallback.

Either way the call runs inside the span ``apt.kernel.mesh_pt``
(``utils/profiling.span``).

The estimator is the sphere path tracer's (``ops/pt_kernels``: camera,
Philox stream keyed as ``render_pt`` keys its own, diffuse/mirror/glass,
Russian roulette, the mean over ``spp4`` layers) with a mesh: each
bounce the spheres run first, then the chunk-grid walk gated by the tmin
after the spheres (``ops/wbvh_kernels.walk_plain``); a triangle needs a
strictly smaller t.  A triangle winner shades with its row's unit
normal, albedo, emission and material one-hots and an origin offset of
eps.  A mesh that no ray reaches gives ``render_pt``'s image bit for
bit.

``with_residuals=True`` also returns the replay residuals of
``diff/mesh_fused`` (``pallas_mesh_pt.py:514-532``) in the port's own
layout, pixel-minor: ``wid`` int32 [bounces, spp4, W*H], the winner code
of each bounce (sphere index, S + triangle slot, -1 where the path took
no bounce: after a miss or after Russian roulette ended it), and ``resv``
[bounces, 7, spp4, W*H] in the compute dtype: the winner's albedo and
emission and s = glass rscale x RR weight (1/pmax where the path
survived RR; the bounce on which RR ends the path is live with s =
rscale), zeros on dead bounces.  ``convert.residuals_from_jax`` maps the
Pallas kernel's tiled layout onto this one.  The image is the same bit
for bit with or without residuals.

``with_camera=True`` (it needs ``with_residuals``, as in JAX) also returns
``suv`` [2, spp4, W*H] in the compute dtype: the screen coordinates (su,
sv) each sample's primary ray was made from (``convert.suv_from_jax``
maps the Pallas layout).  ``with_stats=True`` also returns ``kstats``
int32 [3 * bounces, (W*H / stats_tile) * spp4] in the Pallas layout: for
each cell (``stats_tile`` pixels x one sample layer, cell = tile * spp4 +
layer) and bounce k, row k holds the number of chunks whose box some live
path of the cell enters (the walk's gate included), rows bounces + k and
2 * bounces + k the supers and super-supers.  These are unions over the
cell's paths, not per-path sums.  Neither option changes the image, wid
or resv.

``debug=True`` is the Pallas kernel's debug dump: per bounce, two lines on
stdout, ``mesh_pt worklist k: <k>`` (kstats' row k for grid cell (0, 0):
pixels [0, debug_tile) of sample layer 0; ``debug_tile`` is the Pallas
wrapper's ``tile``) and ``mesh_pt alive: <n>.0`` (the paths of that cell
alive after the bounce: their ray hit something and Russian roulette
kept them).  The kernel prints them with device printf from its debug
instantiation, the twin from torch; no output changes.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ascendpathtracing_tpu_torch import scenes
from ascendpathtracing_tpu_torch.ops import build, pt_kernels
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops.render_kernels import MAX_S, on_cpu
from ascendpathtracing_tpu_torch.ops.wbvh_kernels import (
    PlainGrid,
    check_grid,
    level_marks,
    plain_grid,
    walk_plain,
)
from ascendpathtracing_tpu_torch.utils.profiling import spanned

TRI_PT_F = cg.TRI_ATTR_F  # 24: 13 intersection + 11 shading floats

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"mesh_pt": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = (_P,) * 13 + (_I, _P, _P, ctypes.c_longlong) + (_I,) * 12 + (
    ctypes.c_double, ctypes.c_uint32, ctypes.POINTER(ctypes.c_double), _P,
)


def reset_launches() -> None:
    LAUNCHES["mesh_pt"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/mesh_pt.cu`` and declares its C interface;
    checks that its sizes match this module's."""
    lib = build.load("mesh_pt")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_mesh_pt_max_spheres.argtypes = ()
    lib.apt_mesh_pt_max_spheres.restype = _I
    lib.apt_mesh_pt_error_string.argtypes = (_I,)
    lib.apt_mesh_pt_error_string.restype = ctypes.c_char_p
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"apt_render_pt_mesh_{suffix}")
        fn.argtypes = _SIGNATURE
        fn.restype = _I
    lib.apt_mesh_pt_blocks_per_sm.argtypes = (ctypes.c_longlong, ctypes.POINTER(_I))
    lib.apt_mesh_pt_blocks_per_sm.restype = _I
    lib.apt_mesh_pt_queue_cap.argtypes = ()
    lib.apt_mesh_pt_queue_cap.restype = _I
    lib.apt_mesh_pt_queue_overflows.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    lib.apt_mesh_pt_queue_overflows.restype = _I
    if lib.apt_mesh_pt_max_spheres() != MAX_S:
        raise RuntimeError(f"library MAX_S {lib.apt_mesh_pt_max_spheres()} != {MAX_S}")
    lib._apt_declared = True
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.apt_mesh_pt_error_string(err).decode()})")


#: The kernel's instantiations in ``blocks_per_sm``'s order.
INSTANTIATIONS = tuple(f"{t}_{sink}{stats}" for t in ("f32", "f64")
                       for sink in ("forward", "residuals", "camera")
                       for stats in ("", "_stats", "_debug", "_debug_stats"))

#: ``render_pt_mesh_pallas``'s default ``tile``: pixels of a grid cell.
DEBUG_TILE = 2048


def blocks_per_sm(box_bytes: int) -> dict:
    """Resident blocks per SM of every instantiation of the kernel on the
    current card, with ``box_bytes`` of boxes in dynamic shared memory
    (0 where they do not fit) -> {instantiation: blocks}."""
    lib = load_library()
    out = (_I * len(INSTANTIATIONS))()
    _raise_on(lib, lib.apt_mesh_pt_blocks_per_sm(box_bytes, out), "apt_mesh_pt_blocks_per_sm")
    return dict(zip(INSTANTIATIONS, out))


def queue_overflows() -> dict:
    """The warp worklist's capacity (entries per queue per warp) and the
    times a warp found its super queue or its chunk queue full and worked
    it off, summed over the launches since the last call (which zeroes
    them).  Synchronizes the device."""
    lib = load_library()
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 2)()
    _raise_on(lib, lib.apt_mesh_pt_queue_overflows(out), "apt_mesh_pt_queue_overflows")
    return {"capacity": lib.apt_mesh_pt_queue_cap(), "super_queue": out[0],
            "chunk_queue": out[1]}


# ------------------------------------------------------------ tables ----
def pack_mesh_for_pt(grid: cg.ChunkGrid, ms) -> np.ndarray:
    """ChunkGrid + MeshScene -> [C*T, 24] slot-ordered rows
    (``chunk_grid.attr_triangle_rows``)."""
    return cg.attr_triangle_rows(
        grid, ms.face_albedo, ms.face_emission, ms.face_material,
        diff_code=scenes.DIFF, refr_code=scenes.REFR,
    )


def mesh_pt_tables(ms, *, tris_per_chunk: int = 16, supers_per: int | None = None,
                   supers2_per: int | None = None, device="cpu",
                   dtype=torch.float32):
    """MeshScene -> (scene_planes [10, S] in ``dtype``, cboxes [C, 6],
    sboxes [Cs, 6], tris24 [C*T, 24] (float32 tensors on ``device``),
    materials [S] int32, grid (the NumPy ChunkGrid)).

    ``supers_per`` defaults to 16 once the chunk count reaches 128 and
    ``supers2_per`` to 16 once the super count reaches 256, as the JAX
    package's ``mesh_pt_tables``.  :func:`pt_tables_kwargs` gives the
    grid's keyword arguments for :func:`render_pt_mesh`."""
    faces = np.asarray(ms.faces)
    supers_per, auto2 = cg.auto_levels(faces.shape[0], tris_per_chunk, supers_per)
    if supers2_per is None:
        supers2_per = auto2
    grid = cg.build_chunk_grid(
        ms.vertices, faces, tris_per_chunk=tris_per_chunk,
        supers_per=supers_per, supers2_per=supers2_per,
    )
    tensor = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return (
        torch.tensor(ms.spheres.soa10(np.float64), dtype=dtype, device=device),
        tensor(grid.cboxes), tensor(grid.sboxes), tensor(pack_mesh_for_pt(grid, ms)),
        torch.tensor(ms.spheres.material, dtype=torch.int32, device=device),
        grid,
    )


def pt_tables_kwargs(grid: cg.ChunkGrid, device="cpu") -> dict:
    """The grid's keyword arguments for :func:`render_pt_mesh` (and
    ``wbvh_kernels.intersect_chunks``): one place, so no call site
    forgets the third level."""
    kw = dict(tris_per_chunk=grid.tris_per_chunk, supers_per=grid.supers_per)
    if grid.n_supers2:
        kw["ssboxes"] = torch.tensor(grid.ssboxes, device=device)
        kw["supers2_per"] = grid.supers2_per
    return kw


def camera_vector(cam, width, height) -> tuple:
    """The 11-float camera (px py pz, unit direction, cx.x, cy xyz,
    origin push) as Python floats; ``None`` is the default smallpt camera,
    as ``pt_kernels.camera_constants`` builds it."""
    if cam is None:
        return pt_kernels.camera_constants(width, height)
    vals = (cam.detach().cpu().double().reshape(-1).tolist()
            if isinstance(cam, torch.Tensor) else [float(x) for x in cam])
    if len(vals) != 11:
        raise ValueError(f"cam must be an 11-float camera vector, got {len(vals)}")
    return tuple(vals)


def _check(scene_planes, materials, cboxes, sboxes, ssboxes, tris24, *, width,
           height, spp4, bounces, rr_depth, uniforms, tris_per_chunk,
           supers_per, supers2_per, with_residuals, with_camera, with_stats,
           stats_tile):
    # The sphere-side checks are render_pt's.
    s_count, _ = pt_kernels.check_inputs(scene_planes, materials, width, height,
                                         spp4, bounces, rr_depth, uniforms)
    check_options(width * height, with_residuals, with_camera, with_stats, stats_tile)
    grid = check_grid(cboxes, sboxes, ssboxes, tris24,
                      tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                      supers2_per=supers2_per, widths=(TRI_PT_F,))
    tensors = [scene_planes, materials, cboxes, sboxes, grid[3], tris24]
    if uniforms is not None:
        tensors.append(uniforms)
    return s_count, grid, on_cpu(*tensors)


def check_options(n_pix, with_residuals, with_camera, with_stats, stats_tile):
    if with_camera and not with_residuals:
        raise ValueError("with_camera requires with_residuals (the camera backward "
                         "replays from wid[0])")
    if with_stats and (stats_tile < 1 or n_pix % stats_tile):
        raise ValueError(f"pixel count {n_pix} not divisible by stats_tile={stats_tile}")


# ------------------------------------------------------- plain twin ----
def residual_buffers(bounces, spp4, n_pix, dtype, device):
    """(wid, resv) of the residual layout, unfilled."""
    return (torch.empty((bounces, spp4, n_pix), dtype=torch.int32, device=device),
            torch.empty((bounces, 7, spp4, n_pix), dtype=dtype, device=device))


def _outputs(img, res, suv, kstats):
    """The image alone, or (image, [wid, resv,] [suv,] [kstats]) as the
    options ask, the Pallas wrapper's order."""
    extra = [*(res or ()), *([] if suv is None else [suv]),
             *([] if kstats is None else [kstats])]
    return (img, *extra) if extra else img


def render_pt_mesh_plain(scene_planes, cboxes, sboxes, tris24, ssboxes=None, *,
                         materials, width, height, spp4, tris_per_chunk,
                         supers_per=0, supers2_per=0, bounces=8, rr_depth=5,
                         eps=1e-4, seed=0, cam=None, uniforms=None,
                         with_residuals=False, with_camera=False, with_stats=False,
                         stats_tile=2048, walk_counts=None, debug=False,
                         debug_tile=DEBUG_TILE):
    """Plain twin of :func:`render_pt_mesh`: the kernel's arithmetic and
    random stream as torch ops, one sample layer at a time; the mesh is
    walked for the live paths only.  ``walk_counts``, an int64 [bounces,
    5] tensor when given, is added to in place, a row per bounce: the
    rays walked, summed over them ``walk_plain``'s counts (chunks tested,
    supers hit, super-supers hit), and the rays that enter the kernel's
    root box (:func:`root_entries`), the walk's work for a bound.
    ``debug`` prints the dump's lines from torch."""
    *_, ssboxes = check_grid(cboxes, sboxes, ssboxes, tris24,
                             tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                             supers2_per=supers2_per, widths=(TRI_PT_F,))
    n_pix = width * height
    check_options(n_pix, with_residuals, with_camera, with_stats, stats_tile)
    dtype, device = scene_planes.dtype, scene_planes.device
    s_count = scene_planes.shape[1]
    planes_pad, mat_pad = pt_kernels.pad_scene(scene_planes, materials)
    grid = plain_grid(cboxes, sboxes, ssboxes, tris24, dtype,
                      tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                      supers2_per=supers2_per)
    n_tiles = n_pix // stats_tile if with_stats else 0
    kstats = (torch.zeros((3 * bounces, n_tiles * spp4), dtype=torch.int32, device=device)
              if with_stats else None)

    def hit_fn(o3, d3, alive, layer, k):
        tmin, win = pt_kernels.sphere_hits(planes_pad, *o3, *d3, eps)
        slot = torch.full(tmin.shape, -1, dtype=torch.int64, device=tmin.device)
        ids = alive.nonzero()[:, 0]
        dump_k = debug and layer == 0
        worklist_k = 0
        if ids.numel():
            tsub = tmin[ids]
            gate = tsub.clone()  # the tmin after the spheres, before the triangles
            counts = (None if walk_counts is None else
                      torch.zeros((3, ids.numel()), dtype=torch.int32, device=tmin.device))
            # the boxes the live paths of cell (0, 0) (group 0) enter, and
            # those each tile's live paths enter
            dump_marks = level_marks(grid, (ids >= debug_tile).long(), 2) if dump_k else None
            stats_marks = (level_marks(grid, ids // stats_tile, n_tiles)
                           if kstats is not None else None)
            marks = [m for m in (dump_marks, stats_marks) if m is not None]
            slot[ids] = walk_plain(grid, tuple(c[ids] for c in o3),
                                   tuple(c[ids] for c in d3), tsub, eps=eps, gate=gate,
                                   counts=counts, marks=marks or None)
            if dump_k:
                worklist_k = int(dump_marks[1][0][0].sum())
            tmin = tmin.index_put((ids,), tsub)
            if counts is not None:
                walk_counts[k, 0] += ids.numel()
                walk_counts[k, 1:4] += counts.sum(dim=1)
                walk_counts[k, 4] += int(root_entries(
                    grid, tuple(c[ids] for c in o3), tuple(c[ids] for c in d3), gate).sum())
            if kstats is not None:
                for level, m in enumerate(stats_marks[1]):
                    kstats[level * bounces + k, layer::spp4] = m.sum(dim=1, dtype=torch.int32)
        if dump_k:
            print(f"mesh_pt worklist k: {worklist_k}", flush=True)
        code = torch.where(slot >= 0, s_count + slot, win)
        return tmin, pt_kernels.surface(planes_pad, mat_pad, win, tmin, o3, d3,
                                        grid.rows, slot), code

    res = residual_buffers(bounces, spp4, n_pix, dtype, device) if with_residuals else None
    suv = torch.empty((2, spp4, n_pix), dtype=dtype, device=device) if with_camera else None
    img = pt_kernels.render_layers(
        hit_fn, dtype=dtype, device=device, width=width,
        height=height, spp4=spp4, bounces=bounces, rr_depth=rr_depth, eps=eps,
        seed=seed, uniforms=uniforms, cam=camera_vector(cam, width, height),
        res=res, suv=suv,
        dump=pt_kernels.alive_dump("mesh_pt alive", debug_tile) if debug else None,
    )
    return _outputs(img, res, suv, kstats)


#: ``csrc/warp_walk.cuh``'s ROOT_MAX_BOXES: the kernel's walk tests a root
#: box where the grid's top level has at most this many boxes.
ROOT_MAX_BOXES = 4096


def root_entries(grid: PlainGrid, o3, d3, gate=None):
    """[M] bool: the rays whose test of the warp walk's root box passes
    (``warp_walk.cuh``'s init_root and enters_root): the box is the union
    of the top level's boxes (NaN bounds ignored), a NaN in the test
    counts as entering, and every ray enters where the top level has more
    than ROOT_MAX_BOXES boxes.  Only those rays test the top level's
    boxes; every ray entering one of them enters the root.  ``gate`` [M]
    bounds the entry (the path tracer's sphere tmin); None, the traversal
    kernel's unbounded test."""
    top = grid.ssboxes or grid.sboxes or grid.cboxes
    if len(top) > ROOT_MAX_BOXES:
        return torch.ones(o3[0].shape, dtype=torch.bool, device=o3[0].device)
    b = np.asarray(top, dtype=np.float32).reshape(-1, 6)
    corners = (np.fmin(b[:, :3], b[:, 3:]), np.fmax(b[:, :3], b[:, 3:]))
    root = [*np.fmin.reduce(corners[0], axis=0).tolist(),
            *np.fmax.reduce(corners[1], axis=0).tolist()]
    inv = [1.0 / torch.where(d == 0, 1e-30, d) for d in d3]
    t1 = [(root[a] - o3[a]) * inv[a] for a in range(3)]
    t2 = [(root[a + 3] - o3[a]) * inv[a] for a in range(3)]
    lo = [torch.minimum(x, y) for x, y in zip(t1, t2)]
    hi = [torch.maximum(x, y) for x, y in zip(t1, t2)]
    tnear = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tfar = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    zero = torch.zeros((), dtype=tnear.dtype, device=tnear.device)
    enters = ~(tfar < torch.maximum(tnear, zero))
    return enters if gate is None else enters & ~(tnear >= gate)


def _slab_all(boxes, ray, gate):
    """_slab_tmin of every box against every ray -> [M, B] bool, the
    op order of ``wbvh_kernels._slab`` (NaN-propagating min/max); with
    ``gate`` None, _slab (no entry bound)."""
    b = torch.tensor(boxes, dtype=ray[0].dtype, device=ray[0].device).reshape(-1, 6).T
    o, inv = ray[:3], ray[3:]
    t1 = [(b[i][None] - o[i][:, None]) * inv[i][:, None] for i in range(3)]
    t2 = [(b[i + 3][None] - o[i][:, None]) * inv[i][:, None] for i in range(3)]
    lo = [torch.minimum(a, c) for a, c in zip(t1, t2)]
    hi = [torch.maximum(a, c) for a, c in zip(t1, t2)]
    tnear = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tfar = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    hit = tfar >= torch.maximum(tnear, torch.zeros((), dtype=tnear.dtype))
    return hit if gate is None else hit & (tnear < gate[:, None])


def walk_pairs_plain(grid: PlainGrid, o3, d3, tmin, *, eps, gate, generator=None, step=32,
                     counts=None):
    """The answer of the kernel's warp walk (``csrc/warp_walk.cuh``) as
    torch ops, for tests: every (ray, triangle) pair of every chunk whose
    box the ray enters (through its super-super's and super's boxes; every
    box gated by ``gate``), taken ``step`` pairs at a time in the order
    ``order`` (a permutation of the pairs; default ray by ray, chunks and
    rows in order), each step folded into each ray's lexicographic minimum
    of (t, slot) as the kernel folds it: t first, then the lowest slot at
    that t, and a step that lowers a ray's t voids the slot kept for the
    larger one.  A triangle must beat ``tmin`` [M] strictly, which takes
    the winner's t in place.  ``gate`` None: the boxes are not gated (the
    traversal kernel's walk, ``csrc/wbvh.cu``).  ``counts`` [3, M] int32
    (chunks entered, supers hit, super-supers hit per ray, each box a ray
    enters through its parents) are added to in place.  Returns slot [M]
    int64, -1 where none wins: what :func:`walk_plain`'s strict running
    minimum in slot order gives."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    inv = [1.0 / torch.where(d == 0, 1e-30, d) for d in d3]
    ray = (ox, oy, oz, *inv)
    m, T = ox.shape[0], grid.tris_per_chunk
    enter = _slab_all(grid.cboxes, ray, gate)  # [M, C]
    sup = sup2 = None
    if grid.sboxes:
        sup = _slab_all(grid.sboxes, ray, gate)
        if grid.ssboxes:
            sup2 = _slab_all(grid.ssboxes, ray, gate)
            sup = sup & sup2.repeat_interleave(grid.supers2_per, dim=1)
        enter = enter & sup.repeat_interleave(grid.supers_per, dim=1)
    if counts is not None:
        for level, hit in enumerate((enter, sup, sup2)):
            if hit is not None:
                counts[level] += hit.sum(dim=1).to(counts.dtype)
    rc = enter.nonzero()  # (ray, chunk) pairs, ray-major
    ray_p = rc[:, 0].repeat_interleave(T)
    slot_p = (rc[:, 1:2] * T + torch.arange(T, device=ox.device)).reshape(-1)
    if generator is not None:
        order = torch.randperm(ray_p.shape[0], generator=generator).to(ray_p.device)
        ray_p, slot_p = ray_p[order], slot_p[order]
    row = grid.rows[slot_p].T  # [24, P]
    rox, roy, roz, rdx, rdy, rdz = (c[ray_p] for c in (*o3, *d3))
    nd = row[3] * rdx + row[4] * rdy + row[5] * rdz
    no = row[3] * rox + row[4] * roy + row[5] * roz
    t = (row[12] - no) / nd
    wx = (rox - row[0]) + t * rdx
    wy = (roy - row[1]) + t * rdy
    wz = (roz - row[2]) + t * rdz
    u = row[6] * wx + row[7] * wy + row[8] * wz
    v = row[9] * wx + row[10] * wy + row[11] * wz
    cand = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps) & (t < tmin[ray_p])
    none = torch.iinfo(torch.int64).max
    best_t = torch.full((m,), float("inf"), dtype=ox.dtype, device=ox.device)
    best_slot = torch.full((m,), none, dtype=torch.int64, device=ox.device)
    at = cand.nonzero()[:, 0]
    for s in torch.unique(at // step).tolist():  # the steps with a candidate
        sel = at[(at >= s * step) & (at < (s + 1) * step)]
        r, ts, ss = ray_p[sel], t[sel], slot_p[sel]
        before = best_t[r]
        best_t.scatter_reduce_(0, r, ts, reduce="amin")
        win = ts == best_t[r]
        best_slot[r[win & (ts < before)]] = none
        best_slot.scatter_reduce_(0, r[win], ss[win], reduce="amin")
    won = best_slot != none
    tmin[won] = best_t[won]
    return torch.where(won, best_slot, -1)


# ---------------------------------------------------------- wrapper ----
@spanned("apt.kernel.mesh_pt")
def render_pt_mesh(scene_planes, cboxes, sboxes, tris24, ssboxes=None, *,
                   materials, width, height, spp4, tris_per_chunk,
                   supers_per=0, supers2_per=0, bounces=8, rr_depth=5,
                   eps=1e-4, seed=0, cam=None, uniforms=None,
                   with_residuals=False, with_camera=False, with_stats=False,
                   stats_tile=2048, debug=False, debug_tile=DEBUG_TILE):
    """Fully fused sphere+mesh path trace: scene [10, S] (float32 or
    float64; the compute dtype), materials [S] int32, a chunk grid of
    float32 boxes and [C*T, 24] rows (``mesh_pt_tables``) -> per-pixel
    means [3, W*H] in the scene's dtype; with any option, (image, [wid,
    resv,] [suv,] [kstats]) as the module's head describes.  ``cam`` is
    the 11-float camera vector (None: the default smallpt camera);
    ``uniforms`` [spp4, 2 + 3 * bounces, W*H] replaces the Philox stream.
    Pixel p is column p // height, row p % height; sample layer a is (sy,
    sx, k) = (a // (2s), (a // s) % 2, a % s) with s = spp4 / 4.
    ``debug`` prints the dump of the module's head (on a card the call
    returns once the lines are out)."""
    if debug_tile < 1:
        raise ValueError(f"debug_tile must be >= 1, got {debug_tile}")
    s_count, (c, cs, css, ssboxes), cpu = _check(
        scene_planes, materials, cboxes, sboxes, ssboxes, tris24, width=width,
        height=height, spp4=spp4, bounces=bounces, rr_depth=rr_depth,
        uniforms=uniforms, tris_per_chunk=tris_per_chunk, supers_per=supers_per,
        supers2_per=supers2_per, with_residuals=with_residuals,
        with_camera=with_camera, with_stats=with_stats, stats_tile=stats_tile,
    )
    cam_vals = camera_vector(cam, width, height)
    kw = dict(materials=materials, width=width, height=height, spp4=spp4,
              tris_per_chunk=tris_per_chunk, supers_per=supers_per,
              supers2_per=supers2_per, bounces=bounces, rr_depth=rr_depth,
              eps=eps, seed=seed, cam=cam_vals, uniforms=uniforms,
              with_residuals=with_residuals, with_camera=with_camera,
              with_stats=with_stats, stats_tile=stats_tile, debug=debug,
              debug_tile=debug_tile)
    if cpu:
        return render_pt_mesh_plain(scene_planes, cboxes, sboxes, tris24, ssboxes, **kw)
    if tris24.data_ptr() % 16:  # the kernel reads rows 16 bytes at a time
        tris24 = tris24.clone()
    n_pix = width * height
    dtype, device = scene_planes.dtype, scene_planes.device
    out = torch.empty((3, n_pix), dtype=dtype, device=device)
    res = residual_buffers(bounces, spp4, n_pix, dtype, device) if with_residuals else None
    suv = torch.empty((2, spp4, n_pix), dtype=dtype, device=device) if with_camera else None
    kstats = marks = None
    if with_stats:
        cells = n_pix // stats_tile * spp4
        kstats = torch.empty((3 * bounces, cells), dtype=torch.int32, device=device)
        words = sum(-(-n // 32) for n in (c, cs, css))  # the kernel zeroes them
        marks = torch.empty((cells * bounces * words,), dtype=torch.int32, device=device)
    dump_bits = dump_alive = None
    if debug and bounces:
        dump_bits = torch.zeros((bounces * -(-c // 32),), dtype=torch.int32, device=device)
        dump_alive = torch.zeros((bounces,), dtype=torch.int32, device=device)
    lib = load_library()
    if debug:
        sys.stdout.flush()  # Python's lines before the kernel's

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"apt_render_pt_mesh_{_DTYPES[dtype]}")(
            scene_planes.data_ptr(), materials.data_ptr(), cboxes.data_ptr(),
            ptr(sboxes), ptr(ssboxes), tris24.data_ptr(), ptr(uniforms), out.data_ptr(),
            *(ptr(t) for t in (res or (None, None))), ptr(suv), ptr(kstats), ptr(marks),
            stats_tile, ptr(dump_bits), ptr(dump_alive), debug_tile,
            width, height, spp4, s_count, c, cs, css, tris_per_chunk,
            supers_per, supers2_per, bounces, rr_depth, eps, seed & 0xFFFFFFFF,
            (ctypes.c_double * 11)(*cam_vals), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"apt_render_pt_mesh: CUDA error {err} "
            f"({lib.apt_mesh_pt_error_string(err).decode()})"
        )
    LAUNCHES["mesh_pt"] += 1
    return _outputs(out, res, suv, kstats)
