"""Triangle-mesh scenes and the combined sphere+mesh path tracer.

Counterpart of ``ascendpathtracing_tpu/models/mesh.py``: ``MeshScene``,
its device tables (:func:`mesh_scene_to_device`) in the four traversal
modes, the nearest-triangle query (:func:`_mesh_hit`), the first-hit
render (:func:`first_hit_mesh_impl`) and the bounce-loop path tracer
(:func:`render_pt_mesh_impl`, the JAX package's XLA-loop renderer; the
fused renderer is ``ops/mesh_pt_kernels.render_pt_mesh``).

Traversal modes (``StaticConf.traversal``):

- ``chunks``: the chunk-grid traversal (``ops/wbvh_kernels``: the CUDA
  kernel ``csrc/wbvh.cu`` on a card, its twin on the CPU) over slot-ordered
  tables.  ``diff=False`` takes the winner's 11 shading planes from the
  kernel; ``diff=True`` recomputes t from the detached winner's plane
  equation and gathers the shading from the (traced) slot planes, so
  autograd reaches them.
- ``lockstep``: the stackless BVH traversal (``ops/bvh_kernels``: the
  CUDA kernel ``csrc/bvh.cu``, its twin on the CPU) over leaf-ordered
  tables.
- ``jnp``: the per-ray BVH walk in plain torch (``accel/bvh``), in the
  rays' dtype: the CPU and float64 oracle.
- ``brute``: Moller-Trumbore over every face (``accel/tri``).

The kernels take float32 rays, as the TPU kernels do.  Before a kernel,
rays are sorted by a 6-D Morton key once there are ``_SORT_MIN_N`` of
them (per-ray results do not change).  Hit decisions are detached.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ascendpathtracing_tpu_torch import scenes
from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import tri as tri_mod
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.models.megakernel import select_by_id
from ascendpathtracing_tpu_torch.ops import bvh_kernels
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import histogram_kernels
from ascendpathtracing_tpu_torch.ops import shade
from ascendpathtracing_tpu_torch.ops import sort as sort_mod
from ascendpathtracing_tpu_torch.ops import wbvh_kernels
from ascendpathtracing_tpu_torch.ops.intersect import MISS_T

DIFF, REFR = scenes.DIFF, scenes.REFR


class StaticConf(NamedTuple):
    """The traversal configuration carried beside the device tables (the
    JAX package's fields, in its order)."""

    traversal: str  # chunks | lockstep | jnp | brute
    max_leaf: int
    tris_per_chunk: int
    supers_per: int
    # diff=True: t recomputed from the winner's plane equation and the
    # shading gathered from the slot planes, so autograd reaches them;
    # diff=False: the chunk kernel returns the winner's shading planes.
    diff: bool = False
    supers2_per: int = 0  # third chunk-grid level (>= 1M-triangle scenes)


@dataclasses.dataclass
class MeshScene:
    """Spheres (enclosure + light) + one triangle soup with per-face
    attributes."""

    spheres: scenes.SphereScene
    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]
    face_albedo: np.ndarray  # [F, 3]
    face_emission: np.ndarray  # [F, 3]
    face_material: np.ndarray  # [F] int32

    @staticmethod
    def cornell_with_mesh(
        vertices, faces, albedo=(0.75, 0.75, 0.75), emission=(0, 0, 0),
        material=scenes.DIFF, base_scene: str = "smallpt9",
    ) -> "MeshScene":
        f = np.asarray(faces).shape[0]
        return MeshScene(
            spheres=scenes.get_scene(base_scene),
            vertices=np.asarray(vertices, np.float64),
            faces=np.asarray(faces, np.int64),
            face_albedo=np.tile(np.asarray(albedo, np.float64), (f, 1)),
            face_emission=np.tile(np.asarray(emission, np.float64), (f, 1)),
            face_material=np.full((f,), material, np.int32),
        )


def _planes(a, dtype, device):
    return tuple(torch.tensor(a[:, i], dtype=dtype, device=device) for i in range(3))


def _unit_normals(e1, e2):
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
    return fn


def mesh_scene_to_device(
    ms: MeshScene, *, device="cpu", dtype=torch.float32, use_bvh=True, max_leaf=None,
    pallas_bvh_kernel=False, pallas_kernel: str = "chunks", tris_per_chunk: int = 16,
    diff: bool = False,
):
    """MeshScene -> dict of tables, with the traversal config under
    ``"static"``.  The arguments are the JAX package's:

    - ``pallas_bvh_kernel=True, pallas_kernel="chunks"``: the chunk-grid
      traversal over 24-float slot rows (``wbvh``), ``face_of_slot``, the
      live chunks' bounds (``wbvh_bounds``, for the ray sort) and the
      slot-ordered geometry and attribute planes; ``supers_per`` 16 once
      there are 128 chunks and ``supers2_per`` 16 once there are 256
      supers.
    - ``pallas_bvh_kernel=True, pallas_kernel="lockstep"``: the BVH
      traversal kernel over ``pallas_bvh`` (``ops/bvh_kernels.pack_bvh``)
      and leaf-ordered planes; ``max_leaf`` defaults to 64.
    - ``use_bvh=True`` alone: the per-ray walk (``jnp`` mode) over ``bvh``
      (``accel/bvh.bvh_to_device``) and leaf-ordered planes; ``max_leaf``
      defaults to 4.
    - ``use_bvh=False``: brute force over the planes in face order.

    The BVH is ``accel/bvh.build_bvh``'s: the C++ builder
    (``accel/native.py``) where its library builds, as in the JAX package,
    else the NumPy builder, whose tables differ; ``convert.mesh_dev_from_jax``
    carries the JAX package's own tables.  Planes are in ``dtype``; the
    kernels' tables are float32.
    """
    if pallas_kernel not in ("chunks", "lockstep"):
        raise ValueError(f"unknown pallas_kernel {pallas_kernel!r}")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    sph = megakernel.scene_to_device(ms.spheres, device=device, dtype=dtype)
    v = np.asarray(ms.vertices, np_dtype)
    f = np.asarray(ms.faces)

    if pallas_bvh_kernel and pallas_kernel == "chunks":
        supers_per, supers2_per = cg.auto_levels(f.shape[0], tris_per_chunk)
        grid = cg.build_chunk_grid(
            v, f, tris_per_chunk=tris_per_chunk, supers_per=supers_per,
            supers2_per=supers2_per,
        )
        cb, sb, _t13, fos = cg.chunk_grid_to_device(grid, device)
        t24 = torch.tensor(cg.attr_triangle_rows(
            grid, ms.face_albedo, ms.face_emission, ms.face_material,
            diff_code=DIFF, refr_code=REFR,
        ), device=device)
        live = grid.cboxes[:, 0] <= grid.cboxes[:, 3]
        lo = torch.tensor(grid.cboxes[live, 0:3].min(0), device=device)
        hi = torch.tensor(grid.cboxes[live, 3:6].max(0), device=device)

        def perm(a, pad=0):
            return cg.permute_face_attrib(grid, a, pad)

        tri = v[f]
        e1n = perm(tri[:, 1] - tri[:, 0])
        e2n = perm(tri[:, 2] - tri[:, 0])
        return {
            "spheres": sph,
            "v0": _planes(perm(tri[:, 0]), dtype, device),
            "e1": _planes(e1n, dtype, device),
            "e2": _planes(e2n, dtype, device),
            "fnormal": _planes(_unit_normals(e1n, e2n), dtype, device),
            "f_albedo": _planes(perm(np.asarray(ms.face_albedo, np_dtype)), dtype, device),
            "f_emission": _planes(perm(np.asarray(ms.face_emission, np_dtype)), dtype,
                                  device),
            "f_material": torch.tensor(perm(np.asarray(ms.face_material, np.int32)),
                                       device=device),
            "bvh": None,
            "pallas_bvh": None,
            "wbvh": (cb, sb, t24, torch.tensor(grid.ssboxes, device=device)),
            "wbvh_bounds": (lo, hi),
            "face_of_slot": fos,
            "static": StaticConf("chunks", 0, grid.tris_per_chunk, grid.supers_per, diff,
                                 grid.supers2_per),
            "max_leaf": 0,
        }

    if max_leaf is None:
        # fat leaves for the kernel (a shallow tree), small ones for the
        # per-ray walk, as the JAX package picks them
        max_leaf = 64 if pallas_bvh_kernel else 4
    if use_bvh:
        bvh = bvh_mod.build_bvh(v, f, max_leaf=max_leaf)
        order = bvh.tri_order
        bvh_dev = bvh_mod.bvh_to_device(bvh, device, dtype)
    else:
        bvh = None
        order = np.arange(f.shape[0])
        bvh_dev = None
    planes = tuple(tuple(c[order] for c in t)
                   for t in tri_mod.triangle_planes(v, f, dtype=np_dtype))
    v0, e1, e2 = (np.stack(t, 1) for t in planes)
    traversal = "lockstep" if (use_bvh and pallas_bvh_kernel) else (
        "jnp" if use_bvh else "brute")
    return {
        "spheres": sph,
        "v0": _planes(v0, dtype, device),
        "e1": _planes(e1, dtype, device),
        "e2": _planes(e2, dtype, device),
        "fnormal": _planes(_unit_normals(e1, e2), dtype, device),
        "f_albedo": _planes(ms.face_albedo[order], dtype, device),
        "f_emission": _planes(ms.face_emission[order], dtype, device),
        "f_material": torch.tensor(ms.face_material[order], dtype=torch.int32, device=device),
        "bvh": bvh_dev,
        "pallas_bvh": (bvh_kernels.pack_bvh(bvh, planes, device)
                       if traversal == "lockstep" else None),
        # the non-chunks paths are differentiable as they are
        "static": StaticConf(traversal, max_leaf if use_bvh else 0, 0, 0,
                             traversal in ("jnp", "brute")),
        "max_leaf": max_leaf if use_bvh else 0,
    }


class _GatherPlanes(torch.autograd.Function):
    """(idx [N], planes...) -> each [S] plane's values at idx.  The
    backward sums each plane's cotangent by idx with the segment-sum
    (``ops/histogram_kernels``: ``csrc/segsum.cu`` on a card, eight planes
    per launch): autograd's own backward of ``plane[idx]`` (a sorted
    ``index_put_``) serializes each run of equal indices, and a render's
    millions of rays that miss the mesh all carry slot 0."""

    @staticmethod
    def forward(ctx, idx, *planes):
        ctx.save_for_backward(idx)
        ctx.n_slots = planes[0].shape[0]
        return tuple(p[idx] for p in planes)

    @staticmethod
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        seg = idx.to(torch.int32)
        want = [i for i in range(len(grads)) if ctx.needs_input_grad[1 + i]]
        out = [None] * len(grads)
        per = histogram_kernels.MAX_ROWS
        for c in range(0, len(want), per):
            part = want[c:c + per]
            acc = histogram_kernels.segment_rows_matmul(
                seg, torch.stack([grads[i] for i in part]), n_slots=ctx.n_slots)
            for j, i in enumerate(part):
                out[i] = acc[:, j]
        return (None, *out)


def _gather(planes, idx):
    """``tuple(p[idx] for p in planes)``, through :class:`_GatherPlanes`
    where a plane needs a gradient."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in planes):
        return _GatherPlanes.apply(idx, *planes)
    return tuple(p[idx] for p in planes)


# The JAX package sorts once there are this many rays (measured there; the
# port keeps the threshold so both take the same path).
_SORT_MIN_N = 131072


def _mesh_hit(o3, d3, dev, eps, static: StaticConf | None = None, sort=True):
    """Nearest triangle of each ray -> (tmin, hit, miss, attrs).

    chunks/lockstep: the traversal kernel on float32 rays (detached), tmin
    cast back to the rays' dtype; with ``sort`` and at least
    ``_SORT_MIN_N`` rays, the rays go to the kernel in the order of a
    stable sort by ``ops/sort.ray_sort_keys_6d`` and the results come back
    to the caller's order.  hit is the slot (chunks), the leaf-order
    triangle (lockstep, jnp) or the face (brute).  attrs is the chunk
    kernel's 11 winner planes (nx ny nz ar ag ab er eg eb is_diff is_refr)
    in chunks mode with ``diff`` False, else None.  With ``diff`` True,
    chunks mode recomputes t from the detached winner's planes, so the
    gradient reaches ``dev["v0"/"e1"/"e2"]``."""
    static = dev["static"] if static is None else static
    if static.traversal in ("chunks", "lockstep"):
        n = o3[0].shape[0]
        dtype = o3[0].dtype
        o3_orig, d3_orig = o3, d3  # caller order, for the recompute below
        with_attrs = static.traversal == "chunks" and not static.diff
        order = None
        if sort and n >= _SORT_MIN_N:
            if static.traversal == "chunks":
                lo, hi = dev["wbvh_bounds"]
            else:
                lo, hi = dev["pallas_bvh"][0][0, 0:3], dev["pallas_bvh"][0][0, 3:6]
            keys = sort_mod.ray_sort_keys_6d(o3, d3, lo, hi)
            _, order = torch.sort(keys, stable=True)
            o3 = tuple(c[order] for c in o3)
            d3 = tuple(c[order] for c in d3)
        rp = torch.stack([*o3, *d3]).detach().to(torch.float32)
        attrs = None
        if static.traversal == "chunks":
            cb, sb, t24, ssb = dev["wbvh"]
            out = wbvh_kernels.intersect_chunks(
                rp, cb, sb, t24, ssb, tris_per_chunk=static.tris_per_chunk,
                supers_per=static.supers_per, supers2_per=static.supers2_per, eps=eps,
                attrs=with_attrs,
            )
            tmin, hit = out[0], out[1]
            if with_attrs:
                attrs = tuple(a.to(dtype) for a in out[2])
        else:
            nodesf, nodesi, tris9 = dev["pallas_bvh"]
            tmin, hit = bvh_kernels.intersect_bvh(rp, nodesf, nodesi, tris9,
                                                  max_leaf=static.max_leaf, eps=eps)
        tmin = tmin.to(dtype)
        if order is not None:
            def unsort(x):
                out = torch.empty_like(x)
                out[order] = x
                return out

            tmin, hit = unsort(tmin), unsort(hit)
            if attrs is not None:
                attrs = tuple(unsort(a) for a in attrs)
        miss = tmin >= MISS_T
        if static.traversal == "chunks" and static.diff:
            # Detach the discrete decision (the winning slot), differentiate
            # the continuous one: t from the winner's plane equation, the
            # same formula the kernel uses, in the rays' dtype.
            g = _gather((*dev["v0"], *dev["e1"], *dev["e2"]), hit.long())
            v0g, e1g, e2g = g[0:3], g[3:6], g[6:9]
            nx = e1g[1] * e2g[2] - e1g[2] * e2g[1]
            ny = e1g[2] * e2g[0] - e1g[0] * e2g[2]
            nz = e1g[0] * e2g[1] - e1g[1] * e2g[0]
            d0 = nx * v0g[0] + ny * v0g[1] + nz * v0g[2]
            no = nx * o3_orig[0] + ny * o3_orig[1] + nz * o3_orig[2]
            nd = nx * d3_orig[0] + ny * d3_orig[1] + nz * d3_orig[2]
            # double where: a missed ray's slot 0 can give nd = 0, and the
            # guard keeps that NaN out of the gradient
            nd = torch.where(miss, 1.0, nd)
            tmin = torch.where(miss, MISS_T, (d0 - no) / nd)
        return tmin, hit, miss, attrs
    if static.traversal == "jnp":
        tmin, hit, miss = bvh_mod.intersect_bvh(
            o3, d3, dev["bvh"], (dev["v0"], dev["e1"], dev["e2"]), eps)
        return tmin, hit, miss, None
    ts = tri_mod.intersect_triangles_brute(o3, d3, dev["v0"], dev["e1"], dev["e2"], eps)
    tmin = torch.amin(ts, dim=0)
    hit = torch.argmin(ts, dim=0).to(torch.int32)
    return tmin, hit, tmin >= MISS_T, None


def first_hit_mesh_impl(rays, dev, *, eps=1e-4, static: StaticConf | None = None):
    """First-hit query of [N, 6] rays -> (t, kind, id): kind 0 = miss,
    1 = sphere, 2 = triangle; id the sphere index or the triangle's slot
    (chunks), leaf-order index (lockstep, jnp) or face (brute)."""
    o3, d3 = megakernel.rays_to_soa(rays)
    st, sh, sm = megakernel.default_hit_fn(o3, d3, dev["spheres"], eps)
    tt, th, tm, _ = _mesh_hit(o3, d3, dev, eps, static, sort=False)
    tri_closer = tt < st
    kind = torch.where(
        tri_closer, torch.where(tm, 0, 2), torch.where(sm, 0, 1)
    ).to(torch.int32)
    return torch.minimum(st, tt), kind, torch.where(tri_closer, th, sh)


def pt_mesh_bounce(o3, d3, tput, rad, alive, u, dev, eps, static: StaticConf, *,
                   sort=False, query=None):
    """One bounce of the smallpt estimator over spheres + mesh ->
    (o3, d3, tput, rad, live), as ``megakernel.pt_bounce``: a triangle
    wins where strictly nearer.  ``query`` = (o3, d3) sends other rays to
    the two nearest-hit queries (the wavefront's dead lanes parked on a
    ray that misses at once); the shading reads ``o3``, ``d3``."""
    qo3, qd3 = (o3, d3) if query is None else query
    sph = dev["spheres"]
    cx, cy, cz = (sph["center"][:, i] for i in range(3))
    st, shit, smiss = megakernel.default_hit_fn(qo3, qd3, sph, eps)
    tt, thit, tmiss, tattrs = _mesh_hit(qo3, qd3, dev, eps, static, sort=sort)
    use_tri = tt < st
    tmin = torch.where(use_tri, tt, st)
    miss = smiss & tmiss
    live = alive & ~miss
    shit = torch.where(smiss, 0, shit).long()

    hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
    s_chit = (select_by_id(shit, cx), select_by_id(shit, cy), select_by_id(shit, cz))
    s_nrm = shade.v3_normalize(shade.v3_sub(hp, s_chit))
    if tattrs is not None:
        # the chunk kernel carried the winner's shading planes out
        t_nrm, t_alb, t_emi = tattrs[0:3], tattrs[3:6], tattrs[6:9]
        t_is_diff = tattrs[9] > 0.5
        t_is_refr = tattrs[10] > 0.5
    else:
        th = thit.long()
        g = _gather((*dev["fnormal"], *dev["f_albedo"], *dev["f_emission"]), th)
        t_nrm, t_alb, t_emi = g[0:3], g[3:6], g[6:9]
        t_mat = dev["f_material"][th]
        t_is_diff = t_mat == DIFF
        t_is_refr = t_mat == REFR
    nrm = shade.v3_where(use_tri, t_nrm, s_nrm)
    into = shade.v3_dot(d3, nrm) < 0
    nl = shade.v3_scale(nrm, shade.where_const(into, 1.0, -1.0, tmin))

    s_mat = select_by_id(shit, sph["material"])
    surface = (
        shade.v3_where(use_tri, t_emi, tuple(select_by_id(shit, sph["emission"][:, i])
                                             for i in range(3))),
        shade.v3_where(use_tri, t_alb, tuple(select_by_id(shit, sph["albedo"][:, i])
                                             for i in range(3))),
        torch.where(use_tri, t_is_diff, s_mat == DIFF),
        torch.where(use_tri, t_is_refr, s_mat == REFR),
        # scale-aware offset for sphere winners; triangle winners are
        # scene-scale and keep the eps floor (r2 = 0)
        torch.where(use_tri, 0.0, select_by_id(shit, sph["r2"])),
    )
    return (*megakernel.pt_scatter(o3, d3, tput, rad, live, u, (hp, nrm, into, nl),
                                   surface, eps), live)


def render_pt_mesh_impl(
    rays, dev, *, bounces: int = 8, rr_depth: int = 5, eps: float = 1e-4,
    static: StaticConf | None = None, uniforms=None, seed: int = 0,
    sort_per_bounce: bool = False, global_idx=None,
):
    """The smallpt estimator over spheres + mesh -> colors [N, 3]: the
    structure of ``megakernel.render_pt_impl`` with a two-way nearest-hit
    combine (a triangle wins when strictly nearer; :func:`pt_mesh_bounce`).

    ``uniforms``: [bounces, 3, N] in [0, 1) (the JAX version's per-bounce
    draws), or None to draw from the estimator stream of ``ops/rng`` keyed
    by (``seed``, ray index, bounce).  The ray index is ``global_idx``
    ([N] int64, the rays' places in the whole batch: the JAX version's
    indexed stream for sharded renders, ``parallel/sharded``), else
    ``arange(N)``.  ``sort_per_bounce`` sorts the
    rays before the traversal kernel of every bounce (see
    :func:`_mesh_hit`).  Gradients flow by autograd to the float tables of ``dev`` that require
    grad, through the shading and, in chunks mode with ``diff``, the
    recomputed hit distance."""
    o3, d3 = megakernel.rays_to_soa(rays)
    n = o3[0].shape[0]
    dtype, device = o3[0].dtype, o3[0].device
    static = dev["static"] if static is None else static
    megakernel._check_uniforms(uniforms, bounces, 3, n)
    ray_index = megakernel.ray_indices(global_idx, n, device) if uniforms is None else None

    zeros = torch.zeros((n,), dtype=dtype, device=device)
    ones = torch.ones((n,), dtype=dtype, device=device)
    rad = (zeros, zeros, zeros)
    tput = (ones, ones, ones)
    alive = torch.ones((n,), dtype=torch.bool, device=device)

    for depth in range(bounces):
        u = megakernel._bounce_uniforms(uniforms, seed, depth, 3, ray_index, dtype).to(dtype)
        o3, d3, tput, rad, live = pt_mesh_bounce(o3, d3, tput, rad, alive, u, dev, eps,
                                                 static, sort=sort_per_bounce)
        if depth >= rr_depth:  # Russian roulette (unbiased)
            tput, survive = shade.russian_roulette(tput, u[2])
            alive = live & survive
        else:
            alive = live
    return torch.stack(rad, dim=1)


def render_pt_mesh(rays, dev, **kw):
    """The bounce-loop mesh path trace (:func:`render_pt_mesh_impl`) with
    no gradient."""
    with torch.no_grad():
        return render_pt_mesh_impl(rays, dev, **kw)


def first_hit_mesh(rays, dev, **kw):
    """The first-hit query (:func:`first_hit_mesh_impl`) with no
    gradient."""
    with torch.no_grad():
        return first_hit_mesh_impl(rays, dev, **kw)
