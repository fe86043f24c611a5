"""Triangle-mesh scenes: the sphere world plus one triangle mesh.

Counterpart of ``ascendpathtracing_tpu/models/mesh.py``: ``MeshScene``,
its device tables (``mesh_scene_to_device``) in the ``chunks`` mode (the
chunk-grid traversal kernel, ``ops/wbvh_kernels``) and the ``brute``
mode (``accel/tri``, the oracle), the nearest-triangle query
(``_mesh_hit``) and the first-hit render (``first_hit_mesh_impl``).

Not yet ported: the jnp-BVH and lockstep traversal modes, the
differentiable ``diff=True`` recompute, the ray sort, and the XLA-loop
renderer ``render_pt_mesh_impl`` (the fused renderer is
``ops/mesh_pt_kernels.render_pt_mesh``).  Asking for them raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ascendpathtracing_tpu_torch.accel import tri as tri_mod
from ascendpathtracing_tpu_torch.host import scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import wbvh_kernels
from ascendpathtracing_tpu_torch.ops.intersect import MISS_T

NOT_PORTED = "not yet ported to ascendpathtracing_tpu_torch"


class StaticConf(NamedTuple):
    """The traversal configuration carried beside the device tables."""

    traversal: str  # chunks | brute
    tris_per_chunk: int = 0
    supers_per: int = 0
    supers2_per: int = 0


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


def mesh_scene_to_device(
    ms: MeshScene, *, device="cpu", dtype=torch.float32, use_bvh=True,
    pallas_bvh_kernel=False, pallas_kernel: str = "chunks",
    tris_per_chunk: int = 16, diff: bool = False,
):
    """MeshScene -> dict of tables, with the traversal config under
    ``"static"``.  The arguments are the JAX package's:

    - ``pallas_bvh_kernel=True, pallas_kernel="chunks"``: the chunk-grid
      traversal (the CUDA kernel on a card, its twin on the CPU) over
      24-float slot rows (``wbvh``) and ``face_of_slot``; ``supers_per``
      16 once there are 128 chunks and ``supers2_per`` 16 once there are
      256 supers.
    - ``use_bvh=False``: brute force over every face (the oracle): the
      (v0, e1, e2) planes of ``accel/tri``.

    The JAX tables' per-face normal, albedo, emission and material planes
    (and the slot-ordered geometry) serve its differentiable recompute
    and XLA-loop renderer, which are not ported, and are left out.

    The jnp-BVH (``use_bvh=True`` alone), the lockstep kernel and
    ``diff=True`` raise NotImplementedError.
    """
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    sph = megakernel.scene_to_device(ms.spheres, device=device, dtype=dtype)
    v = np.asarray(ms.vertices, np_dtype)
    f = np.asarray(ms.faces)

    if pallas_bvh_kernel and pallas_kernel == "chunks":
        if diff:
            raise NotImplementedError(f"mesh_scene_to_device(diff=True) is {NOT_PORTED}")
        supers_per, supers2_per = cg.auto_levels(f.shape[0], tris_per_chunk)
        grid = cg.build_chunk_grid(
            v, f, tris_per_chunk=tris_per_chunk, supers_per=supers_per,
            supers2_per=supers2_per,
        )
        cb, sb, _t13, fos = cg.chunk_grid_to_device(grid, device)
        t24 = torch.tensor(cg.attr_triangle_rows(
            grid, ms.face_albedo, ms.face_emission, ms.face_material,
            diff_code=scenes.DIFF, refr_code=scenes.REFR,
        ), device=device)
        return {
            "spheres": sph,
            "wbvh": (cb, sb, t24, torch.tensor(grid.ssboxes, device=device)),
            "face_of_slot": fos,
            "static": StaticConf("chunks", grid.tris_per_chunk, grid.supers_per,
                                 grid.supers2_per),
        }
    if use_bvh:
        mode = "the lockstep kernel" if pallas_bvh_kernel else "the jnp BVH traversal"
        raise NotImplementedError(f"mesh_scene_to_device with {mode} is {NOT_PORTED}")

    v0, e1, e2 = (
        tuple(torch.tensor(c, device=device) for c in t)
        for t in tri_mod.triangle_planes(v, f, dtype=np_dtype)
    )
    return {"spheres": sph, "v0": v0, "e1": e1, "e2": e2, "static": StaticConf("brute")}


def _mesh_hit(o3, d3, dev, eps):
    """Nearest triangle of each ray -> (tmin, hit, miss, attrs).

    chunks: the chunk-grid traversal on float32 rays (as the JAX
    package's, which hands its kernel float32 rays), tmin cast back to
    the rays' dtype; hit is the slot, attrs the 11 winner planes (nx ny
    nz ar ag ab er eg eb is_diff is_refr).  brute: every face, hit is the
    face, attrs None."""
    static = dev["static"]
    if static.traversal == "chunks":
        cb, sb, t24, ssb = dev["wbvh"]
        rp = torch.stack([*o3, *d3]).to(torch.float32)
        tmin, hit, attrs = wbvh_kernels.intersect_chunks(
            rp, cb, sb, t24, ssb, tris_per_chunk=static.tris_per_chunk,
            supers_per=static.supers_per, supers2_per=static.supers2_per,
            eps=eps, attrs=True,
        )
        tmin = tmin.to(o3[0].dtype)
        attrs = tuple(a.to(o3[0].dtype) for a in attrs)
        return tmin, hit, tmin >= MISS_T, attrs
    ts = tri_mod.intersect_triangles_brute(o3, d3, dev["v0"], dev["e1"], dev["e2"], eps)
    tmin = torch.amin(ts, dim=0)
    hit = torch.argmin(ts, dim=0).to(torch.int32)
    return tmin, hit, tmin >= MISS_T, None


def first_hit_mesh_impl(rays, dev, *, eps=1e-4):
    """First-hit query of [N, 6] rays -> (t, kind, id): kind 0 = miss,
    1 = sphere, 2 = triangle; id the sphere index or the triangle's slot
    (chunks) or face (brute)."""
    o3, d3 = megakernel.rays_to_soa(rays)
    st, sh, sm = megakernel.default_hit_fn(o3, d3, dev["spheres"], eps)
    tt, th, tm, _ = _mesh_hit(o3, d3, dev, eps)
    tri_closer = tt < st
    kind = torch.where(
        tri_closer, torch.where(tm, 0, 2), torch.where(sm, 0, 1)
    ).to(torch.int32)
    return torch.minimum(st, tt), kind, torch.where(tri_closer, th, sh)


def render_pt_mesh_impl(*args, **kwargs):
    """The XLA-loop mesh path tracer: not yet ported (the fused renderer
    is ``ops/mesh_pt_kernels.render_pt_mesh``)."""
    raise NotImplementedError(f"models/mesh.render_pt_mesh_impl is {NOT_PORTED}")
