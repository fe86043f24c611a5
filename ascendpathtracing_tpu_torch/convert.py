"""The JAX package's scene parameters, rays and residuals, as the port's
tensors.

Scenes and camera rays are NumPy arrays (``scenes.SphereScene.soa10``,
``camera.generate_rays_numpy``, ``models.megakernel.scene_to_device``
read back as NumPy; the mesh tables of ``pallas_mesh_pt.mesh_pt_tables``).
These functions carry those arrays, a test's uniform draws, the fused
mesh kernel's replay residuals, a BVH's tables and a whole mesh device
dict over to a device, dtype and layout, so that a test feeds both sides
the same inputs.  Nothing here imports the
JAX package: the callers hand in arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_FLOAT_KEYS = ("r2", "center", "emission", "albedo")


def scene_planes_from_numpy(
    planes, *, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """[10, S] scene planes (r2 x y z ex ey ez cr cg cb) -> a contiguous
    tensor.  Values are converted as NumPy's ``astype`` would."""
    arr = np.asarray(planes)
    if arr.ndim != 2 or arr.shape[0] != 10:
        raise ValueError(f"expected [10, S] scene planes, got {arr.shape}")
    return torch.tensor(arr, dtype=dtype, device=device)


def rays_planes_from_numpy(
    rays, *, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """[N, 6] rays (ox oy oz dx dy dz) -> contiguous [6, N] planes, the
    rays.bin layout."""
    arr = np.asarray(rays)
    if arr.ndim != 2 or arr.shape[1] != 6:
        raise ValueError(f"expected [N, 6] rays, got {arr.shape}")
    return torch.tensor(np.ascontiguousarray(arr.T), dtype=dtype, device=device)


def uniforms_from_numpy(
    uniforms, *, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """Uniform draws (NumPy, e.g. the JAX package's per-bounce
    ``jax.random.uniform`` draws stacked as [bounces, k, N]) -> a
    contiguous tensor, so that both sides of a test see the same
    randomness."""
    arr = np.asarray(uniforms)
    if arr.ndim != 3:
        raise ValueError(f"expected [bounces, k, N] uniforms, got {arr.shape}")
    return torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


def scene_dict_from_numpy(
    dev: Mapping, *, device="cpu", dtype=torch.float32
) -> dict:
    """The JAX package's ``megakernel.scene_to_device`` dict (any mapping
    whose arrays ``np.asarray`` reads) -> the port's scene dict: float
    leaves ``r2 center emission albedo`` in ``dtype``, ``material`` int32,
    ``light_index`` a Python int."""
    out = {
        k: torch.tensor(np.asarray(dev[k]), dtype=dtype, device=device)
        for k in _FLOAT_KEYS
    }
    out["material"] = torch.tensor(
        np.asarray(dev["material"]), dtype=torch.int32, device=device
    )
    out["light_index"] = int(dev["light_index"])
    return out


def mesh_tables_from_numpy(
    planes, cboxes, sboxes, ssboxes, tris, *, device="cpu", dtype=torch.float32
) -> tuple:
    """The JAX package's mesh tables (``pallas_mesh_pt.mesh_pt_tables``
    or ``pallas_wbvh.chunk_grid_to_device`` outputs, any arrays
    ``np.asarray`` reads) -> (scene planes [10, S] in ``dtype``, cboxes,
    sboxes, ssboxes, tris) with the tables float32, as the builder makes
    them; ``ssboxes`` None becomes [0, 6]."""
    boxes = []
    for name, b in (("cboxes", cboxes), ("sboxes", sboxes), ("ssboxes", ssboxes)):
        arr = np.zeros((0, 6), np.float32) if b is None else np.asarray(b)
        if arr.ndim != 2 or arr.shape[1] != 6:
            raise ValueError(f"expected [*, 6] {name}, got {arr.shape}")
        boxes.append(torch.tensor(arr, dtype=torch.float32, device=device))
    rows = np.asarray(tris)
    if rows.ndim != 2:
        raise ValueError(f"expected [C*T, F] triangle rows, got {rows.shape}")
    return (
        scene_planes_from_numpy(planes, device=device, dtype=dtype),
        *boxes,
        torch.tensor(rows, dtype=torch.float32, device=device),
    )


def flat_bvh_from_numpy(bvh):
    """A JAX ``accel/bvh.FlatBVH`` (any object with its array fields and
    ``max_leaf``) -> the port's ``FlatBVH`` with the same arrays, so that
    both packages walk the same tables (the JAX package's C++ builder and
    the NumPy builder give different ones)."""
    from ascendpathtracing_tpu_torch.accel.bvh import FlatBVH

    fields = {"bmin": np.float32, "bmax": np.float32, "first": np.int32,
              "count": np.int32, "miss": np.int32, "tri_order": np.int32}
    arrays = {k: np.array(getattr(bvh, k), dt) for k, dt in fields.items()}
    m = arrays["bmin"].shape[0]
    if arrays["bmin"].shape != (m, 3) or arrays["bmax"].shape != (m, 3) or any(
            arrays[k].shape != (m,) for k in ("first", "count", "miss")):
        raise ValueError(f"inconsistent BVH arrays: {({k: a.shape for k, a in arrays.items()})}")
    return FlatBVH(**arrays, max_leaf=int(bvh.max_leaf))


def bvh_tables_from_numpy(nodesf, nodesi, tris9, *, device="cpu") -> tuple:
    """``pack_bvh_for_pallas``'s three arrays (any arrays ``np.asarray``
    reads) -> the lockstep kernel's tables: nodesf [M, 6] float32, nodesi
    [M, 3] int32, tris9 [F, 9] float32."""
    out = []
    for name, a, dtype, width in (("nodesf", nodesf, torch.float32, 6),
                                  ("nodesi", nodesi, torch.int32, 3),
                                  ("tris9", tris9, torch.float32, 9)):
        arr = np.asarray(a)
        if arr.ndim != 2 or arr.shape[1] != width:
            raise ValueError(f"expected [*, {width}] {name}, got {arr.shape}")
        out.append(torch.tensor(arr, dtype=dtype, device=device))
    return tuple(out)


_PLANE_KEYS = ("v0", "e1", "e2", "fnormal", "f_albedo", "f_emission")


def mesh_dev_from_jax(dev: Mapping, *, device="cpu") -> dict:
    """The JAX package's ``models/mesh.mesh_scene_to_device`` dict (arrays
    ``np.asarray`` reads) -> the port's, table for table, each in its own
    dtype: the sphere dict (in the planes' dtype), the plane tuples,
    ``f_material``, ``bvh``, ``pallas_bvh``, ``wbvh``, ``wbvh_bounds``,
    ``face_of_slot``, and ``static`` as the port's ``StaticConf``."""
    from ascendpathtracing_tpu_torch.models.mesh import StaticConf

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    planes = {k: tuple(t(c) for c in dev[k]) for k in _PLANE_KEYS}
    out = {
        "spheres": scene_dict_from_numpy(dev["spheres"], device=device,
                                         dtype=planes["v0"][0].dtype),
        **planes,
        "f_material": t(dev["f_material"]).to(torch.int32),
        "bvh": None if dev.get("bvh") is None else {k: t(a) for k, a in dev["bvh"].items()},
        "pallas_bvh": (None if dev.get("pallas_bvh") is None
                       else bvh_tables_from_numpy(*dev["pallas_bvh"], device=device)),
        "static": StaticConf(*tuple(dev["static"])),
        "max_leaf": int(dev.get("max_leaf", 0)),
    }
    if dev.get("wbvh") is not None:
        out["wbvh"] = tuple(t(a) for a in dev["wbvh"])
        out["wbvh_bounds"] = tuple(t(a) for a in dev["wbvh_bounds"])
        out["face_of_slot"] = t(dev["face_of_slot"]).to(torch.int32)
    return out


def residuals_from_jax(wid, resv, *, spp4, tile, device="cpu", dtype=torch.float32):
    """The Pallas mesh kernel's replay residuals (``render_pt_mesh_pallas(
    with_residuals=True)``: wid [B, nb*spp4, 8, tile//8] float32 codes,
    resv [B, 7, nb*spp4, 8, tile//8]; cell = b*spp4 + a, pixel = b*tile +
    sub*(tile//8) + lane) -> the port's layout: wid int32 [B, spp4, W*H]
    and resv [B, 7, spp4, W*H] in ``dtype``."""
    w = np.asarray(wid)
    r = np.asarray(resv)
    if w.ndim != 4 or r.ndim != 5 or w.shape[2] * w.shape[3] != tile:
        raise ValueError(f"expected wid [B, cells, 8, {tile // 8}] and resv "
                         f"[B, 7, cells, 8, {tile // 8}], got {w.shape}, {r.shape}")
    b, cells = w.shape[:2]
    if cells % spp4 or r.shape != (b, 7, cells) + w.shape[2:]:
        raise ValueError(f"wid {w.shape} and resv {r.shape} do not match spp4={spp4}")
    nb = cells // spp4
    w = w.reshape(b, nb, spp4, tile).transpose(0, 2, 1, 3).reshape(b, spp4, nb * tile)
    r = r.reshape(b, 7, nb, spp4, tile).transpose(0, 1, 3, 2, 4).reshape(
        b, 7, spp4, nb * tile)
    return (torch.tensor(np.rint(w).astype(np.int32), device=device),
            torch.tensor(np.ascontiguousarray(r), dtype=dtype, device=device))
