"""The chunk grid: a triangle mesh cut into fixed-size chunks under 1-3
levels of bounding boxes (NumPy, host side).

A copy of the builder half of ``ascendpathtracing_tpu/ops/pallas_wbvh.py``
(``ChunkGrid``, ``triangle_rows``, ``build_chunk_grid``,
``permute_face_attrib``, ``attr_triangle_rows``): that module imports jax
at its top, so the port cannot import it where jax is absent.  The copy
is held array-equal to the JAX builder by ``tests/test_torch_mesh.py``.
It drops the JAX builder's ``supers_per``/``supers2_per <= 128`` guards,
which come from the TPU kernel's (8, 128) flags register block; the
CUDA kernels walk any group size.

Layout (what ``ops/wbvh_kernels`` and ``ops/mesh_pt_kernels`` take):

- ``cboxes [C, 6]`` chunk AABBs (min xyz, max xyz), float32;
- ``sboxes [Cs, 6]`` superchunk AABBs over ``supers_per`` consecutive
  chunks (``Cs == 0``: one level);
- ``ssboxes [Css, 6]`` super-superchunk AABBs over ``supers2_per``
  consecutive supers (``Css == 0``: at most two levels);
- ``tris [C*T, 13]`` precomputed-plane rows in chunk (slot) order:
  v0 xyz, n = e1 x e2, s1 xyz, s2 xyz, d0 = n.v0; padding rows are zero
  and never hit (their t is 0/0 = NaN, which fails every compare);
- ``face_of_slot [C*T]`` the original face of each slot, -1 for pads.

Padding boxes are inverted (min 1, max -1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MISS_T = 1e20
TRI_F = 13  # floats per triangle row: v0 xyz, n xyz, s1 xyz, s2 xyz, d0
# attr rows append: unit normal (3), albedo (3), emission (3),
# (is_diff, is_refr) one-hot floats -> 24
TRI_ATTR_F = 24


@dataclasses.dataclass
class ChunkGrid:
    """Flat chunked scene (see the module docstring for the arrays)."""

    cboxes: np.ndarray
    sboxes: np.ndarray
    tris: np.ndarray
    face_of_slot: np.ndarray
    tris_per_chunk: int
    supers_per: int
    ssboxes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 6), np.float32)
    )
    supers2_per: int = 0

    @property
    def n_chunks(self) -> int:
        return int(self.cboxes.shape[0])

    @property
    def n_supers(self) -> int:
        return int(self.sboxes.shape[0])

    @property
    def n_supers2(self) -> int:
        return int(self.ssboxes.shape[0])


def triangle_rows(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[F, TRI_F] precomputed-plane rows (float32, built in float64)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    tri = v[f]
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    # barycentric axes: u = s1.(p - v0), v = s2.(p - v0) for p in-plane
    e2xn = np.cross(e2, n)
    e1xn = np.cross(e1, n)
    den1 = np.einsum("ij,ij->i", e1, e2xn)
    den2 = np.einsum("ij,ij->i", e2, e1xn)
    safe1 = np.where(den1 == 0, 1.0, den1)[:, None]
    safe2 = np.where(den2 == 0, 1.0, den2)[:, None]
    s1 = np.where(den1[:, None] == 0, 0.0, e2xn / safe1)
    s2 = np.where(den2[:, None] == 0, 0.0, e1xn / safe2)
    d0 = np.einsum("ij,ij->i", n, v0)
    return np.concatenate([v0, n, s1, s2, d0[:, None]], axis=1).astype(np.float32)


def _group_boxes(boxes, per):
    """AABBs over consecutive groups of ``per`` boxes, the input padded to
    a multiple of ``per`` with inverted (never-hit) boxes -> (padded
    input, group boxes)."""
    n = boxes.shape[0]
    n_pad = -(-n // per) * per
    if n_pad != n:
        pad = np.empty((n_pad - n, 6), np.float32)
        pad[:, 0:3] = 1.0
        pad[:, 3:6] = -1.0
        boxes = np.concatenate([boxes, pad], 0)
    out = np.empty((n_pad // per, 6), np.float32)
    for gi in range(n_pad // per):
        grp = boxes[gi * per: (gi + 1) * per]
        real = grp[:, 0] <= grp[:, 3]
        if real.any():
            out[gi, 0:3] = grp[real, 0:3].min(axis=0)
            out[gi, 3:6] = grp[real, 3:6].max(axis=0)
        else:
            out[gi, 0:3] = 1.0
            out[gi, 3:6] = -1.0
    return boxes, out


def auto_levels(n_faces: int, tris_per_chunk: int, supers_per=None) -> tuple:
    """The JAX package's default grid levels (``mesh_pt_tables``,
    ``mesh_scene_to_device``) -> (supers_per, supers2_per): 16 chunks per
    super once there are 128 chunks (unless ``supers_per`` is given), 16
    supers per super-super once there are 256 supers, else 0."""
    n_chunks = -(-n_faces // tris_per_chunk)
    if supers_per is None:
        supers_per = 16 if n_chunks >= 128 else 0
    n_supers = -(-n_chunks // supers_per) if supers_per else 0
    return supers_per, 16 if n_supers >= 256 else 0


def build_chunk_grid(
    vertices,
    faces,
    *,
    tris_per_chunk: int = 32,
    supers_per: int = 0,
    supers2_per: int = 0,
) -> ChunkGrid:
    """Median-split triangle partition into fixed-size chunks.

    Recursive largest-centroid-extent median split down to
    ``tris_per_chunk``; splits land on chunk-size multiples so chunks stay
    full.  Chunks come out in DFS order, so consecutive chunks are
    spatial neighbours, which keeps the superchunk groups (each
    ``supers_per`` consecutive chunks) tight.
    """
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    tri = v[f]  # [F, 3, 3]
    tbmin = tri.min(axis=1)
    tbmax = tri.max(axis=1)
    cent = (tbmin + tbmax) * 0.5
    T = int(tris_per_chunk)
    if supers2_per and not supers_per:
        raise ValueError("supers2_per requires supers_per")

    chunks: list[np.ndarray] = []

    def rec(idx: np.ndarray) -> None:
        if idx.size <= T:
            chunks.append(idx)
            return
        ext = cent[idx].max(axis=0) - cent[idx].min(axis=0)
        ax = int(np.argmax(ext))
        order = np.argsort(cent[idx, ax], kind="stable")
        half = (idx.size // 2 + T - 1) // T * T
        half = min(half, idx.size - 1)
        rec(idx[order[:half]])
        rec(idx[order[half:]])

    rec(np.arange(f.shape[0]))

    rows_all = triangle_rows(v, f)
    c = len(chunks)
    c_pad = -(-c // supers_per) * supers_per if supers_per else c
    cboxes = np.empty((c_pad, 6), np.float32)
    tris = np.zeros((c_pad * T, TRI_F), np.float32)
    face_of_slot = np.full((c_pad * T,), -1, np.int32)
    for ci, idx in enumerate(chunks):
        cboxes[ci, 0:3] = tbmin[idx].min(axis=0)
        cboxes[ci, 3:6] = tbmax[idx].max(axis=0)
        tris[ci * T: ci * T + idx.size] = rows_all[idx]
        face_of_slot[ci * T: ci * T + idx.size] = idx.astype(np.int32)
    cboxes[c:c_pad, 0:3] = 1.0  # inverted boxes never pass the slab test
    cboxes[c:c_pad, 3:6] = -1.0

    sboxes = (_group_boxes(cboxes, supers_per)[1] if supers_per
              else np.zeros((0, 6), np.float32))
    ssboxes = np.zeros((0, 6), np.float32)
    if supers2_per:
        sboxes, ssboxes = _group_boxes(sboxes, supers2_per)
        # chunk arrays must cover the padded super count
        extra = sboxes.shape[0] * supers_per - cboxes.shape[0]
        if extra:
            padc = np.empty((extra, 6), np.float32)
            padc[:, 0:3] = 1.0
            padc[:, 3:6] = -1.0
            cboxes = np.concatenate([cboxes, padc], 0)
            tris = np.concatenate([tris, np.zeros((extra * T, TRI_F), np.float32)], 0)
            face_of_slot = np.concatenate(
                [face_of_slot, np.full((extra * T,), -1, np.int32)], 0
            )

    return ChunkGrid(
        cboxes=cboxes,
        sboxes=sboxes,
        tris=tris,
        face_of_slot=face_of_slot,
        tris_per_chunk=T,
        supers_per=supers_per,
        ssboxes=ssboxes,
        supers2_per=supers2_per,
    )


def permute_face_attrib(grid: ChunkGrid, attrib: np.ndarray, pad_value=0):
    """Per-face attribute array [F, ...] -> slot-ordered [C*T, ...] so a
    hit slot indexes it directly (pads get ``pad_value``)."""
    attrib = np.asarray(attrib)
    out = np.full((grid.face_of_slot.shape[0],) + attrib.shape[1:], pad_value,
                  attrib.dtype)
    live = grid.face_of_slot >= 0
    out[live] = attrib[grid.face_of_slot[live]]
    return out


def attr_triangle_rows(grid: ChunkGrid, face_albedo, face_emission,
                       face_material, diff_code=0, refr_code=2) -> np.ndarray:
    """ChunkGrid + per-face attributes -> [C*T, TRI_ATTR_F] slot rows: the
    13 intersection floats, then the unit normal, albedo, emission and
    the material one-hots (is_diff, is_refr) as 0/1 floats."""
    rows = np.zeros((grid.tris.shape[0], TRI_ATTR_F), np.float32)
    rows[:, :TRI_F] = grid.tris
    n = grid.tris[:, 3:6].astype(np.float64)
    nn = np.linalg.norm(n, axis=1, keepdims=True)
    rows[:, 13:16] = np.where(nn > 0, n / np.maximum(nn, 1e-300), 0.0)
    rows[:, 16:19] = permute_face_attrib(grid, np.asarray(face_albedo, np.float64))
    rows[:, 19:22] = permute_face_attrib(grid, np.asarray(face_emission, np.float64))
    mat = permute_face_attrib(grid, np.asarray(face_material), pad_value=-1)
    rows[:, 22] = (mat == diff_code).astype(np.float32)
    rows[:, 23] = (mat == refr_code).astype(np.float32)
    return rows


def chunk_grid_to_device(grid: ChunkGrid, device="cpu"):
    """ChunkGrid -> tensors (cboxes, sboxes, tris, face_of_slot) on
    ``device``: float32 tables, int32 slot map, as the JAX builder's."""
    return tuple(
        torch.tensor(a, device=device)
        for a in (grid.cboxes, grid.sboxes, grid.tris, grid.face_of_slot)
    )
