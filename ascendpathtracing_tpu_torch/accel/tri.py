"""Moller-Trumbore ray-triangle intersection over SoA planes (plain torch).

Counterpart of ``ascendpathtracing_tpu/accel/tri.py``, op for op:
branch-free, a miss is the 1e20 sentinel, and the lowest index wins a
tie downstream (``torch.argmin`` returns the first minimum).  It is the
brute-force oracle of the chunk-grid traversal (``ops/wbvh_kernels``)
and of ``models/mesh`` in its ``brute`` mode, and the triangle test of
the BVH walk (``accel/bvh``).
"""

from __future__ import annotations

import numpy as np
import torch

MISS_T = 1e20


def moller_trumbore(o3, d3, v0, e1, e2, eps):
    """Rays against triangles, any broadcastable shapes: ``o3``, ``d3``
    the rays' (x, y, z), ``v0``, ``e1``, ``e2`` the triangles' first vertex
    and edges v1 - v0, v2 - v0 -> t, 1e20 where missed.  Both orientations
    hit (no backface culling).  The op order of the JAX package's
    ``accel/tri.py`` and of the Pallas BVH kernel."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    # pvec = d x e2
    px = dy * e2[2] - dz * e2[1]
    py = dz * e2[0] - dx * e2[2]
    pz = dx * e2[1] - dy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    parallel = det.abs() < 1e-12  # |det| ~ 0: the ray is parallel
    inv_det = torch.where(parallel, 0.0, 1.0 / torch.where(parallel, 1.0, det))
    # tvec = o - v0
    tx = ox - v0[0]
    ty = oy - v0[1]
    tz = oz - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = (~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return torch.where(hit, t, MISS_T)


def intersect_triangles_brute(o3, d3, v0, e1, e2, eps):
    """N rays (``o3``, ``d3``: (x, y, z) tuples of [N] planes) against F
    triangles (``v0``, ``e1``, ``e2``: (x, y, z) tuples of [F] planes, the
    first vertex and the edges v1 - v0, v2 - v0) -> t [F, N], 1e20 where
    missed."""
    return moller_trumbore(
        tuple(c[None, :] for c in o3), tuple(c[None, :] for c in d3),
        tuple(c[:, None] for c in v0), tuple(c[:, None] for c in e1),
        tuple(c[:, None] for c in e2), eps,
    )


def triangle_planes(vertices, faces, dtype=None):
    """Host side: vertices [V, 3], faces [F, 3] -> (v0, e1, e2), each a
    tuple of three [F] NumPy planes, for :func:`intersect_triangles_brute`
    (after conversion to tensors)."""
    vertices = np.asarray(vertices)
    if dtype is not None:
        vertices = vertices.astype(dtype)
    faces = np.asarray(faces, np.int64)
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    e1 = b - a
    e2 = c - a
    return (
        (a[:, 0], a[:, 1], a[:, 2]),
        (e1[:, 0], e1[:, 1], e1[:, 2]),
        (e2[:, 0], e2[:, 1], e2[:, 2]),
    )
