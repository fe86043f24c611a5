"""Procedural test meshes (host-side, NumPy)."""

from __future__ import annotations

import numpy as np

from ascendpathtracing_tpu_torch.accel import native as native_mod


def cube(center=(0.0, 0.0, 0.0), size=1.0):
    """Axis-aligned cube: 8 vertices, 12 triangles."""
    c = np.asarray(center, np.float64)
    h = size / 2.0
    corners = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    v = c + corners * h
    f = np.array(
        [
            [0, 1, 2], [0, 2, 3],  # back  (z-)
            [4, 6, 5], [4, 7, 6],  # front (z+)
            [0, 4, 5], [0, 5, 1],  # bottom
            [3, 2, 6], [3, 6, 7],  # top
            [0, 3, 7], [0, 7, 4],  # left
            [1, 5, 6], [1, 6, 2],  # right
        ],
        np.int64,
    )
    return v, f


def icosphere(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=2):
    """Subdivided icosahedron (80/320/1280 tris at subdivisions 1/2/3)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts[0])
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        vlist = list(verts)
        cache: dict = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (verts[a] + verts[b]) / 2.0
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return np.asarray(center, np.float64) + verts * radius, faces


def quad(p0, p1, p2, p3):
    """Two-triangle quad from 4 corners (counter-clockwise)."""
    v = np.asarray([p0, p1, p2, p3], np.float64)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return v, f


def merge(*meshes):
    """Concatenate (vertices, faces) pairs into one mesh."""
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(np.asarray(v, np.float64))
        fs.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def clustered_icospheres(specs):
    """Non-uniform test scene: merged icospheres of wildly different
    radius/tessellation (``specs`` = iterable of (center, radius,
    subdivisions)).  The reference's scene is a fixed uniform 8-sphere
    table (gen_data.py:94-102); this generalizes it to the chunk grid's
    stress case — triangle DENSITY varying by orders of magnitude, so
    chunk sizes and per-tile worklists skew (VERDICT r4 ask 6's
    irregular-mesh evidence; see benchmarks/irregular_mesh.py)."""
    return merge(*[
        icosphere(center=c, radius=r, subdivisions=s) for c, r, s in specs
    ])


def transform(v, *, scale=1.0, rotate_y=0.0, translate=(0.0, 0.0, 0.0)):
    """Scale -> rotate about +Y -> translate a vertex array (host-side)."""
    v = np.asarray(v, np.float64) * float(scale)
    if rotate_y:
        c, s = np.cos(rotate_y), np.sin(rotate_y)
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        v = v @ rot.T
    return v + np.asarray(translate, np.float64)


def load_obj(path, *, native: str = "auto"):
    """Minimal Wavefront OBJ reader -> (vertices [V,3] f64, faces [F,3] i64).

    Supports ``v`` and ``f`` records; polygon faces are fan-triangulated;
    ``f`` indices may be 1-based, negative (relative), or ``v/vt/vn``
    tuples (only the vertex index is used — normals are recomputed by the
    renderer from geometry, and there is no texture pipeline, matching the
    reference's untextured scenes).  Ignores vt/vn/materials/groups.

    ``native='auto'`` uses the C++ loader (native/obj_loader.cpp — same
    parse semantics, tested identical) when its library builds, falling
    back to this Python parser; 'never' forces Python, 'always' raises if
    the native path is unavailable.
    """
    if native != "never":
        try:
            return native_mod.load_obj_native(path)
        except native_mod.NativeUnavailable:
            if native == "always":
                raise
    verts: list = []
    tris: list = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    # OBJ is 1-based; negative indexes count from the end.
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not tris:
        raise ValueError(f"no geometry in OBJ file {path!r}")
    v = np.asarray(verts, np.float64)
    f = np.asarray(tris, np.int64)
    if f.min() < 0 or f.max() >= len(v):
        raise ValueError(f"face index out of range in {path!r}")
    return v, f


def save_obj(path, v, f):
    """Write (vertices, faces) as a Wavefront OBJ (triangles, 1-based)."""
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    with open(path, "w") as fh:
        fh.write("# ascendpathtracing_tpu mesh\n")
        for x, y, z in v:
            fh.write(f"v {x:.9g} {y:.9g} {z:.9g}\n")
        for a, b, c in f + 1:
            fh.write(f"f {a} {b} {c}\n")
