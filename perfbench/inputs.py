"""The benchmark's inputs, made from the cell's files and ``--seed``.

Plain NumPy and torch; nothing of the program.  Both sides get the same
numbers: the program the float32 tensors it is run with, the reference
the same values.

- :func:`sphere_planes`: a configuration's sphere rows -> the [10, S]
  planes (r^2, centre xyz, emission xyz, albedo xyz), materials [S] and
  the light's index.
- :func:`camera_constants`: smallpt's camera (gen_data.py:24-29, 45) as
  11 Python floats: position, unit direction, cx.x, cy xyz, origin push.
- :func:`camera_rays`: [6, W*H*4] camera rays, one tent-filtered ray in
  each 2 x 2 sub-pixel (gen_data.py:34-46), the jitter drawn from a
  ``torch.Generator`` on the device; ray ((i*H + j)*2 + sy)*2 + sx.
- :func:`icosphere`: the subdivided icosahedron (vertices on the sphere).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT.parent)}")
    return json.loads(path.read_text())


def sphere_planes(config: dict):
    """-> (planes [10, S] float64, materials [S] int32, light index).
    Each row of ``config["spheres"]`` is radius, centre xyz, emission
    xyz, albedo xyz, material (0 diffuse, 1 mirror, 2 glass)."""
    rows = np.asarray(config["spheres"], np.float64)
    planes = np.ascontiguousarray(np.concatenate([(rows[:, 0] * rows[:, 0])[None], rows[:, 1:10].T]))
    return planes, rows[:, 10].astype(np.int32), int(config["light_index"])


def camera_constants(config: dict, width: int, height: int) -> tuple:
    """(px py pz dx dy dz cxx cyx cyy cyz push) in float64."""
    cam = config["camera"]
    pos = np.asarray(cam["position"], np.float64)
    raw = np.asarray(cam["direction"], np.float64)
    d = raw / np.linalg.norm(raw)
    cx = np.array([width * cam["fov_scale"] / height, 0.0, 0.0])
    cross = np.cross(cx, d)
    cy = cross / np.linalg.norm(cross) * cam["fov_scale"]
    return (float(pos[0]), float(pos[1]), float(pos[2]), float(d[0]), float(d[1]),
            float(d[2]), float(cx[0]), float(cy[0]), float(cy[1]), float(cy[2]),
            float(cam["origin_push"]))


def tent(r: torch.Tensor) -> torch.Tensor:
    """Tent-filter inverse CDF: r in [0, 2) -> offset in (-1, 1)."""
    return torch.where(r < 1, torch.sqrt(r) - 1, 1 - torch.sqrt(torch.clamp_min(2 - r, 0)))


def camera_rays(config: dict, width: int, height: int, generator: torch.Generator,
                dtype=torch.float32) -> torch.Tensor:
    """[6, W*H*4] rays (origin xyz, unit direction xyz), built in float64
    on the generator's device and rounded to ``dtype``."""
    px, py, pz, d0x, d0y, d0z, cxx, cyx, cyy, cyz, push = camera_constants(config, width, height)
    dev = generator.device
    n = width * height * 4
    u = torch.rand((2, n), generator=generator, device=dev, dtype=torch.float64)
    k = torch.arange(n, device=dev)
    sx, sy = (k % 2).double(), ((k // 2) % 2).double()
    pix = k // 4
    i, j = (pix // height).double(), (pix % height).double()
    su = ((sx + 0.5 + tent(2 * u[0])) / 2 + i) / width - 0.5
    sv = ((sy + 0.5 + tent(2 * u[1])) / 2 + j) / height - 0.5
    dx = su * cxx + sv * cyx + d0x
    dy = sv * cyy + d0y
    dz = sv * cyz + d0z
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    rays = torch.stack([px + dx * push, py + dy * push, pz + dz * push,
                        dx / norm, dy / norm, dz / norm])
    return rays.to(dtype).contiguous()


_ICO_FACES = (
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
    (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
    (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
)


def icosphere(center, radius: float, subdivisions: int):
    """-> (vertices [V, 3] float64, faces [20 * 4^subdivisions, 3] int64):
    each subdivision splits a face in four at its edges' midpoints pushed
    onto the unit sphere, then the sphere is scaled and moved."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
        (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1))]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = list(_ICO_FACES)
    for _ in range(subdivisions):
        mids: dict = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = (verts[a] + verts[b]) / 2.0
                mids[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mids[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    v = np.asarray(center, np.float64) + np.asarray(verts) * radius
    return v, np.asarray(faces, np.int64)


def mesh_of(config: dict):
    """The configuration's mesh -> (vertices, faces, albedo [3], emission
    [3], material), or None."""
    m = config.get("mesh")
    if m is None:
        return None
    if m["kind"] != "icosphere":
        raise ValueError(f"unknown mesh kind {m['kind']!r}")
    v, f = icosphere(m["center"], m["radius"], m["subdivisions"])
    return v, f, tuple(m["albedo"]), tuple(m["emission"]), int(m["material"])
