"""BVH: the host-side binned-SAH builder and the stackless per-ray walk.

Counterpart of ``ascendpathtracing_tpu/accel/bvh.py``.  Nodes come in DFS
(pre)order, each with a **miss link**: the node to visit when its box is
missed, or after a leaf.  A walk therefore needs one node pointer per
ray: it moves to ``ptr + 1`` at an inner node whose box it hits (the left
child is next in DFS order) and to ``miss[ptr]`` everywhere else.

- :func:`build_bvh_numpy` is a copy of the JAX package's NumPy builder
  (tests hold its arrays equal to the original's).
- :func:`build_bvh` takes the NumPy builder.  The JAX package prefers
  its native C++ builder (``accel/native.py``), whose tables differ from
  the NumPy builder's; that builder is not ported yet, and
  ``backend="native"`` raises NotImplementedError.
- :func:`intersect_bvh` is the walk in plain torch, in the rays' dtype:
  the float64 oracle of the mesh renderer's ``jnp`` mode and the plain
  twin of the lockstep traversal kernel (``ops/bvh_kernels``).  Its
  results are detached (no gradient flows through a hit distance).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ascendpathtracing_tpu_torch.accel import tri as tri_mod

MISS_T = 1e20


@dataclasses.dataclass
class FlatBVH:
    """Flattened DFS-ordered BVH over triangles."""

    bmin: np.ndarray  # [M, 3] float32
    bmax: np.ndarray  # [M, 3] float32
    first: np.ndarray  # [M] int32: leaf -> start into tri_order; inner -> -1
    count: np.ndarray  # [M] int32: leaf -> #tris; inner -> 0
    miss: np.ndarray  # [M] int32: skip link; == M means done
    tri_order: np.ndarray  # [F] int32 permutation of triangle ids
    max_leaf: int

    @property
    def n_nodes(self) -> int:
        return int(self.bmin.shape[0])

    @property
    def n_tris(self) -> int:
        return int(self.tri_order.shape[0])


def build_bvh_numpy(
    vertices: np.ndarray,
    faces: np.ndarray,
    *,
    max_leaf: int = 4,
    n_bins: int = 16,
) -> FlatBVH:
    """Binned-SAH BVH (NumPy reference builder)."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    f = faces.shape[0]
    tri = vertices[faces]  # [F, 3, 3]
    tbmin = tri.min(axis=1)
    tbmax = tri.max(axis=1)
    cent = (tbmin + tbmax) * 0.5

    bmin_l, bmax_l, first_l, count_l, miss_l = [], [], [], [], []
    order: list[int] = []

    def emit(bmin, bmax, first, count):
        bmin_l.append(bmin)
        bmax_l.append(bmax)
        first_l.append(first)
        count_l.append(count)
        miss_l.append(-1)
        return len(bmin_l) - 1

    def area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2])

    def rec(idxs: np.ndarray, miss_link: int) -> int:
        node_bmin = tbmin[idxs].min(axis=0)
        node_bmax = tbmax[idxs].max(axis=0)
        if idxs.size <= max_leaf:
            nid = emit(node_bmin, node_bmax, len(order), idxs.size)
            order.extend(int(i) for i in idxs)
            miss_l[nid] = miss_link
            return nid

        # --- binned SAH over all 3 axes -------------------------------
        best = None  # (cost, axis, bin_split, bins)
        c = cent[idxs]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            rel = (c[:, axis] - cmin[axis]) / ext[axis]
            bins = np.minimum((rel * n_bins).astype(np.int64), n_bins - 1)
            counts = np.bincount(bins, minlength=n_bins)
            if (counts > 0).sum() < 2:
                continue
            bb_min = np.full((n_bins, 3), np.inf)
            bb_max = np.full((n_bins, 3), -np.inf)
            for b in range(n_bins):
                m = bins == b
                if m.any():
                    bb_min[b] = tbmin[idxs[m]].min(axis=0)
                    bb_max[b] = tbmax[idxs[m]].max(axis=0)
            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            for split in range(1, n_bins):
                nl, nr = lcnt[split - 1], rcnt[split]
                if nl == 0 or nr == 0:
                    continue
                cost = nl * area(lmin[split - 1], lmax[split - 1]) + nr * area(
                    rmin[split], rmax[split]
                )
                if best is None or cost < best[0]:
                    best = (cost, axis, split, bins)

        if best is None:
            # Degenerate (all centroids coincide): arbitrary median split.
            half = idxs.size // 2
            left_idx, right_idx = idxs[:half], idxs[half:]
        else:
            _, axis, split, bins = best
            m = bins < split
            left_idx, right_idx = idxs[m], idxs[~m]

        nid = emit(node_bmin, node_bmax, -1, 0)
        miss_l[nid] = miss_link
        left_id = rec(left_idx, miss_link=-2)  # patched below
        right_id = rec(right_idx, miss_link=miss_link)
        # The left subtree's links "past the subtree" (-2) land on the
        # right child.
        for i in range(left_id, right_id):
            if miss_l[i] == -2:
                miss_l[i] = right_id
        return nid

    rec(np.arange(f), miss_link=-3)  # -3 = done, patched to M below
    m = len(bmin_l)
    miss = np.asarray(miss_l, np.int64)
    miss[miss == -3] = m
    miss[miss == -2] = m  # an unpatched -2 at the top level is "done" too
    return FlatBVH(
        bmin=np.asarray(bmin_l, np.float32),
        bmax=np.asarray(bmax_l, np.float32),
        first=np.asarray(first_l, np.int32),
        count=np.asarray(count_l, np.int32),
        miss=miss.astype(np.int32),
        tri_order=np.asarray(order, np.int32),
        max_leaf=max_leaf,
    )


def build_bvh(vertices, faces, *, max_leaf: int = 4, backend: str = "auto") -> FlatBVH:
    """The NumPy builder (``backend`` "auto" or "numpy").  "native", the
    JAX package's C++ builder, is not yet ported."""
    if backend == "native":
        raise NotImplementedError(
            "build_bvh(backend='native'): the C++ BVH builder (accel/native.py) "
            "is not yet ported to ascendpathtracing_tpu_torch"
        )
    if backend not in ("auto", "numpy"):
        raise ValueError(f"unknown BVH builder backend {backend!r}")
    return build_bvh_numpy(vertices, faces, max_leaf=max_leaf)


def bvh_to_device(bvh: FlatBVH, device="cpu", dtype=torch.float32) -> dict:
    """FlatBVH -> tensors for :func:`intersect_bvh`: ``bmin``/``bmax``
    [M, 3] in ``dtype``, ``first``/``count``/``miss`` [M] int32."""
    return {
        "bmin": torch.tensor(bvh.bmin, dtype=dtype, device=device),
        "bmax": torch.tensor(bvh.bmax, dtype=dtype, device=device),
        "first": torch.tensor(bvh.first, dtype=torch.int32, device=device),
        "count": torch.tensor(bvh.count, dtype=torch.int32, device=device),
        "miss": torch.tensor(bvh.miss, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------- traversal ----
@torch.no_grad()
def walk(o3, d3, bmin, bmax, first, count, miss, tri_planes, eps, counts=None):
    """The stackless walk of every ray, in the rays' dtype.

    ``bmin``/``bmax``: [M, 3] node boxes; ``first``/``count``/``miss``: [M]
    int; ``tri_planes``: (v0, e1, e2) xyz tuples of [F] planes in leaf
    order.  A ray at node p takes the slab test against its running tmin
    (``tfar >= max(tnear, 0) and tnear < tmin``); at a leaf it hits it
    tests the leaf's triangles in order and keeps a strictly smaller t;
    then it moves to p + 1 (an inner node it hits) or miss[p].  The walk
    runs while any ray's pointer is below M, over the rays still walking.
    ``counts`` [2, N] int64 (nodes visited, triangles tested) is added to
    in place.  Returns (tmin [N], hit [N] int64 leaf-order index, 0 on a
    miss)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    n = ox.shape[0]
    dtype, device = ox.dtype, ox.device
    m = bmin.shape[0]
    bmin, bmax = bmin.to(dtype), bmax.to(dtype)
    first, count, miss = first.long(), count.long(), miss.long()
    v0, e1, e2 = (tuple(c.to(dtype) for c in p) for p in tri_planes)
    ix = 1.0 / torch.where(dx == 0, 1e-30, dx)
    iy = 1.0 / torch.where(dy == 0, 1e-30, dy)
    iz = 1.0 / torch.where(dz == 0, 1e-30, dz)
    zero = torch.zeros((), dtype=dtype, device=device)

    tmin = torch.full((n,), MISS_T, dtype=dtype, device=device)
    hit = torch.zeros((n,), dtype=torch.int64, device=device)
    ids = torch.arange(n, device=device)
    ptr = torch.zeros((n,), dtype=torch.int64, device=device)
    while ids.numel():
        p = ptr
        rox, roy, roz = ox[ids], oy[ids], oz[ids]
        t1x = (bmin[p, 0] - rox) * ix[ids]
        t2x = (bmax[p, 0] - rox) * ix[ids]
        t1y = (bmin[p, 1] - roy) * iy[ids]
        t2y = (bmax[p, 1] - roy) * iy[ids]
        t1z = (bmin[p, 2] - roz) * iz[ids]
        t2z = (bmax[p, 2] - roz) * iz[ids]
        tnear = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z),
        )
        tfar = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z),
        )
        box = (tfar >= torch.maximum(tnear, zero)) & (tnear < tmin[ids])
        cnt = count[p]
        leaf = cnt > 0
        do = box & leaf
        if counts is not None:
            counts[0, ids] += 1
        if bool(do.any()):
            sel = ids[do]
            c = cnt[do]
            k = torch.arange(int(c.max()), device=device)
            valid = k[None, :] < c[:, None]
            tidx = torch.where(valid, first[p[do]][:, None] + k[None, :], 0)  # [L, K]
            o = (ox[sel][:, None], oy[sel][:, None], oz[sel][:, None])
            d = (dx[sel][:, None], dy[sel][:, None], dz[sel][:, None])
            t = tri_mod.moller_trumbore(o, d, tuple(q[tidx] for q in v0),
                                        tuple(q[tidx] for q in e1),
                                        tuple(q[tidx] for q in e2), eps)
            t = torch.where(valid, t, MISS_T)
            # The running strict minimum over k in order keeps the first
            # of the leaf's smallest t, if it beats the ray's tmin.
            j = torch.argmin(t, dim=1, keepdim=True)
            tb = t.gather(1, j)[:, 0]
            better = tb < tmin[sel]
            tmin[sel] = torch.where(better, tb, tmin[sel])
            hit[sel] = torch.where(better, tidx.gather(1, j)[:, 0], hit[sel])
            if counts is not None:
                counts[1, sel] += c
        ptr = torch.where(box & ~leaf, p + 1, miss[p])
        keep = ptr < m
        ids, ptr = ids[keep], ptr[keep]
    return tmin, hit


def intersect_bvh(o3, d3, bvh_arrays, tri_planes_ordered, eps):
    """Stackless BVH traversal of N rays (:func:`walk`).

    ``o3``, ``d3``: (x, y, z) tuples of [N] planes; ``bvh_arrays``: the
    dict of :func:`bvh_to_device`; ``tri_planes_ordered``: (v0, e1, e2)
    tuples of [F] planes permuted by ``tri_order``.  The JAX version's
    ``max_leaf`` (a static unroll bound) is not taken: each leaf tests its
    own count.  Returns (tmin [N], tri_id [N] int32 into the ordered
    triangles, miss [N] bool), detached."""
    tmin, hit = walk(o3, d3, bvh_arrays["bmin"], bvh_arrays["bmax"], bvh_arrays["first"],
                     bvh_arrays["count"], bvh_arrays["miss"], tri_planes_ordered, eps)
    return tmin, hit.to(torch.int32), tmin >= MISS_T
