"""The leaf tests of ``csrc/bvh.cu`` as a torch model, on the CPU.

The kernel walks each ray's stackless DFS path as the twin does.  Where
the lanes in leaves would leave the warp at least half idle, the warp
pools the (ray, triangle) pairs of those leaves and runs them 32 a round
in an order that is not the twin's (else each lane tests its own leaf in
order, as the twin does): each ray keeps
the lexicographic minimum of (key(t), leaf-order index) over its leaf's
hits, key being ``warp_walk.cuh``'s order-preserving ``t_bits<true>``
(``eps`` may be <= 0, so t may be <= 0; -0 counts as +0), and takes it
where its key is below that of its running tmin; a winner at t == 0 takes
its t again from its row.  :func:`pooled_walk` is that walk in torch, the
pairs folded in a random order, 32 a round, with a scatter minimum per
round (the kernel's compare-and-swap minimum in shared memory).  It must equal
``ops/bvh_kernels.intersect_bvh_plain`` bit for bit, whatever the order:
on random and aimed rays, rays that start on the mesh, a mesh with every
face twice (exact ties), and eps of 1e-4, 0 and -1e-3.  The card tests in
``tests/test_torch_cuda.py`` hold the kernel itself to the twin."""

import numpy as np
import pytest
import torch

from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import meshes, tri
from ascendpathtracing_tpu_torch.accel.tri import moller_trumbore
from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

ROUND = 32  # pairs a warp tests at once


def t_key(t):
    """t_bits<true> of float32 t as int64: the bits with the sign bit
    flipped, all bits flipped for a negative t, -0 taken as +0; orders as
    t does."""
    b = (t + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(b >> 31 == 1, ~b & 0xFFFFFFFF, b | 0x80000000)


def from_key(k):
    """from_bits<true>: the float32 t of a key."""
    b = torch.where(k >> 31 == 1, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF)
    return b.to(torch.int64).sub(torch.where(b >= 2**31, 2**32, 0)).to(torch.int32) \
        .view(torch.float32)


def pooled_walk(rays, nodesf, nodesi, tris9, *, max_leaf, eps, seed):
    """bvh.cu's walk over the packed tables -> (tmin [N], hit [N] int32)."""
    gen = torch.Generator().manual_seed(seed)
    o3, d3 = tuple(rays[0:3]), tuple(rays[3:6])
    n, m = rays.shape[1], nodesf.shape[0]
    ix, iy, iz = (1.0 / torch.where(d == 0, 1e-30, d) for d in d3)
    first, count, miss = nodesi[:, 0].long(), nodesi[:, 1].long(), nodesi[:, 2].long()
    v0, e1, e2 = tris9[:, 0:3].T, tris9[:, 3:6].T, tris9[:, 6:9].T
    tmin = torch.full((n,), bvh_mod.MISS_T, dtype=torch.float32)
    hit = torch.zeros((n,), dtype=torch.int64)
    node = torch.zeros((n,), dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.float32)

    def tri_t(ray, tidx):
        return moller_trumbore(tuple(c[ray] for c in o3), tuple(c[ray] for c in d3),
                               tuple(c[tidx] for c in v0), tuple(c[tidx] for c in e1),
                               tuple(c[tidx] for c in e2), eps)

    while True:
        # 1. Each ray to its next leaf whose box it hits (gated by tmin).
        at_leaf = torch.zeros((n,), dtype=torch.bool)
        walking = node < m
        while bool(walking.any()):
            ids = walking.nonzero()[:, 0]
            p = node[ids]
            t1 = [(nodesf[p, a] - o3[a][ids]) * inv[ids] for a, inv in enumerate((ix, iy, iz))]
            t2 = [(nodesf[p, a + 3] - o3[a][ids]) * inv[ids]
                  for a, inv in enumerate((ix, iy, iz))]
            tnear = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                                torch.minimum(t1[1], t2[1])),
                                  torch.minimum(t1[2], t2[2]))
            tfar = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                               torch.maximum(t1[1], t2[1])),
                                 torch.maximum(t1[2], t2[2]))
            box = (tfar >= torch.maximum(tnear, zero)) & (tnear < tmin[ids])
            stop = box & (count[p] > 0)
            at_leaf[ids[stop]] = True
            go = ids[~stop]
            node[go] = torch.where(box[~stop], p[~stop] + 1, miss[p[~stop]])
            walking = (node < m) & ~at_leaf
        if not bool(at_leaf.any()):
            return tmin, hit.to(torch.int32)
        # 2. The pooled pairs of the leaf rays, in a random order.
        rays_at = at_leaf.nonzero()[:, 0]
        c = count[node[rays_at]].clamp_max(max_leaf)
        ray = torch.repeat_interleave(rays_at, c)
        start = torch.repeat_interleave(torch.cumsum(c, 0) - c, c)
        tidx = first[node[ray]] + torch.arange(ray.numel()) - start
        order = torch.randperm(ray.numel(), generator=gen)
        ray, tidx = ray[order], tidx[order]
        # 3. Rounds of 32: each hit folds (key(t), index) into its ray's
        # minimum (key - 2^31 keeps the int64 order lexicographic).
        t = tri_t(ray, tidx)
        ok = t < bvh_mod.MISS_T  # moller_trumbore's hit (t > eps), as the kernel's
        packed = ((t_key(t) - 2**31) << 32) | tidx
        best = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64)
        for r0 in range(0, ray.numel(), ROUND):
            sel = ok[r0:r0 + ROUND]
            best.scatter_reduce_(0, ray[r0:r0 + ROUND][sel], packed[r0:r0 + ROUND][sel], "amin")
        # 4. Each leaf ray takes its minimum where its key beats tmin's.
        b = best[rays_at]
        found = b != torch.iinfo(torch.int64).max
        key = (b >> 32) + 2**31
        win_idx = b & 0xFFFFFFFF
        take = found & (key < t_key(tmin[rays_at]))
        t_win = from_key(key)
        # the sign of a winning zero, from its row
        t_win = torch.where(t_win == 0, tri_t(rays_at, torch.where(found, win_idx, 0)), t_win)
        tmin[rays_at] = torch.where(take, t_win, tmin[rays_at])
        hit[rays_at] = torch.where(take, win_idx, hit[rays_at])
        node[rays_at] = miss[node[rays_at]]


def _rays(kind, n, v, f, seed):
    """[6, N] float32 rays: random origins and directions, rays aimed into
    the unit ball from radius 3, or rays in random directions that start on
    the mesh: half inside its triangles, half at its vertices (where the
    triangles that start there give t = +-0)."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        o = rng.randn(3, n) * 1.5
    elif kind == "aimed":
        o = rng.randn(3, n)
        o = o / np.linalg.norm(o, axis=0) * 3.0
    else:
        tri_v = np.asarray(v, np.float64)[f[rng.randint(0, f.shape[0], n)]]  # [n, 3, 3]
        w = rng.dirichlet(np.ones(3), n)
        w[n // 2:] = np.eye(3)[rng.randint(0, 3, n - n // 2)]
        o = np.einsum("nk,nkc->cn", w, tri_v)
    d = rng.uniform(-0.6, 0.6, (3, n)) - o if kind == "aimed" else rng.randn(3, n)
    d = d / np.linalg.norm(d, axis=0)
    return torch.tensor(np.concatenate([o, d], 0).astype(np.float32))


def _tables(mesh, max_leaf):
    v, f = meshes.icosphere(subdivisions=3 if mesh == "ico3" else 2)
    if mesh == "dup2":  # every face twice: exact ties between two indices
        f = np.concatenate([f, f], 0)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf)
    planes = tuple(tuple(c[bvh.tri_order] for c in t)
                   for t in tri.triangle_planes(v, f, dtype=np.float32))
    return v, f, bk.pack_bvh(bvh, planes)


@pytest.mark.parametrize("mesh", ["ico3", "dup2"])
@pytest.mark.parametrize("max_leaf", [4, 64])
@pytest.mark.parametrize("eps", [1e-4, 0.0, -1e-3])
@pytest.mark.parametrize("kind", ["random", "aimed", "on_mesh"])
def test_pooled_leaf_minimum_equals_the_twin(mesh, max_leaf, eps, kind):
    v, f, tables = _tables(mesh, max_leaf)
    rays = _rays(kind, 1024, v, f, seed=max_leaf + len(kind))
    want = bk.intersect_bvh_plain(rays, *tables, max_leaf=max_leaf, eps=eps)
    assert int((want[0] < bvh_mod.MISS_T).sum()) > 100
    for seed in range(2):
        got = pooled_walk(rays, *tables, max_leaf=max_leaf, eps=eps, seed=seed)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


def test_ties_and_zeros_occur():
    """The cases above reach what the model's key and index order decide:
    on the doubled mesh each winning face has a copy at the same t, and
    with eps <= 0 rays that start on the mesh win at t <= 0, -0 among
    them."""
    v, f, tables = _tables("dup2", 64)
    rays = _rays("on_mesh", 1024, v, f, seed=64 + 7)
    t, h = bk.intersect_bvh_plain(rays, *tables, max_leaf=64, eps=-1e-3)
    hit = t < bvh_mod.MISS_T
    assert int((t[hit] <= 0).sum()) > 10
    tie = tables[2][h.long()][:, None, :] == tables[2][None, :, :]
    assert int(tie.all(dim=2).sum(dim=1)[hit].min()) == 2  # the copy
    zero_bits = t.view(torch.int32)
    assert bool(((zero_bits == 0) | (zero_bits == torch.iinfo(torch.int32).min)).any())
