"""The BVH layer of the port on the CPU: the NumPy builder copy
(ascendpathtracing_tpu_torch.accel.bvh) against the JAX builder, the
per-ray walk against the JAX while-loop walk over the same FlatBVH, the
lockstep traversal's plain twin (ops/bvh_kernels) against the Pallas
kernel in interpret mode over ``pack_bvh_for_pallas``'s tables carried by
``convert``, the Morton ray-sort keys (ops/sort) against the JAX ones, and
the wrapper's checks.  Tests marked ``cuda`` hold the CUDA kernel against
the twin on a card and skip without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu.accel import bvh as jax_bvh
from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.accel import tri as jax_tri
from ascendpathtracing_tpu.ops import pallas_bvh as jax_pbvh
from ascendpathtracing_tpu.ops import sort as jax_sort
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.accel import tri
from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
from ascendpathtracing_tpu_torch.ops import sort as ps
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

FIELDS = ("bmin", "bmax", "first", "count", "miss", "tri_order")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mesh(kind, sub=2):
    return meshes.cube() if kind == "cube" else meshes.icosphere(subdivisions=sub)


def _rays(n, seed=0, spread=3.0):
    """[6, N] float32 rays, origins ~N(0, spread^2), unit directions (the
    distribution of tests/test_pallas_bvh.py:20-24)."""
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * spread).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d], 1).T.copy()


def _aimed_rays(n, seed=1):
    """[6, N] float32 rays from radius 3 aimed into the unit ball (most hit
    the unit icosphere)."""
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n)
    o = (o / np.linalg.norm(o, axis=0) * 3.0).astype(np.float32)
    d = rng.uniform(-0.6, 0.6, (3, n)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0).astype(np.float32)


def _ordered_planes(bvh, v, f, dtype):
    planes = tri.triangle_planes(v, f, dtype=dtype)
    return tuple(tuple(c[bvh.tri_order] for c in t) for t in planes)


# ------------------------------------------------------------ builder ----
@pytest.mark.parametrize("kind,sub,max_leaf", [
    ("cube", 0, 4), ("cube", 0, 64), ("ico", 1, 4), ("ico", 2, 4), ("ico", 3, 4),
    ("ico", 1, 64), ("ico", 2, 64), ("ico", 3, 64),
])
def test_builder_equals_jax_numpy_builder(kind, sub, max_leaf):
    v, f = _mesh(kind, sub)
    got = bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf)
    ref = jax_bvh.build_bvh_numpy(v, f, max_leaf=max_leaf)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.max_leaf == ref.max_leaf and got.n_nodes == ref.n_nodes


@pytest.mark.parametrize("kind,sub", [("cube", 0), ("ico", 2)])
def test_bvh_structure_valid(kind, sub):
    """tests/test_bvh.py:36-52 on the port's builder."""
    v, f = _mesh(kind, sub)
    bvh = bvh_mod.build_bvh_numpy(v, f)
    m = bvh.n_nodes
    assert sorted(bvh.tri_order.tolist()) == list(range(len(f)))
    assert (bvh.miss > np.arange(m)).all(), "miss links must move forward"
    assert (bvh.miss <= m).all()
    leaves = bvh.count > 0
    assert bvh.count[leaves].sum() == len(f)
    assert (bvh.count[leaves] <= bvh.max_leaf).all()
    tri_v = np.asarray(v)[np.asarray(f)]
    for i in np.nonzero(leaves)[0][:50]:
        tv = tri_v[bvh.tri_order[bvh.first[i]: bvh.first[i] + bvh.count[i]]]
        assert (tv.min(axis=(0, 1)) >= bvh.bmin[i] - 1e-4).all()
        assert (tv.max(axis=(0, 1)) <= bvh.bmax[i] + 1e-4).all()


def test_build_bvh_backends():
    v, f = meshes.icosphere(subdivisions=1)
    auto = bvh_mod.build_bvh(v, f, max_leaf=8)
    ref = bvh_mod.build_bvh_numpy(v, f, max_leaf=8)
    assert all(np.array_equal(getattr(auto, k), getattr(ref, k)) for k in FIELDS)
    with pytest.raises(NotImplementedError, match="C\\+\\+ BVH builder"):
        bvh_mod.build_bvh(v, f, backend="native")
    with pytest.raises(ValueError):
        bvh_mod.build_bvh(v, f, backend="gpu")


def test_flat_bvh_from_jax_carries_the_native_tables():
    """convert.flat_bvh_from_numpy takes the JAX package's build_bvh (its
    C++ builder where it loads) array for array."""
    v, f = jax_meshes.icosphere(subdivisions=2)
    jb = jax_bvh.build_bvh(v, f, max_leaf=8)
    got = convert.flat_bvh_from_numpy(jb)
    for name in FIELDS:
        assert np.array_equal(getattr(got, name), getattr(jb, name)), name
    assert got.max_leaf == 8
    bad = jax_bvh.FlatBVH(jb.bmin, jb.bmax[:-1], jb.first, jb.count, jb.miss,
                          jb.tri_order, 8)
    with pytest.raises(ValueError):
        convert.flat_bvh_from_numpy(bad)


# ---------------------------------------------------------- the walk ----
@pytest.mark.parametrize("max_leaf", [4, 16])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_walk_matches_jax_walk(dtype, max_leaf):
    """accel/bvh.intersect_bvh vs the JAX while-loop walk over the same
    FlatBVH (icosphere s2, 2,048 rays, eps 1e-5; the JAX walk unrolls
    max_leaf and takes ~30 s to compile at 64, so 64-triangle leaves are
    held by the Pallas test below).  float64: allclose 1e-12
    and the hit ids equal.  float32: the same hit set, hit ids equal where
    both hit, tmin within 4 ulp (XLA's CPU arithmetic against op-by-op
    IEEE; 3 measured, 38% of hits not bitwise)."""
    v, f = meshes.icosphere(subdivisions=2)
    npd = np.dtype(dtype)
    bvh = jax_bvh.build_bvh_numpy(np.asarray(v, np.float32), f, max_leaf=max_leaf)
    ordered = _ordered_planes(bvh, np.asarray(v, np.float32), f, npd)
    rays = np.concatenate([_rays(1024), _aimed_rays(1024)], 1).astype(npd)
    tj, hj, mj = jax_bvh.intersect_bvh(
        tuple(jnp.asarray(rays[i]) for i in range(3)), tuple(jnp.asarray(rays[i]) for i in range(3, 6)),
        jax_bvh.bvh_to_device(bvh, dtype=jnp.dtype(dtype)),
        tuple(tuple(jnp.asarray(c) for c in t) for t in ordered), 1e-5, max_leaf)
    tdt = getattr(torch, dtype)
    tp, hp, mp = bvh_mod.intersect_bvh(
        tuple(torch.tensor(rays[i]) for i in range(3)), tuple(torch.tensor(rays[i]) for i in range(3, 6)),
        bvh_mod.bvh_to_device(convert.flat_bvh_from_numpy(bvh), dtype=tdt),
        tuple(tuple(torch.tensor(c) for c in t) for t in ordered), 1e-5)
    tj, hj, mj = np.asarray(tj), np.asarray(hj), np.asarray(mj)
    assert tp.dtype == tdt and hp.dtype == torch.int32
    hit = ~mj
    assert 0.3 < hit.mean() < 0.7
    np.testing.assert_array_equal(mp.numpy(), mj)
    np.testing.assert_array_equal(hp.numpy()[hit], hj[hit])
    if dtype == "float64":
        np.testing.assert_allclose(tp.numpy(), tj, rtol=1e-12, atol=1e-12)
    else:
        ulp = np.abs(tp.numpy()[hit].view(np.int32) - tj[hit].view(np.int32))
        print(f"float32 walk: {(ulp != 0).mean():.2%} of hits not bitwise, max {ulp.max()} ulp")
        assert ulp.max() <= 4
        assert (tp.numpy()[~hit] == tj[~hit]).all()


def test_walk_matches_brute_force_float64():
    """tests/test_bvh.py:55-85 on the port: the walk equals brute force,
    t to 1e-12, the winning face on > 99% of hit rays (the rest tie at a
    shared edge)."""
    v, f = meshes.icosphere(subdivisions=3)
    bvh = bvh_mod.build_bvh_numpy(v, f)
    rays = np.concatenate([_rays(256, spread=4.0), _aimed_rays(256)], 1).astype(np.float64)
    o3 = tuple(torch.tensor(rays[i]) for i in range(3))
    d3 = tuple(torch.tensor(rays[i]) for i in range(3, 6))
    ts = tri.intersect_triangles_brute(
        o3, d3, *[tuple(torch.tensor(c) for c in p) for p in tri.triangle_planes(v, f, np.float64)],
        1e-6)
    bt, bf = ts.amin(0), ts.argmin(0)
    ordered = _ordered_planes(bvh, v, f, np.float64)
    tmin, hid, miss = bvh_mod.intersect_bvh(
        o3, d3, bvh_mod.bvh_to_device(bvh, dtype=torch.float64),
        tuple(tuple(torch.tensor(c) for c in t) for t in ordered), 1e-6)
    np.testing.assert_allclose(tmin.numpy(), bt.numpy(), rtol=1e-12, atol=1e-12)
    hits = bt < 1e19
    assert torch.equal(miss, ~hits) and hits.float().mean() > 0.4
    same = bvh.tri_order[hid.numpy()][hits.numpy()] == bf.numpy()[hits.numpy()]
    assert same.mean() > 0.99


def test_walk_counts():
    """Per-ray counts: a missing ray visits the root and tests nothing; a
    hit ray tested at least one triangle; nothing exceeds the tree."""
    v, f = meshes.icosphere(subdivisions=2)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=8)
    nf, ni, t9 = bk.pack_bvh(bvh, _ordered_planes(bvh, v, f, np.float32))
    rays = torch.tensor(_aimed_rays(256))
    rays[:, 0] = torch.tensor([5.0, 5.0, 5.0, 1.0, 0.0, 0.0])  # away from the mesh
    counts = torch.zeros((2, 256), dtype=torch.int64)
    tmin, _ = bk.intersect_bvh_plain(rays, nf, ni, t9, max_leaf=8, eps=1e-5, counts=counts)
    assert counts[:, 0].tolist() == [1, 0]
    assert bool((counts[1][tmin < 1e19] > 0).all())
    assert int(counts[0].max()) <= bvh.n_nodes and int(counts[1].max()) <= len(f)


# ------------------------------------------- twin vs Pallas interpret ----
@pytest.mark.parametrize("max_leaf", [4, 64])
def test_twin_matches_pallas_interpret(max_leaf):
    """tests/test_pallas_bvh.py:11-38's shapes (icosphere s2, 2,048 rays,
    eps 1e-5): intersect_bvh_plain over pack_bvh_for_pallas's tables
    (carried by convert) vs intersect_bvh_pallas(interpret=True).  The
    same hit set, hit ids equal where both hit, tmin within 8 ulp (XLA's
    CPU arithmetic in interpret mode against op-by-op IEEE, where the twin
    equals NumPy float32 op by op; 7 measured on a t ~ 0.016, half of the
    hits bitwise)."""
    v, f = meshes.icosphere(subdivisions=2)
    v32 = np.asarray(v, np.float32)
    bvh = jax_bvh.build_bvh_numpy(v32, f, max_leaf=max_leaf)
    nf, ni, t9 = jax_pbvh.pack_bvh_for_pallas(bvh, _ordered_planes(bvh, v32, f, np.float32))
    rays = _rays(2048)
    tj, hj = jax_pbvh.intersect_bvh_pallas(jnp.asarray(rays), nf, ni, t9, max_leaf=max_leaf,
                                           eps=1e-5, tile=1024, interpret=True)
    tables = convert.bvh_tables_from_numpy(nf, ni, t9)
    mine = bk.pack_bvh(convert.flat_bvh_from_numpy(bvh), _ordered_planes(bvh, v32, f, np.float32))
    assert all(torch.equal(a, b) for a, b in zip(tables, mine))
    bk.reset_launches()
    tp, hp = bk.intersect_bvh(torch.tensor(rays), *tables, max_leaf=max_leaf, eps=1e-5)
    assert bk.LAUNCHES == {"bvh": 0}  # CPU tensors run the twin
    tj, hj, tp, hp = np.asarray(tj), np.asarray(hj), tp.numpy(), hp.numpy()
    hit = tj < 1e19
    assert hit.sum() > 40
    np.testing.assert_array_equal(tp < 1e19, hit)
    np.testing.assert_array_equal(hp[hit], hj[hit])
    assert (hp[~hit] == 0).all() and (tp[~hit] == np.float32(1e20)).all()
    ulp = np.abs(tp[hit].view(np.int32) - tj[hit].view(np.int32))
    print(f"twin vs Pallas interpret: {(ulp != 0).mean():.2%} of hits not bitwise, "
          f"max {ulp.max()} ulp")
    assert ulp.max() <= 8


def test_twin_float64_equals_the_walk():
    """The twin in float64 is accel/bvh's walk over the packed tables."""
    v, f = meshes.icosphere(subdivisions=2)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=16)
    ordered = _ordered_planes(bvh, v, f, np.float32)
    tables = bk.pack_bvh(bvh, ordered)
    rays = _aimed_rays(512).astype(np.float64)
    tp, hp = bk.intersect_bvh_plain(torch.tensor(rays), *tables, max_leaf=16, eps=1e-4)
    tw, hw, _ = bvh_mod.intersect_bvh(
        tuple(torch.tensor(rays[i]) for i in range(3)), tuple(torch.tensor(rays[i]) for i in range(3, 6)),
        bvh_mod.bvh_to_device(bvh, dtype=torch.float64),
        tuple(tuple(torch.tensor(c) for c in t) for t in ordered), 1e-4)
    assert tp.dtype == torch.float64 and torch.equal(tp, tw) and torch.equal(hp, hw)


def _tables():
    v, f = meshes.icosphere(subdivisions=1)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=4)
    nf, ni, t9 = bk.pack_bvh(bvh, _ordered_planes(bvh, v, f, np.float32))
    return dict(rays=torch.tensor(_rays(64)), nf=nf, ni=ni, t9=t9, max_leaf=4)


@pytest.mark.parametrize("change,exc", [
    (dict(rays=torch.zeros(6, 8, dtype=torch.float64)), TypeError),  # float32 only
    (dict(rays=torch.zeros(5, 8)), ValueError),  # not [6, N]
    (dict(rays=torch.zeros(8, 6).T), ValueError),  # not contiguous
    (dict(nf=torch.zeros(10, 6, dtype=torch.float64)), TypeError),
    (dict(ni=torch.zeros(10, 3)), TypeError),  # nodesi must be int32
    (dict(nf=torch.zeros(10, 5)), ValueError),
    (dict(t9=torch.zeros(10, 8)), ValueError),
    (dict(ni=torch.zeros(3, 3, dtype=torch.int32)), ValueError),  # M differs
    (dict(max_leaf=0), ValueError),
])
def test_wrapper_rejects_bad_inputs(change, exc):
    kw = _tables()
    kw.update(change)
    with pytest.raises(exc):
        bk.intersect_bvh(kw["rays"], kw["nf"], kw["ni"], kw["t9"], max_leaf=kw["max_leaf"])


def test_tables_from_jax_rejects_bad_shapes():
    kw = _tables()
    with pytest.raises(ValueError):
        convert.bvh_tables_from_numpy(np.zeros((4, 5)), kw["ni"], kw["t9"])
    got = convert.bvh_tables_from_numpy(kw["nf"].numpy(), kw["ni"].numpy().astype(np.int64),
                                        kw["t9"].numpy())
    assert got[1].dtype == torch.int32 and torch.equal(got[1], kw["ni"])


# --------------------------------------------------------------- sort ----
def _sort_rays(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.rand(n, 3).astype(np.float32) * 100
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("which", ["octant", "6d"])
def test_sort_keys_equal_jax(which):
    """Keys bit for bit, on rays whose origins reach past the bounds (the
    clip) and with direction components of exactly 0 and +-1."""
    o, d = _sort_rays()
    o[:8] = [[-5, 0, 0], [0, 105, 50], [100, 100, 100], [0, 0, 0],
             [50, 50, 50], [1e3, -1e3, 7], [99.999, 0.001, 33.3], [12.5, 25, 37.5]]
    d[:4] = [[0, 0, 1], [1, 0, 0], [0, -1, 0], [-1, 0, 0]]
    lo, hi = np.array([0.0, 0.0, 0.0], np.float32), np.array([100.0, 80.0, 100.0], np.float32)
    jfn = jax_sort.ray_sort_keys if which == "octant" else jax_sort.ray_sort_keys_6d
    pfn = ps.ray_sort_keys if which == "octant" else ps.ray_sort_keys_6d
    ref = np.asarray(jfn(tuple(jnp.asarray(o[:, i]) for i in range(3)),
                         tuple(jnp.asarray(d[:, i]) for i in range(3)),
                         jnp.asarray(lo), jnp.asarray(hi)))
    got = pfn(tuple(torch.tensor(o[:, i]) for i in range(3)),
              tuple(torch.tensor(d[:, i]) for i in range(3)), torch.tensor(lo), torch.tensor(hi))
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1000


def test_sort_permutation_equals_jax_and_groups_octants():
    """tests/test_ray_sort.py:9-29: a permutation, equal to JAX's stable
    argsort, that groups the direction octants."""
    o, d = _sort_rays()
    o3 = tuple(torch.tensor(o[:, i]) for i in range(3))
    d3 = tuple(torch.tensor(d[:, i]) for i in range(3))
    lo, hi = torch.zeros(3), torch.full((3,), 100.0)
    o3s, d3s, perm = ps.sort_rays_for_traversal(o3, d3, lo, hi)
    _, _, jperm = jax_sort.sort_rays_for_traversal(
        tuple(jnp.asarray(o[:, i]) for i in range(3)), tuple(jnp.asarray(d[:, i]) for i in range(3)),
        jnp.zeros(3, jnp.float32), jnp.full((3,), 100.0, jnp.float32))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert sorted(perm.tolist()) == list(range(len(o)))
    assert torch.equal(o3s[0], o3[0][perm]) and torch.equal(d3s[2], d3[2][perm])
    octant = (d3s[0] >= 0).long() + 2 * (d3s[1] >= 0).long() + 4 * (d3s[2] >= 0).long()
    assert int((octant.diff() != 0).sum()) <= 7


def test_morton_locality():
    codes = ps.morton3(torch.tensor([0, 1, 0, 0], dtype=torch.int32),
                       torch.tensor([0, 0, 1, 0], dtype=torch.int32),
                       torch.tensor([0, 0, 0, 1], dtype=torch.int32))
    assert codes.tolist() == [0, 1, 2, 4]
    x = torch.arange(1024, dtype=torch.int32)
    np.testing.assert_array_equal(ps._part1by2(x).numpy(),
                                  np.asarray(jax_sort._part1by2(jnp.asarray(x.numpy()))))


# ------------------------------------------------------- on a card ----
@pytest.mark.cuda
@pytest.mark.parametrize("max_leaf", [4, 64])
def test_cuda_kernel_matches_twin(cuda, max_leaf):
    v, f = meshes.icosphere(subdivisions=3)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf)
    tables = bk.pack_bvh(bvh, _ordered_planes(bvh, v, f, np.float32), cuda)
    rays = torch.tensor(np.concatenate([_rays(4096), _aimed_rays(4096)], 1), device=cuda)
    bk.reset_launches()
    k = bk.intersect_bvh(rays, *tables, max_leaf=max_leaf)
    assert bk.LAUNCHES == {"bvh": 1}
    p = bk.intersect_bvh_plain(rays, *tables, max_leaf=max_leaf)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
