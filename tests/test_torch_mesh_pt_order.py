"""The invariant the fused mesh kernel's warp walk rests on
(``csrc/warp_walk.cuh``): folding every (ray, triangle) pair of the
entered chunks into a lexicographic minimum of (t, slot), in any order,
gives the per-ray walk's answer (``ops/wbvh_kernels.walk_plain``: a
strict running t < tmin in increasing slot order).  Held on random rays,
on a mesh whose faces all have copies in other chunks and supers (exact
ties) under random orders of the pairs, and against the Pallas kernel's
winners on that mesh (interpret mode, as ``test_torch_mesh_pt_kernel.py``
runs it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu.models import mesh as jax_mesh
from ascendpathtracing_tpu.ops import pallas_mesh_pt as jax_mpt
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
from tests.test_torch_cuda import TRAVERSALS, _sphere_rays, _tie_mesh

W = H = 32
SPP4 = 4


def _plain_grid(v, f, dtype, tpc, supers_per, supers2_per=0):
    g = cg.build_chunk_grid(np.asarray(v, np.float32), f, tris_per_chunk=tpc,
                            supers_per=supers_per, supers2_per=supers2_per)
    rows = torch.tensor(cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)),
                                              np.zeros((f.shape[0], 3)),
                                              np.zeros(f.shape[0])))
    return g, wk.plain_grid(torch.tensor(g.cboxes), torch.tensor(g.sboxes),
                            torch.tensor(g.ssboxes), rows, dtype, tris_per_chunk=tpc,
                            supers_per=supers_per, supers2_per=supers2_per)


def _gated(rays, dtype, seed):
    """Rays [6, N] -> (o3, d3, tmin): half the rays with no sphere in
    front (1e20), half with one at a random distance that gates boxes
    and triangles."""
    r = torch.tensor(rays, dtype=dtype)
    rng = np.random.RandomState(seed)
    n = r.shape[1]
    tmin = np.where(rng.rand(n) < 0.5, cg.MISS_T, rng.uniform(1.0, 4.0, n))
    return tuple(r[0:3]), tuple(r[3:6]), torch.tensor(tmin, dtype=dtype)


def _both(grid, o3, d3, tmin, **kw):
    """(slot, tmin) of walk_plain and of walk_pairs_plain."""
    t_seq, t_par = tmin.clone(), tmin.clone()
    s_seq = wk.walk_plain(grid, o3, d3, t_seq, eps=1e-4, gate=tmin.clone())
    s_par = mpt.walk_pairs_plain(grid, o3, d3, t_par, eps=1e-4, gate=tmin.clone(), **kw)
    return (s_seq, t_seq), (s_par, t_par)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_pair_walk_matches_walk_plain_on_random_rays(dtype, sub, T, sp, sp2):
    v, f = meshes.icosphere(subdivisions=sub)
    _, grid = _plain_grid(v, f, dtype, T, sp, sp2)
    o3, d3, tmin = _gated(_sphere_rays(1024, seed=sub + T + sp), dtype, seed=sp2)
    (s_seq, t_seq), (s_par, t_par) = _both(grid, o3, d3, tmin)
    assert int((s_seq >= 0).sum()) > 100  # the mesh is hit, and the gate bites:
    assert bool(((s_seq < 0) & (tmin < cg.MISS_T)).any())
    assert torch.equal(s_par, s_seq) and torch.equal(t_par, t_seq)


def _tie_rays(n, seed):
    """[6, N] float32 rays from 40 units out aimed into the tie mesh."""
    rng = np.random.RandomState(seed)
    c = np.array([50.0, 40.0, 60.0])
    o = rng.randn(n, 3)
    o = c + o / np.linalg.norm(o, axis=1, keepdims=True) * 40.0
    d = c + rng.uniform(-12.0, 12.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d], 1).T.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T", [1, 4])
def test_pair_walk_takes_the_lowest_slot_of_a_tie_in_any_order(dtype, T):
    """Every face has two copies at the same t (in other chunks, and for
    most faces in another super): the lowest slot of the copies wins,
    whatever the order and the step size the pairs are folded in."""
    v, f = _tie_mesh()
    g, grid = _plain_grid(v, f, dtype, T, 2)
    r = torch.tensor(_tie_rays(512, seed=T), dtype=dtype)
    o3, d3 = tuple(r[0:3]), tuple(r[3:6])
    tmin = torch.full((r.shape[1],), cg.MISS_T, dtype=dtype)
    (s_seq, t_seq), _ = _both(grid, o3, d3, tmin)
    won = s_seq >= 0
    assert float(won.float().mean()) > 0.5
    # the brute answer: the lowest slot among the rows at the winning t
    rows = grid.rows.T
    nd = rows[3][None] * r[3][:, None] + rows[4][None] * r[4][:, None] + rows[5][None] * r[5][:, None]
    no = rows[3][None] * r[0][:, None] + rows[4][None] * r[1][:, None] + rows[5][None] * r[2][:, None]
    t_all = (rows[12][None] - no) / nd
    ties = (t_all == t_seq[:, None]) & (t_all > 1e-4)
    n_ties = ties.sum(dim=1)
    assert bool((n_ties[won] >= 3).all())  # each hit is a three-way tie
    first = torch.where(ties, torch.arange(rows.shape[1]), rows.shape[1]).min(dim=1).values
    assert torch.equal(s_seq[won], first[won])
    # the tied rows of a hit sit in more than one chunk and, for some, super
    slots = torch.arange(rows.shape[1])
    for per in (T, 2 * T):
        lo = torch.where(ties, slots // per, rows.shape[1]).min(dim=1).values
        hi = torch.where(ties, slots // per, -1).max(dim=1).values
        assert bool((hi[won] > lo[won]).any())
    gen = torch.Generator().manual_seed(T)
    for step in (32, 7):
        for _ in range(3):
            _, (s_par, t_par) = _both(grid, o3, d3, tmin, generator=gen, step=step)
            assert torch.equal(s_par, s_seq) and torch.equal(t_par, t_seq)


def test_pair_walk_winners_match_pallas_on_ties(monkeypatch):
    """The tie mesh (chunks of 1, supers of 2) in smallpt9, 2 bounces, zero
    uniforms: the twin with its walk replaced by the pair walk (a fresh
    random order at every query) gives the twin's wid bit for bit, and on
    the camera bounce the Pallas kernel's winners (the lowest slot of
    every three-way tie)."""
    v, f = _tie_mesh()
    jms = jax_mesh.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    planes, cb, sb, t24, mats, grid = jax_mpt.mesh_pt_tables(jms, tris_per_chunk=1,
                                                              supers_per=2)
    assert grid.n_chunks == f.shape[0] and grid.n_supers == f.shape[0] // 2
    bounces = 2
    _, jwid, _ = jax_mpt.render_pt_mesh_pallas(
        planes.astype(jnp.float32), cb, sb, t24, width=W, height=H, spp4=SPP4,
        materials=mats, bounces=bounces, rr_depth=2, tile=1024, interpret=True,
        with_residuals=True, **jax_mpt.pt_tables_kwargs(grid))
    jwid, _ = convert.residuals_from_jax(jwid, np.zeros((bounces, 7) + jwid.shape[1:]),
                                         spp4=SPP4, tile=1024)
    p, c, s, ss, t = convert.mesh_tables_from_numpy(np.asarray(planes, np.float64), cb, sb,
                                                    None, t24)
    kw = dict(materials=torch.tensor(mats, dtype=torch.int32), width=W, height=H,
              spp4=SPP4, tris_per_chunk=1, supers_per=2, bounces=bounces, rr_depth=2,
              uniforms=torch.zeros((SPP4, ptk.n_uniforms(bounces), W * H)),
              with_residuals=True)
    img, wid, resv = mpt.render_pt_mesh(p, c, s, t, ss, **kw)
    gen = torch.Generator().manual_seed(0)

    def pairs(grid, o3, d3, tmin, *, eps, gate, counts=None, marks=None):
        assert counts is None and marks is None
        return mpt.walk_pairs_plain(grid, o3, d3, tmin, eps=eps, gate=gate, generator=gen)

    monkeypatch.setattr(mpt, "walk_plain", pairs)
    img2, wid2, resv2 = mpt.render_pt_mesh(p, c, s, t, ss, **kw)
    assert torch.equal(wid2, wid) and torch.equal(resv2, resv) and torch.equal(img2, img)
    tri = wid[0] >= p.shape[1]
    assert int(tri.sum()) > 100
    assert torch.equal(wid[0], jwid[0])
    # the winners are the lowest slots of their ties (copies 0-2 of a face)
    faces = np.asarray(grid.face_of_slot)[wid[0][tri].numpy() - p.shape[1]]
    copies = [np.flatnonzero(np.asarray(grid.face_of_slot) % (f.shape[0] // 3) == x)
              for x in faces % (f.shape[0] // 3)]
    assert all(len(cs) == 3 for cs in copies)
    assert np.array_equal(wid[0][tri].numpy() - p.shape[1], [cs.min() for cs in copies])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_root_entries_cover_the_top_level(dtype, sub, T, sp, sp2):
    """Every ray that enters a box of the top level enters the warp walk's
    root box (so a bound may charge the top level to those rays alone),
    and the root turns the others away: rays that miss the mesh's bounds
    or stop at a sphere before them."""
    v, f = meshes.icosphere(subdivisions=sub)
    _, grid = _plain_grid(v, f, dtype, T, sp, sp2)
    o3, d3, tmin = _gated(_sphere_rays(1024, seed=sub + T), dtype, seed=sp)
    root = mpt.root_entries(grid, o3, d3, tmin)
    inv = [1.0 / torch.where(d == 0, 1e-30, d) for d in d3]
    top = grid.ssboxes or grid.sboxes or grid.cboxes
    in_top = mpt._slab_all(top, (*o3, *inv), tmin).any(dim=1)
    assert bool((root | ~in_top).all())
    assert int(in_top.sum()) > 100 and int((~root).sum()) > 100


def test_root_is_unbounded_past_root_max_boxes():
    """A top level of more than ROOT_MAX_BOXES boxes has no root box: every
    ray counts as entering, also one pointing away from every box."""
    box = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    o3 = tuple(torch.full((4,), 5.0) for _ in range(3))
    d3 = (torch.ones(4), torch.zeros(4), torch.zeros(4))  # away from the box
    gate = torch.full((4,), cg.MISS_T)
    for n, enters in ((mpt.ROOT_MAX_BOXES, False), (mpt.ROOT_MAX_BOXES + 1, True)):
        grid = wk.PlainGrid([box] * n, [], [], torch.zeros((n, 24)), 1, 0, 0)
        assert torch.equal(mpt.root_entries(grid, o3, d3, gate), torch.full((4,), enters))


# The traversal kernel (csrc/wbvh.cu) walks the same pairs with boxes not
# gated, from the twin's initial tmin (MISS_T), and counts per ray the
# boxes each ray enters.
def _both_unbounded(grid, o3, d3, **kw):
    """(slot, tmin, counts) of walk_plain and of walk_pairs_plain with the
    boxes not gated, from MISS_T."""
    m = o3[0].shape[0]
    out = []
    for walk, extra in ((wk.walk_plain, {}), (mpt.walk_pairs_plain, dict(gate=None, **kw))):
        tmin = torch.full((m,), cg.MISS_T, dtype=o3[0].dtype)
        counts = torch.zeros((3, m), dtype=torch.int32)
        slot = walk(grid, o3, d3, tmin, eps=1e-4, counts=counts, **extra)
        out.append((slot, tmin, counts))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_unbounded_pair_walk_matches_walk_plain_with_counts(dtype, sub, T, sp, sp2):
    """Random-direction rays: the same winners, t and per-ray counts
    (chunks tested, supers hit, super-supers hit) in ray order and under
    random pair orders."""
    v, f = meshes.icosphere(subdivisions=sub)
    _, grid = _plain_grid(v, f, dtype, T, sp, sp2)
    r = torch.tensor(_sphere_rays(1024, seed=sub + T + sp + sp2), dtype=dtype)
    o3, d3 = tuple(r[0:3]), tuple(r[3:6])
    (s_seq, t_seq, c_seq), (s_par, t_par, c_par) = _both_unbounded(grid, o3, d3)
    assert int((s_seq >= 0).sum()) > 100 and int(c_seq[0].sum()) > 1000
    assert bool((c_seq[1] > 0).any()) == bool(sp) and bool((c_seq[2] > 0).any()) == bool(sp2)
    assert torch.equal(s_par, s_seq) and torch.equal(t_par, t_seq)
    assert torch.equal(c_par, c_seq)
    gen = torch.Generator().manual_seed(sub + T)
    _, (s_rnd, t_rnd, c_rnd) = _both_unbounded(grid, o3, d3, generator=gen, step=32)
    assert torch.equal(s_rnd, s_seq) and torch.equal(t_rnd, t_seq) and torch.equal(c_rnd, c_seq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unbounded_pair_walk_takes_the_lowest_slot_of_a_tie_in_any_order(dtype):
    """The tie mesh (every face three times, in other chunks and supers):
    with the boxes not gated the lowest slot of each tie wins whatever
    the order and step, and the counts equal the per-ray walk's."""
    v, f = _tie_mesh()
    _, grid = _plain_grid(v, f, dtype, 1, 2)
    r = torch.tensor(_tie_rays(512, seed=5), dtype=dtype)
    o3, d3 = tuple(r[0:3]), tuple(r[3:6])
    (s_seq, t_seq, c_seq), _ = _both_unbounded(grid, o3, d3)
    assert float((s_seq >= 0).float().mean()) > 0.5
    gen = torch.Generator().manual_seed(3)
    for step in (32, 5):
        _, (s_par, t_par, c_par) = _both_unbounded(grid, o3, d3, generator=gen, step=step)
        assert torch.equal(s_par, s_seq) and torch.equal(t_par, t_seq)
        assert torch.equal(c_par, c_seq)


@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_unbounded_root_entries_cover_the_top_level(sub, T, sp, sp2):
    """With no gate the root still holds every ray that enters a top-level
    box, turns away the rays that miss the mesh's bounds, and takes every
    ray the gated root takes."""
    v, f = meshes.icosphere(subdivisions=sub)
    _, grid = _plain_grid(v, f, torch.float32, T, sp, sp2)
    o3, d3, tmin = _gated(_sphere_rays(1024, seed=sub + T + 7), torch.float32, seed=sp)
    root = mpt.root_entries(grid, o3, d3)
    inv = [1.0 / torch.where(d == 0, 1e-30, d) for d in d3]
    top = grid.ssboxes or grid.sboxes or grid.cboxes
    in_top = mpt._slab_all(top, (*o3, *inv), None).any(dim=1)
    assert bool((root | ~in_top).all()) and int((~root).sum()) > 100
    assert bool((root | ~mpt.root_entries(grid, o3, d3, tmin)).all())
