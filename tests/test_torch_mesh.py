"""The mesh layer of the port on the CPU: the chunk-grid builder copy
(ascendpathtracing_tpu_torch.ops.chunk_grid) against the JAX builder, the
shared procedural meshes, the brute-force triangle oracle, the mesh device
tables and first-hit query (models/mesh), and the chunk-grid traversal's
plain twin (ops/wbvh_kernels) against the Pallas kernel in interpret mode.
Tests marked ``cuda`` hold the CUDA kernel against the twin on a card and
skip without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, scenes
from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.accel import tri as jax_tri
from ascendpathtracing_tpu.models import mesh as jax_mesh
from ascendpathtracing_tpu.ops import pallas_mesh_pt as jax_mpt
from ascendpathtracing_tpu.ops import pallas_wbvh as W
from ascendpathtracing_tpu.utils import io
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.accel import tri
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(n=2048, seed=1):
    """[6, N] float32 rays from radius 3: half in random directions (the
    JAX tests' distribution, ~3% hit the unit icosphere), half aimed at
    random points inside the unit ball (most hit)."""
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n).astype(np.float32)
    o /= np.linalg.norm(o, axis=0)
    o *= 3.0
    d = rng.randn(3, n).astype(np.float32)
    target = rng.uniform(-0.55, 0.55, (3, n // 2)).astype(np.float32)
    d[:, n // 2:] = target - o[:, n // 2:]
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0)


def _unit_sphere(subdivisions=2):
    v, f = meshes.icosphere(subdivisions=subdivisions)
    return np.asarray(v, np.float32), f


def _mixed_scene(module):
    """The JAX fused-kernel tests' scene (tests/test_pallas_mesh_pt.py:
    34-45): icosphere s2 in smallpt9, a third of the faces mirrors, a
    sixth glass, four emissive."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=2)
    ms = module.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2),
                                            base_scene="smallpt9")
    nf = ms.faces.shape[0]
    ms.face_material[: nf // 3] = scenes.SPEC
    ms.face_material[nf // 3: nf // 2] = scenes.REFR
    ms.face_emission[:4] = (0.0, 2.0, 0.5)
    return ms


# ------------------------------------------------------------ builder ----
GRIDS = [  # (subdivisions, tris_per_chunk, supers_per, supers2_per)
    (3, 8, 0, 0),   # one level
    (3, 16, 4, 0),  # two levels
    (3, 8, 4, 4),   # three levels
    (2, 8, 4, 8),   # three levels, ragged last super-super (padded)
    (2, 7, 3, 0),   # ragged chunks and supers
]


@pytest.mark.parametrize("sub,T,sp,sp2", GRIDS)
def test_chunk_grid_equals_jax_builder(sub, T, sp, sp2):
    """Every array of the NumPy copy equals the JAX builder's."""
    v, f = _unit_sphere(sub)
    got = cg.build_chunk_grid(v, f, tris_per_chunk=T, supers_per=sp, supers2_per=sp2)
    ref = W.build_chunk_grid(v, f, tris_per_chunk=T, supers_per=sp, supers2_per=sp2)
    for name in ("cboxes", "sboxes", "ssboxes", "tris", "face_of_slot"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.tris_per_chunk, got.supers_per, got.supers2_per) == (T, sp, sp2)
    assert (got.n_chunks, got.n_supers, got.n_supers2) == (ref.n_chunks, ref.n_supers,
                                                           ref.n_supers2)


def test_attr_rows_and_permutation_equal_jax():
    ms = _mixed_scene(mm)
    got = cg.build_chunk_grid(ms.vertices, ms.faces, tris_per_chunk=8, supers_per=4)
    ref = W.build_chunk_grid(ms.vertices, ms.faces, tris_per_chunk=8, supers_per=4)
    args = (ms.face_albedo, ms.face_emission, ms.face_material)
    np.testing.assert_array_equal(cg.attr_triangle_rows(got, *args),
                                  W.attr_triangle_rows(ref, *args))
    np.testing.assert_array_equal(cg.permute_face_attrib(got, ms.face_material, -1),
                                  W.permute_face_attrib(ref, ms.face_material, -1))
    cb, sb, tr, fos = cg.chunk_grid_to_device(got)
    assert cb.dtype == sb.dtype == tr.dtype == torch.float32 and fos.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), ref.tris)


def test_builder_takes_groups_past_128():
    """The JAX builder's 128-box flag-block cap does not apply."""
    v, f = _unit_sphere(3)  # 1,280 triangles: 320 chunks of 4
    g = cg.build_chunk_grid(v, f, tris_per_chunk=4, supers_per=160)
    assert g.n_chunks == g.n_supers * 160 and g.n_supers == 2
    with pytest.raises(ValueError):
        W.build_chunk_grid(v, f, tris_per_chunk=4, supers_per=160)


@pytest.mark.parametrize("n_faces,T,given,want", [
    (320, 16, None, (0, 0)),       # 20 chunks: one level
    (5120, 16, None, (16, 0)),     # 320 chunks: supers
    (81920 * 16, 16, None, (16, 16)),  # 5,120 supers: super-supers
    (5120, 16, 4, (4, 0)),         # a given supers_per is kept
    (320, 8, 0, (0, 0)),
])
def test_auto_levels_follow_the_jax_defaults(n_faces, T, given, want):
    """pallas_mesh_pt.mesh_pt_tables:79-85 and models/mesh.py:113-118."""
    assert cg.auto_levels(n_faces, T, given) == want


# --------------------------------------------------- shared host code ----
def test_host_meshes_are_the_jax_package_meshes(tmp_path):
    for a, b in ((meshes.icosphere(center=(1, 2, 3), radius=2.0, subdivisions=2),
                  jax_meshes.icosphere(center=(1, 2, 3), radius=2.0, subdivisions=2)),
                 (meshes.cube(center=(50, 30, 60), size=25.0),
                  jax_meshes.cube(center=(50, 30, 60), size=25.0))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    v, f = meshes.icosphere(subdivisions=1)
    meshes.save_obj(tmp_path / "m.obj", v, f)
    got = meshes.load_obj(tmp_path / "m.obj")
    ref = jax_meshes.load_obj(tmp_path / "m.obj", native="never")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(meshes.transform(v, scale=2.0, rotate_y=0.3),
                                  jax_meshes.transform(v, scale=2.0, rotate_y=0.3))


def test_brute_force_equals_jax_float64():
    """Moller-Trumbore over every face, float64: t equal to JAX's to 1e-12
    relative (the same op order; XLA's CPU fusion may round differently)
    and the same misses and argmin faces."""
    v, f = meshes.icosphere(subdivisions=2)
    rays = _rays(512).astype(np.float64)
    planes = tri.triangle_planes(v, f, dtype=np.float64)
    got = tri.intersect_triangles_brute(
        tuple(torch.tensor(rays[i]) for i in range(3)),
        tuple(torch.tensor(rays[i]) for i in range(3, 6)),
        *[tuple(torch.tensor(c) for c in p) for p in planes], 1e-4,
    ).numpy()
    ref = np.asarray(jax_tri.intersect_triangles_brute(
        tuple(jnp.asarray(rays[i]) for i in range(3)),
        tuple(jnp.asarray(rays[i]) for i in range(3, 6)),
        *[tuple(jnp.asarray(c) for c in p) for p in planes], 1e-4,
    ))
    assert got.shape == ref.shape == (f.shape[0], 512)
    np.testing.assert_array_equal(got >= 1e19, ref >= 1e19)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.argmin(0), ref.argmin(0))
    assert (got.min(0) < 1e19).mean() > 0.3


# --------------------------------------------------------- models/mesh ----
def test_first_hit_brute_reproduces_the_mesh_golden():
    """tests/goldens/mesh_cube_firsthit_32x32.ppm, quantized as
    tests/test_goldens.py:83-106 does: equal in every pixel."""
    v, f = meshes.cube(center=(50, 30, 60), size=25.0)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.8, 0.5, 0.2))
    dev = mm.mesh_scene_to_device(ms, dtype=torch.float64, use_bvh=False)
    rays = camera.generate_rays_numpy(32, 32, 1, seed=0)
    tmin, kind, hid = (x.numpy() for x in mm.first_hit_mesh_impl(torch.tensor(rays), dev))
    depth = np.where(kind == 0, 0.0, np.clip(tmin / 300.0, 0.0, 1.0))
    planes = np.stack([kind.astype(np.float64) * (80.0 / 255.0), depth,
                       (hid % 251).astype(np.float64) / 255.0], axis=1)
    golden = io.read_ppm("tests/goldens/mesh_cube_firsthit_32x32.ppm")
    np.testing.assert_array_equal(io.decode_color(planes, 32, 32, 1), golden)


def test_first_hit_brute_float64_equals_jax():
    v, f = meshes.icosphere(center=(50, 40, 60), radius=12.0, subdivisions=2)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.9, 0.6, 0.2))
    jms = jax_mesh.MeshScene.cornell_with_mesh(v, f, albedo=(0.9, 0.6, 0.2))
    rays = camera.generate_rays_numpy(24, 24, 1, seed=0)
    got = mm.first_hit_mesh_impl(
        torch.tensor(rays), mm.mesh_scene_to_device(ms, dtype=torch.float64, use_bvh=False))
    ref = jax_mesh.first_hit_mesh(
        jnp.asarray(rays), jax_mesh.mesh_scene_to_device(jms, dtype=jnp.float64, use_bvh=False))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-12)
    assert (got[1].numpy() == 2).sum() > 50


def test_first_hit_chunks_matches_brute():
    """As tests/test_mesh_render.py:74-93: the chunk-grid traversal in the
    first-hit query agrees with brute force: same kind, same winning face
    (through face_of_slot), t to the f32 rounding of the two forms."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=12.0, subdivisions=2)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.9, 0.6, 0.2))
    rays = torch.tensor(camera.generate_rays_numpy(24, 24, 1, seed=0).astype(np.float32))
    dev_c = mm.mesh_scene_to_device(ms, pallas_bvh_kernel=True)
    dev_n = mm.mesh_scene_to_device(ms, use_bvh=False)
    t_c, k_c, h_c = mm.first_hit_mesh_impl(rays, dev_c)
    t_n, k_n, h_n = mm.first_hit_mesh_impl(rays, dev_n)
    assert torch.equal(k_c, k_n)
    tri_hit = k_n == 2
    assert int(tri_hit.sum()) > 50
    assert torch.equal(dev_c["face_of_slot"][h_c[tri_hit].long()], h_n[tri_hit])
    np.testing.assert_allclose(t_c[tri_hit].numpy(), t_n[tri_hit].numpy(), rtol=1e-4)


def test_chunks_tables_equal_jax():
    """The chunks-mode traversal tables equal the JAX package's."""
    ms = _mixed_scene(mm)
    got = mm.mesh_scene_to_device(ms, pallas_bvh_kernel=True)
    ref = jax_mesh.mesh_scene_to_device(_mixed_scene(jax_mesh), pallas_bvh_kernel=True)
    for a, b in zip(got["wbvh"], ref["wbvh"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got["face_of_slot"].numpy(), np.asarray(ref["face_of_slot"]))
    assert tuple(got["static"]) == tuple(ref["static"])
    assert tuple(got["static"]) == ("chunks", 0, 16, 0, False, 0)


@pytest.mark.parametrize("kw,traversal", [
    (dict(use_bvh=True), "jnp"),
    (dict(pallas_bvh_kernel=True, pallas_kernel="lockstep"), "lockstep"),
    (dict(pallas_bvh_kernel=True, diff=True), "chunks"),
    (dict(use_bvh=False), "brute"),
])
def test_unported_traversal_modes_raise(kw, traversal):
    """The modes that raised NotImplementedError before the bounce-loop
    renderer was ported (the jnp BVH, the lockstep kernel, diff=True) no
    longer raise: each builds its tables and renders a finite image."""
    v, f = meshes.cube(center=(50, 30, 60), size=25.0)
    dev = mm.mesh_scene_to_device(mm.MeshScene.cornell_with_mesh(v, f), **kw)
    assert dev["static"].traversal == traversal
    assert dev["static"].diff == (kw.get("diff", False) or traversal in ("jnp", "brute"))
    rays = torch.tensor(camera.generate_rays_numpy(8, 8, 1, seed=0).astype(np.float32))
    img = mm.render_pt_mesh_impl(rays, dev, bounces=3)
    assert img.shape == (256, 3) and bool(torch.isfinite(img).all())


# ------------------------------------------------ traversal twin vs JAX ----
TRAVERSALS = [  # (subdivisions, tris_per_chunk, supers_per, supers2_per)
    (2, 8, 0, 0),
    (2, 8, 4, 0),
    (3, 8, 4, 4),
    (2, 8, 4, 8),  # ragged super-supers: pad chunks take part in the walk
]


@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_traversal_twin_matches_pallas_interpret(sub, T, sp, sp2):
    """2,048 rays, attrs=True.  Slots, the hit set and the 11 attribute
    planes are equal; tmin within 8 float32 ulp (XLA's CPU arithmetic in
    interpret mode against op-by-op IEEE; at most 3 ulp measured, 71% of
    hits bitwise).  Per-ray chunk
    counts never exceed the JAX tile's worklist length k (the tile lists a
    chunk when any of its rays' slab tests passes)."""
    v, f = _unit_sphere(sub)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=T, supers_per=sp, supers2_per=sp2)
    rows = cg.attr_triangle_rows(g, np.full((f.shape[0], 3), 0.5),
                                 np.arange(3 * f.shape[0]).reshape(-1, 3) / 7.0,
                                 np.arange(f.shape[0]) % 3)
    rays = _rays()
    tj, hj, aj, kj = W.intersect_chunks_pallas(
        jnp.asarray(rays), jnp.asarray(g.cboxes), jnp.asarray(g.sboxes),
        jnp.asarray(rows), jnp.asarray(g.ssboxes) if g.n_supers2 else None,
        tris_per_chunk=T, supers_per=sp, supers2_per=sp2, tile=1024,
        attrs=True, stats=True, interpret=True,
    )
    _, cb, sb, ssb, t24 = convert.mesh_tables_from_numpy(
        np.zeros((10, 1)), g.cboxes, g.sboxes, g.ssboxes, rows)
    tp, hp, ap, kp = wk.intersect_chunks(
        torch.tensor(rays), cb, sb, t24, ssb, tris_per_chunk=T, supers_per=sp,
        supers2_per=sp2, attrs=True, stats=True,
    )
    tj, tp = np.asarray(tj), tp.numpy()
    hit = tj < 1e19
    assert 0.3 < hit.mean() < 0.7
    np.testing.assert_array_equal(tp < 1e19, hit)
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    ulp = np.abs(tp[hit].view(np.int32) - tj[hit].view(np.int32))
    assert ulp.max() <= 8, ulp.max()
    assert (tp[~hit] == tj[~hit]).all()
    for a, b in zip(ap, aj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tile_k = np.repeat(np.asarray(kj)[0], 1024)
    assert (kp[0].numpy() <= tile_k).all() and kp[0].numpy().max() > 0
    if not sp:
        assert int(kp[1:].abs().max()) == 0
    if not sp2:
        assert int(kp[2].abs().max()) == 0


def test_walk_counts_follow_the_levels():
    """Per-ray counts: a chunk is tested only inside a hit super, a super
    only inside a hit super-super; a ray that misses every box counts 0."""
    v, f = _unit_sphere(3)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=8, supers_per=4, supers2_per=4)
    cb, sb, tr, _ = cg.chunk_grid_to_device(g)
    rays = torch.tensor(_rays(512))
    rays[:, 0] = torch.tensor([5.0, 5.0, 5.0, 1.0, 0.0, 0.0])  # away from the mesh
    tmin, hit, counts = wk.intersect_chunks(
        rays, cb, sb, tr, torch.tensor(g.ssboxes), tris_per_chunk=8, supers_per=4,
        supers2_per=4, stats=True)
    k, ks, kss = counts
    assert int(k[0]) == int(ks[0]) == int(kss[0]) == 0
    assert float(tmin[0]) == float(np.float32(1e20))
    assert int(hit[0]) == 0
    assert (k <= 4 * ks).all() and (ks <= 4 * kss).all() and (kss <= g.n_supers2).all()
    assert ((tmin < 1e19) <= (k > 0)).all()


def test_twin_float64_rays_equal_brute_winners():
    """float64 rays (the float32 rows widened): the same winning faces as
    the float64 brute force, and t within 1e-6 relative (the rows' planes
    are rounded to float32; 6e-8 measured)."""
    v, f = _unit_sphere(2)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=8, supers_per=4)
    cb, sb, tr, fos = cg.chunk_grid_to_device(g)
    rays = _rays(1024).astype(np.float64)
    tmin, hit = wk.intersect_chunks(torch.tensor(rays), cb, sb, tr, tris_per_chunk=8,
                                    supers_per=4)
    assert tmin.dtype == torch.float64
    planes = tri.triangle_planes(v.astype(np.float64), f)
    ts = tri.intersect_triangles_brute(
        tuple(torch.tensor(rays[i]) for i in range(3)),
        tuple(torch.tensor(rays[i]) for i in range(3, 6)),
        *[tuple(torch.tensor(c) for c in p) for p in planes], 1e-4)
    bt, bf = ts.amin(0), ts.argmin(0)
    won = bt < 1e19
    assert torch.equal(tmin < 1e19, won)
    assert torch.equal(fos[hit.long()][won].long(), bf[won])
    np.testing.assert_allclose(tmin[won].numpy(), bt[won].numpy(), rtol=1e-6)


def test_cpu_tensors_run_the_twin_without_counting():
    v, f = _unit_sphere(1)
    cb, sb, tr, _ = cg.chunk_grid_to_device(cg.build_chunk_grid(v, f, tris_per_chunk=8))
    wk.reset_launches()
    wk.intersect_chunks(torch.tensor(_rays(64)), cb, sb, tr, tris_per_chunk=8)
    assert wk.LAUNCHES == {"wbvh": 0}


def _grid_inputs():
    v, f = _unit_sphere(1)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=8, supers_per=2)
    cb, sb, tr, _ = cg.chunk_grid_to_device(g)
    return dict(rays=torch.tensor(_rays(64)), cb=cb, sb=sb, tr=tr, T=8, sp=2)


@pytest.mark.parametrize(
    "change,exc",
    [
        (dict(rays=torch.zeros(5, 8)), ValueError),  # not [6, N]
        (dict(rays=torch.zeros(6, 8, dtype=torch.int32)), TypeError),
        (dict(rays=torch.zeros(8, 6).T), ValueError),  # not contiguous
        (dict(cb=torch.zeros(10, 6, dtype=torch.float64)), TypeError),
        (dict(cb=torch.zeros(10, 5)), ValueError),  # not [C, 6]
        (dict(sp=3), ValueError),  # sboxes x supers_per != chunks
        (dict(T=4), ValueError),  # tris rows != C * T
        (dict(tr=torch.zeros(80, 12)), ValueError),  # row width
        (dict(attrs=True), ValueError),  # attrs need 24-float rows
    ],
)
def test_wrapper_rejects_bad_inputs(change, exc):
    kw = _grid_inputs()
    kw.update(change)
    with pytest.raises(exc):
        wk.intersect_chunks(kw["rays"], kw["cb"], kw["sb"], kw["tr"], tris_per_chunk=kw["T"],
                            supers_per=kw["sp"], attrs=kw.get("attrs", False))


def test_tables_from_jax_carry_over():
    """convert.mesh_tables_from_numpy carries the JAX mesh_pt_tables over:
    planes in the asked dtype, float32 tables, an empty third level."""
    planes, cb, sb, t24, mats, grid = jax_mpt.mesh_pt_tables(_mixed_scene(jax_mesh))
    got = convert.mesh_tables_from_numpy(planes, cb, sb, None, t24, dtype=torch.float64)
    assert got[0].dtype == torch.float64 and got[0].shape == (10, 9)
    assert all(t.dtype == torch.float32 for t in got[1:])
    assert got[3].shape == (0, 6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(t24))
    with pytest.raises(ValueError):
        convert.mesh_tables_from_numpy(planes, np.zeros((4, 5)), sb, None, t24)


# ------------------------------------------------------- on a card ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_cuda_kernel_matches_twin(cuda, dtype, sub, T, sp, sp2):
    v, f = _unit_sphere(sub)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=T, supers_per=sp, supers2_per=sp2)
    rows = torch.tensor(cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)),
                                              np.zeros((f.shape[0], 3)),
                                              np.arange(f.shape[0]) % 3), device=cuda)
    cb, sb, _, _ = cg.chunk_grid_to_device(g, cuda)
    ssb = torch.tensor(g.ssboxes, device=cuda)
    rays = torch.tensor(_rays(4096), dtype=dtype, device=cuda)
    kw = dict(tris_per_chunk=T, supers_per=sp, supers2_per=sp2, attrs=True, stats=True)
    wk.reset_launches()
    k = wk.intersect_chunks(rays, cb, sb, rows, ssb, **kw)
    assert wk.LAUNCHES == {"wbvh": 1}
    p = wk.intersect_chunks_plain(rays, cb, sb, rows, ssb, **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[3], p[3])
    assert all(torch.equal(a, b) for a, b in zip(k[2], p[2]))
