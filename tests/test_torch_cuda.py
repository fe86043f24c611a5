"""The port's tests that need a CUDA card: each hand-written kernel against
its plain twin on the card, the wrappers' launch counts, and the
determinism of the segment-sum.  They skip where torch.cuda.is_available()
is false.

This file imports torch, numpy, pytest and the port only (no jax and
nothing of the JAX package), so that it runs on a machine without jax:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports jax, out of
the run; ``chip_smoke.py`` runs exactly this command on the card)."""

import json

import numpy as np
import pytest
import torch

from ascendpathtracing_tpu_torch import camera, cli, convert, scenes
from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import meshes, tri
from ascendpathtracing_tpu_torch.diff import camera_fused as dcf
from ascendpathtracing_tpu_torch.diff.camera import CameraParams
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk

LIGHT = 7  # cornell8's light
TRAVERSALS = [  # (subdivisions, tris_per_chunk, supers_per, supers2_per)
    (2, 8, 0, 0),
    (2, 8, 4, 0),
    (3, 8, 4, 4),
    (2, 8, 4, 8),  # ragged super-supers: pad chunks take part in the walk
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------- inputs ----
def _random_rays(n, seed=0, spread=3.0):
    """[6, N] float32 rays, origins ~N(0, spread^2), unit directions."""
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * spread).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d], 1).T.copy()


def _aimed_rays(n, seed=1):
    """[6, N] float32 rays from radius 3 aimed into the unit ball."""
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n)
    o = (o / np.linalg.norm(o, axis=0) * 3.0).astype(np.float32)
    d = rng.uniform(-0.6, 0.6, (3, n)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0).astype(np.float32)


def _sphere_rays(n=2048, seed=1):
    """[6, N] float32 rays from radius 3: half in random directions, half
    aimed at random points inside the unit ball."""
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n).astype(np.float32)
    o /= np.linalg.norm(o, axis=0)
    o *= 3.0
    d = rng.randn(3, n).astype(np.float32)
    target = rng.uniform(-0.55, 0.55, (3, n // 2)).astype(np.float32)
    d[:, n // 2:] = target - o[:, n // 2:]
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0)


def _pt_scene(name, dtype, device):
    sc = scenes.get_scene(name)
    return (convert.scene_planes_from_numpy(sc.soa10(np.float64), device=device, dtype=dtype),
            torch.tensor(sc.material, dtype=torch.int32, device=device))


def _reference_inputs(w, np_dt, device):
    """Camera rays and cornell8's planes as the port's tensors."""
    t_dt = torch.float64 if np_dt == np.float64 else torch.float32
    rays = camera.generate_rays_numpy(w, w, 1, seed=0).astype(np_dt)
    return (convert.rays_planes_from_numpy(rays, device=device, dtype=t_dt),
            convert.scene_planes_from_numpy(scenes.cornell8().soa10(np_dt), device=device,
                                            dtype=t_dt))


def _clustered(n, s, r):
    """Clustered ids (the replay stream's shape), 1% -1 and 1% s + 7."""
    rng = np.random.RandomState(n + s)
    seg = (rng.randint(0, 20, n) * (s // 20) + rng.randint(0, s // 40, n)).astype(np.int32)
    seg[: n // 100] = -1
    seg[n // 100: n // 50] = s + 7
    return seg, rng.randn(r, n).astype(np.float32)


def _mixed_scene(subdivisions=2):
    """The JAX fused-kernel tests' scene: an icosphere in smallpt9, a third
    of the faces mirrors, a sixth glass, four emissive."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=subdivisions)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2), base_scene="smallpt9")
    nf = ms.faces.shape[0]
    ms.face_material[: nf // 3] = scenes.SPEC
    ms.face_material[nf // 3: nf // 2] = scenes.REFR
    ms.face_emission[:4] = (0.0, 2.0, 0.5)
    return ms


# ------------------------------------------------ reference kernels ----
@pytest.mark.cuda
@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
def test_render_kernels_match_plain_twins(cuda, np_dt):
    rp, sp = _reference_inputs(64, np_dt, cuda)
    kw = dict(light_index=LIGHT, bounces=8)
    c, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    cp, idxp = rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
    assert torch.equal(idx, idxp) and torch.equal(c, cp)
    assert torch.equal(rk.render_reference_planes(rp, sp, **kw), c)
    n = rp.shape[1]
    g = torch.arange(3 * n, device=cuda, dtype=sp.dtype).reshape(3, n)
    rtol = 1e-5 if np_dt == np.float32 else 1e-12
    plain = rk.render_ref_bwd_replay_plain(idx, sp, g, **kw)
    for got in (rk.render_ref_bwd_replay(idx, sp, g, **kw), rk.render_ref_bwd(rp, sp, g, **kw)):
        torch.testing.assert_close(got, plain, rtol=rtol, atol=0.0)


@pytest.mark.cuda
def test_render_wrapper_counts_launches(cuda):
    rp, sp = _reference_inputs(16, np.float32, cuda)
    rk.reset_launches()
    model = rk.RenderReference(sp, light_index=LIGHT, bounces=8)
    model(rp).sum().backward()
    assert rk.LAUNCHES == {"fwd": 0, "fwd_idx": 1, "bwd_replay": 1, "bwd_recompute": 0}


@pytest.mark.cuda
def test_cli_render_matches_oracle(cuda, tmp_path, capsys):
    assert cli.main(["render", "--backend", "cuda", "--width", "64", "--height",
                     "64", "--bounces", "1", "--oracle", "--out", str(tmp_path)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["backend"] == "cuda" and stats["oracle_rays_bitexact"] == 1.0


# ------------------------------------------------ fused path tracer ----
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell8", "smallpt9"])
def test_pt_kernel_matches_twin_f64(cuda, name):
    planes, mats = _pt_scene(name, torch.float64, cuda)
    kw = dict(width=64, height=64, spp4=16, bounces=8, rr_depth=5)
    torch.testing.assert_close(ptk.render_pt(planes, mats, **kw),
                               ptk.render_pt_plain(planes, mats, **kw), rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_pt_kernel_matches_twin_f32_and_counts(cuda):
    planes, mats = _pt_scene("cornell8", torch.float32, cuda)
    kw = dict(width=48, height=40, spp4=8, bounces=8, rr_depth=5)
    ptk.reset_launches()
    k = ptk.render_pt(planes, mats, **kw)
    assert ptk.LAUNCHES == {"pt": 1}
    p = ptk.render_pt_plain(planes, mats, **kw)
    assert float(((k - p).abs() <= 1e-5 * p.abs()).float().mean()) >= 0.999


# ----------------------------------------- chunk grid and fused mesh ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub,T,sp,sp2", TRAVERSALS)
def test_wbvh_kernel_matches_twin(cuda, dtype, sub, T, sp, sp2):
    v, f = meshes.icosphere(subdivisions=sub)
    v = np.asarray(v, np.float32)
    g = cg.build_chunk_grid(v, f, tris_per_chunk=T, supers_per=sp, supers2_per=sp2)
    rows = torch.tensor(cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)),
                                              np.zeros((f.shape[0], 3)),
                                              np.arange(f.shape[0]) % 3), device=cuda)
    cb, sb, _, _ = cg.chunk_grid_to_device(g, cuda)
    ssb = torch.tensor(g.ssboxes, device=cuda)
    rays = torch.tensor(_sphere_rays(4096), dtype=dtype, device=cuda)
    kw = dict(tris_per_chunk=T, supers_per=sp, supers2_per=sp2, attrs=True, stats=True)
    wk.reset_launches()
    k = wk.intersect_chunks(rays, cb, sb, rows, ssb, **kw)
    assert wk.LAUNCHES == {"wbvh": 1}
    p = wk.intersect_chunks_plain(rays, cb, sb, rows, ssb, **kw)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[3], p[3])
    assert all(torch.equal(a, b) for a, b in zip(k[2], p[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_pt_kernel_matches_twin(cuda, dtype):
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), device=cuda,
                                                         dtype=dtype, tris_per_chunk=8,
                                                         supers_per=4)
    kw = dict(materials=mats, width=48, height=40, spp4=8, bounces=8, rr_depth=5,
              **mpt.pt_tables_kwargs(grid, cuda))
    mpt.reset_launches()
    k = mpt.render_pt_mesh(planes, cb, sb, t24, **kw)
    assert mpt.LAUNCHES == {"mesh_pt": 1}
    p = mpt.render_pt_mesh_plain(planes, cb, sb, t24, **kw)
    if dtype == torch.float64:
        torch.testing.assert_close(k, p, rtol=1e-9, atol=0)
    else:
        assert float(((k - p).abs() <= 1e-5 * p.abs()).float().mean()) >= 0.999


# ------------------------------------------------------ segment-sum ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segsum_kernel_matches_twin(cuda, dtype):
    seg, vals = _clustered(50000, 20000, 6)
    seg, vals = torch.tensor(seg, device=cuda), torch.tensor(vals, dtype=dtype, device=cuda)
    hk.reset_launches()
    got, kocc = hk.segment_rows_paged(seg, vals, n_slots=20000)
    assert hk.LAUNCHES == {"segsum": 1}
    exp = hk.segment_rows_plain(seg, vals.double(), n_slots=20000)
    assert torch.equal(kocc, hk.occupancy_plain(seg, n_slots=20000))
    torch.testing.assert_close(got.double(), exp, rtol=0, atol=1e-5 * float(vals.abs().sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_slots,r", [(50000, 20000, 6), (300000, 9 + 5120, 8), (777, 3, 1)])
def test_segsum_kernel_repeats_bitwise(cuda, dtype, n, n_slots, r):
    """Two launches on the same inputs give the same sums bit for bit,
    through both wrappers, and stay within 1e-5 x sum |rows| of the
    float64 twin per segment."""
    rng = np.random.RandomState(n)
    runs = np.repeat(rng.randint(-1, n_slots + 3, n // 7 + 1), 7)[:n]  # runs of equal ids
    seg = torch.tensor(runs.astype(np.int32), device=cuda)
    vals = torch.tensor(rng.randn(r, n), dtype=dtype, device=cuda)
    a, ka = hk.segment_rows_paged(seg, vals, n_slots=n_slots)
    b, kb = hk.segment_rows_paged(seg, vals, n_slots=n_slots)
    assert torch.equal(a, b) and torch.equal(ka, kb)
    m1 = hk.segment_rows_matmul(seg, vals, n_slots=n_slots)
    assert torch.equal(m1, hk.segment_rows_matmul(seg, vals, n_slots=n_slots))
    ref = hk.segment_rows_plain(seg, vals.double(), n_slots=n_slots)
    mag = hk.segment_rows_plain(seg, vals.double().abs(), n_slots=n_slots)
    assert bool(((a.double() - ref).abs() <= 1e-5 * mag).all())
    assert bool(((m1.double() - ref).abs() <= 1e-5 * mag).all())


# ------------------------------------------------------- BVH kernel ----
@pytest.mark.cuda
@pytest.mark.parametrize("max_leaf", [4, 64])
def test_bvh_kernel_matches_twin(cuda, max_leaf):
    v, f = meshes.icosphere(subdivisions=3)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf)
    planes = tuple(tuple(c[bvh.tri_order] for c in t)
                   for t in tri.triangle_planes(v, f, dtype=np.float32))
    tables = bk.pack_bvh(bvh, planes, cuda)
    rays = torch.tensor(np.concatenate([_random_rays(4096), _aimed_rays(4096)], 1),
                        device=cuda)
    bk.reset_launches()
    k = bk.intersect_bvh(rays, *tables, max_leaf=max_leaf)
    assert bk.LAUNCHES == {"bvh": 1}
    p = bk.intersect_bvh_plain(rays, *tables, max_leaf=max_leaf)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


# -------------------------------------- camera and stats outputs ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("supers_per,supers2_per", [(0, 0), (4, 0), (4, 4)])
def test_mesh_pt_camera_and_stats_match_twin(cuda, dtype, supers_per, supers2_per):
    """with_camera and with_stats, together and each on its own: image,
    wid, resv and suv bitwise, kstats equal (per 128-pixel tile and per
    pixel), and the image, wid and resv the same as without the options."""
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(
        _mixed_scene(3 if supers2_per else 2), device=cuda, dtype=dtype, tris_per_chunk=8,
        supers_per=supers_per, supers2_per=supers2_per)
    kw = dict(materials=mats, width=32, height=16, spp4=4, bounces=4, rr_depth=2,
              with_residuals=True, **mpt.pt_tables_kwargs(grid, cuda))
    base = mpt.render_pt_mesh(planes, cb, sb, t24, **kw)
    for tile in (128, 1):
        mpt.reset_launches()
        k = mpt.render_pt_mesh(planes, cb, sb, t24, with_camera=True, with_stats=True,
                               stats_tile=tile, **kw)
        assert mpt.LAUNCHES == {"mesh_pt": 1}
        p = mpt.render_pt_mesh_plain(planes, cb, sb, t24, with_camera=True, with_stats=True,
                                     stats_tile=tile, **kw)
        assert all(torch.equal(a, b) for a, b in zip(k, p))
        assert all(torch.equal(a, b) for a, b in zip(k[:3], base))
        assert int(k[4][0].max()) > 0
        cam = mpt.render_pt_mesh(planes, cb, sb, t24, with_camera=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip(cam, p[:4]))
        img, ks = mpt.render_pt_mesh(planes, cb, sb, t24, with_stats=True, stats_tile=tile,
                                     **{**kw, "with_residuals": False})
        assert torch.equal(img, p[0]) and torch.equal(ks, p[4])


@pytest.mark.cuda
def test_render_with_camera_on_the_card(cuda):
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), device=cuda)
    kw = dict(materials=mats, width=32, height=32, spp4=4, bounces=2, rr_depth=2,
              **mpt.pt_tables_kwargs(grid, cuda))
    params = {k: v.requires_grad_(True) for k, v in
              CameraParams(dtype=torch.float64, device=cuda).items()}
    mpt.reset_launches()
    hk.reset_launches()
    image, depth, (wid, resv, suv) = dcf.render_with_camera(params, planes, cb, sb, t24, **kw)
    grads = torch.autograd.grad((depth * depth).mean(), list(params.values()))
    assert mpt.LAUNCHES == {"mesh_pt": 1} and hk.LAUNCHES == {"segsum": 0}
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0
    twin = mpt.render_pt_mesh_plain(planes, cb, sb, t24, cam=dcf.cam_vector(
        params, 32, 32, dtype=torch.float32).detach(), with_residuals=True,
        with_camera=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(twin, (image, wid, resv, suv)))
