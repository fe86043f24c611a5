"""Camera gradients through the fused mesh renderer in the port on the CPU
(diff/camera_fused over the twin of csrc/mesh_pt.cu): the four gates of
tests/test_camera_fused.py, and against the JAX package on the same
inputs: the twin's screen coordinates (with_camera), bounce-0 winners and
per-cell walk record (with_stats) against the Pallas kernel in interpret
mode (its u = 0 stream; the twin takes zero uniforms), cam_vector, and
primary_depth with its gradients against JAX's primary_depth and
jax.grad.  The scene is tests/test_camera_fused.py's: icosphere s2 in
smallpt9 over mesh_pt_tables (chunks of 16), 32 x 32 pixels x 4 samples,
2 bounces, RR from 2, one 1024-pixel tile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.diff import camera as jax_camera
from ascendpathtracing_tpu.diff import camera_fused as jax_dcf
from ascendpathtracing_tpu.models import mesh as jax_mesh
from ascendpathtracing_tpu.ops import pallas_mesh_pt as jax_mpt
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.camera import Camera
from ascendpathtracing_tpu_torch.diff import camera as dcam
from ascendpathtracing_tpu_torch.diff import camera_fused as dcf
from ascendpathtracing_tpu_torch.diff.camera import CameraParams
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

W = H = 32
SPP4 = 4
TILE = W * H
BOUNCES, RR = 2, 2


def _ms(module, mesh_module):
    v, f = mesh_module.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=2)
    return module.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2),
                                              base_scene="smallpt9")


@pytest.fixture(scope="module")
def tables():
    """JAX's mesh_pt_tables and the same tables as the port's tensors."""
    jt = jax_mpt.mesh_pt_tables(_ms(jax_mesh, jax_meshes), tris_per_chunk=16)
    planes, cb, sb, t24, mats, grid = jt
    p, c, s, ss, t = convert.mesh_tables_from_numpy(np.asarray(planes, np.float64), cb, sb,
                                                    None, t24)
    kw = dict(materials=torch.tensor(mats, dtype=torch.int32), width=W, height=H, spp4=SPP4,
              tris_per_chunk=grid.tris_per_chunk, supers_per=grid.supers_per,
              bounces=BOUNCES, rr_depth=RR,
              uniforms=torch.zeros((SPP4, ptk.n_uniforms(BOUNCES), W * H)))
    return jt, (p, c, s, t, ss), kw


def _pallas(jt, bounces):
    planes, cb, sb, t24, mats, grid = jt
    return jax_mpt.render_pt_mesh_pallas(
        planes, cb, sb, t24, width=W, height=H, spp4=SPP4, materials=mats, bounces=bounces,
        rr_depth=RR, tile=TILE, interpret=True, with_residuals=True, with_camera=True,
        with_stats=True, **jax_mpt.pt_tables_kwargs(grid))


@pytest.fixture(scope="module")
def pallas(tables):
    """The Pallas kernel in interpret mode with every output, at 2 bounces
    -> (image, wid, resv, suv, kstats)."""
    return _pallas(tables[0], BOUNCES)


def _twin(tables, bounces=BOUNCES, **kw):
    _, port, base = tables
    args = {**base, "bounces": bounces, **kw}
    args["uniforms"] = torch.zeros((SPP4, ptk.n_uniforms(bounces), W * H))
    return mpt.render_pt_mesh(*port, **args)


def test_cam_vector_matches_camera_basis():
    """At the default parameters cam_vector is Camera.basis and the push."""
    vec = dcf.cam_vector(CameraParams(dtype=torch.float64), W, H, dtype=torch.float64)
    pos, d0, cx, cy = Camera().basis(W, H)
    np.testing.assert_allclose(vec.numpy(), np.concatenate([pos, d0, [cx[0]], cy, [140.0]]),
                               rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cam_vector_matches_jax(dtype):
    kw = dict(pos=(47.0, 55.0, 280.0), raw_dir=(0.03, -0.06, -1.0), fov=0.5)
    got = dcf.cam_vector(CameraParams(**kw), W, 24, dtype=dtype)
    ref = jax_dcf.cam_vector(jax_camera.CameraParams(**kw), W, 24,
                             dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-12 if dtype == torch.float64 else 1e-6)


def test_traced_cam_default_bitwise_and_shifted_cam_differs(tables):
    """cam=None and the default camera vector (built in float64, then
    float32) give the same image bit for bit; a camera moved 5 units in x
    gives another."""
    base = _twin(tables)
    vec = dcf.cam_vector(CameraParams(dtype=torch.float64), W, H,
                         dtype=torch.float64).to(torch.float32)
    assert torch.equal(_twin(tables, cam=vec), base)
    moved = vec.clone()
    moved[0] += 5.0
    assert float((_twin(tables, cam=moved) - base).abs().max()) > 1e-3


def test_suv_and_wid0_match_pallas(tables, pallas):
    """The screen coordinates equal the Pallas interpreter's bit for bit
    at u = 0 (the jitter is exactly -1); the bounce-0 winners agree on >=
    99.9% of samples (all, as measured); the image, wid and resv do not
    change with with_camera."""
    _, jwid, jresv, jsuv, _ = pallas
    img, wid, resv, suv = _twin(tables, with_residuals=True, with_camera=True)
    assert suv.shape == (2, SPP4, W * H) and suv.dtype == torch.float32
    assert torch.equal(suv, convert.suv_from_jax(jsuv, spp4=SPP4, tile=TILE))
    pwid, _ = convert.residuals_from_jax(jwid, jresv, spp4=SPP4, tile=TILE)
    assert float((wid[0] == pwid[0]).float().mean()) >= 0.999
    plain = _twin(tables, with_residuals=True)
    assert all(torch.equal(a, b) for a, b in zip((img, wid, resv), plain))
    with pytest.raises(ValueError):
        convert.suv_from_jax(np.zeros((2, 3, 8, 128), np.float32), spp4=SPP4, tile=TILE)


def test_kstats_match_pallas(tables, pallas):
    """with_stats: per (tile, layer) cell and bounce, the chunks, supers
    and super-supers some live path enters.  1 bounce: equal to the
    Pallas interpreter's.  2 bounces: the bounce-0 rows equal, the rest
    on >= 99% of entries (XLA's CPU arithmetic and IEEE float32 may part
    a path after the first bounce)."""
    one = _twin(tables, bounces=1, with_stats=True, stats_tile=TILE)
    _, ks1 = one
    jks1 = np.asarray(_pallas(tables[0], 1)[4])
    assert ks1.shape == (3, SPP4) and ks1.dtype == torch.int32
    np.testing.assert_array_equal(ks1.numpy(), jks1)
    assert int(ks1[0].min()) > 0
    ks2 = _twin(tables, with_stats=True, stats_tile=TILE)[1].numpy()
    jks2 = np.asarray(pallas[4])
    assert ks2.shape == jks2.shape == (3 * BOUNCES, SPP4)
    np.testing.assert_array_equal(ks2[0::BOUNCES], jks2[0::BOUNCES])
    assert (ks2 == jks2).mean() >= 0.99


# The ragged grid: icosphere s2 (320 faces) of radius 14 around (3, 3, 3)
# in chunks of 8, 6 a super: 40 chunks, so the last of 7 supers holds 4
# and two pad chunks.  A pad's box is build_chunk_grid's inverted [1, 1,
# 1]-[-1, -1, -1], which the slab test's min/max swap makes [-1, 1]^3:
# inside the sphere's hollow, outside the last super's box.  One emitting
# sphere of radius 1000 around it all, and a camera 40 units from the
# origin on the default direction, looking at it.
RAGGED_PADS = 2
#: Pad chunks the Pallas kernel lists and the port does not, summed over
#: the cells: the allowance of the test below (reference faults 5 and 6).
RAGGED_PAD_EXTRA = 8


def _ragged_case():
    v, f = jax_meshes.icosphere(center=(3.0, 3.0, 3.0), radius=14.0, subdivisions=2)
    ms = jax_mesh.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))
    _, cb, sb, t24, _, grid = jax_mpt.mesh_pt_tables(ms, tris_per_chunk=8, supers_per=6)
    planes = np.array([[1e6], [0.0], [0.0], [0.0], [1.0], [1.0], [1.0], [0.5], [0.5], [0.5]],
                      np.float32)
    cam = np.array(ptk.camera_constants(W, H), np.float32)
    cam[0:3] = -40.0 * cam[3:6]
    cam[10] = 0.0
    return planes, cb, sb, t24, grid, cam


def test_kstats_on_a_ragged_grid_with_pads_outside_their_super(monkeypatch):
    """with_stats on a grid whose pad chunks lie outside their super, at 1
    bounce: the supers equal the Pallas interpreter's, and the chunks too,
    except the pad chunks the Pallas kernel lists and the port does not.
    The Pallas kernel tests a hit super's chunks against every lane of the
    cell, so it lists a pad chunk when one lane enters the super and
    another passes [-1, 1]^3; the port lists a chunk a ray enters through
    its super, as the twin's walk.  A model of both listings on the twin's
    own rays gives the difference, cell by cell: the two pad chunks in
    each of the 4 cells, RAGGED_PAD_EXTRA in all, and nothing else."""
    planes, cb, sb, t24, grid, cam = _ragged_case()
    n_real = int((grid.cboxes[:, 0] <= grid.cboxes[:, 3]).sum())
    assert n_real % grid.supers_per and grid.cboxes.shape[0] - n_real == RAGGED_PADS
    _, jks = jax_mpt.render_pt_mesh_pallas(
        planes, cb, sb, t24, width=W, height=H, spp4=SPP4, materials=(0,), bounces=1,
        rr_depth=RR, tile=TILE, interpret=True, with_stats=True, cam=jnp.asarray(cam),
        **jax_mpt.pt_tables_kwargs(grid))
    jks = np.asarray(jks)

    pg_cb, pg_sb = grid.cboxes.tolist(), grid.sboxes.tolist()
    per = grid.supers_per
    listed = {"pallas": [], "port": []}  # chunks per cell (layer), in call order
    walk = mpt.walk_plain

    def model(g, o3, d3, tmin, *, gate, marks, **kw):
        inv = [1.0 / torch.where(d == 0, 1e-30, d) for d in d3]
        ray = (*o3, *inv)
        enter = mpt._slab_all(pg_cb, ray, gate)  # [M, C]
        sup = mpt._slab_all(pg_sb, ray, gate).repeat_interleave(per, dim=1)
        assert len(marks) == 1 and bool((marks[0][0] == 0).all())  # one cell per layer
        listed["pallas"].append(int((sup.any(0) & enter.any(0)).sum()))
        listed["port"].append(int((sup & enter).any(0).sum()))
        return walk(g, o3, d3, tmin, gate=gate, marks=marks, **kw)

    monkeypatch.setattr(mpt, "walk_plain", model)
    p, c, s, ss, t = convert.mesh_tables_from_numpy(planes, cb, sb, None, t24)
    _, ks = mpt.render_pt_mesh(
        p, c, s, t, ss, materials=torch.tensor([0], dtype=torch.int32), width=W, height=H,
        spp4=SPP4, tris_per_chunk=grid.tris_per_chunk, supers_per=per, bounces=1,
        rr_depth=RR, uniforms=torch.zeros((SPP4, ptk.n_uniforms(1), W * H)),
        cam=torch.tensor(cam), with_stats=True, stats_tile=TILE)
    ks = ks.numpy()
    assert len(listed["port"]) == SPP4
    np.testing.assert_array_equal(ks[1:], jks[1:])  # supers (and no super-supers)
    np.testing.assert_array_equal(ks[0], listed["port"])
    np.testing.assert_array_equal(jks[0], listed["pallas"])
    extra = jks[0] - ks[0]
    assert int(extra.min()) >= 0 and int(extra.max()) <= RAGGED_PADS
    assert int(extra.sum()) == RAGGED_PAD_EXTRA


def test_kstats_per_pixel_cells_sum_to_the_walk_counts(tables):
    """A one-pixel cell holds one path, so its union is that path's own
    walk: summed over the cells, the chunk rows equal the twin's walk
    counts.  Unions over larger tiles lie between the largest path's
    count and the chunk count."""
    walk = torch.zeros((BOUNCES, 5), dtype=torch.int64)
    _, port, base = tables
    _, ks = mpt.render_pt_mesh_plain(*port, with_stats=True, stats_tile=1, walk_counts=walk,
                                     **base)
    assert torch.equal(ks[0:BOUNCES].sum(dim=1, dtype=torch.int64), walk[:, 1])
    _, ks64 = _twin(tables, with_stats=True, stats_tile=64)
    per_pixel_max = ks[0:BOUNCES].reshape(BOUNCES, -1, SPP4).amax(dim=1)  # [B, SPP4]
    assert bool((ks64[0:BOUNCES].reshape(BOUNCES, -1, SPP4).amax(dim=1) >= per_pixel_max).all())
    assert int(ks64.max()) <= port[1].shape[0]
    with pytest.raises(ValueError):
        _twin(tables, with_stats=True, stats_tile=100)


def test_with_camera_requires_residuals(tables):
    with pytest.raises(ValueError, match="with_residuals"):
        _twin(tables, with_camera=True)


def _jax_to_cells(x):
    """[spp4, W*H] (one tile) -> the Pallas layout [cells, 8, tile // 8]."""
    return np.asarray(x).reshape(SPP4, 8, TILE // 8)


def test_primary_depth_and_grads_match_jax(tables, pallas):
    """On the same winners and screen coordinates (the Pallas
    interpreter's, carried over): primary_depth equals JAX's to 1e-12 in
    float64, and its gradients in the camera, the slot geometry and the
    sphere planes equal jax.grad's to 1e-9 (the port's table gathers go
    through the segment-sum's backward)."""
    jt, port, _ = tables
    _, jwid, jresv, jsuv, _ = pallas
    planes64 = np.asarray(jt[0], np.float64)
    geom64 = np.asarray(jt[3], np.float64)[:, :16]
    pwid, _ = convert.residuals_from_jax(jwid, jresv, spp4=SPP4, tile=TILE)
    psuv = convert.suv_from_jax(jsuv, spp4=SPP4, tile=TILE)
    wgt = np.random.RandomState(0).rand(SPP4, W * H)
    kw = dict(n_spheres=planes64.shape[1], width=W, height=H)

    def loss_j(p, g16, sp):
        d = jax_dcf.primary_depth(p, jwid[0], jsuv, g16, sp, **kw)
        return jnp.sum(d * _jax_to_cells(wgt)), d

    jp = jax_camera.CameraParams(dtype=jnp.float64)  # the camera the winners came from
    (_, jd), jg = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        jp, jnp.asarray(geom64), jnp.asarray(planes64))
    tp = {k: v.requires_grad_(True) for k, v in
          CameraParams(dtype=torch.float64).items()}
    g16 = torch.tensor(geom64, requires_grad=True)
    sp = torch.tensor(planes64, requires_grad=True)
    d = dcf.primary_depth(tp, pwid[0], psuv, g16, sp, **kw)
    # XLA's CPU arithmetic contracts and fuses where the port rounds op by
    # op; the 1e5-radius wall spheres' quadratic cancels (b^2 - c, both
    # ~1e10) and lifts that last bit to ~1.5e-12 relative on a few samples.
    code = pwid[0].long()
    wall = (code >= 0) & (code < planes64.shape[1])
    wall &= torch.tensor(planes64[0])[code.clamp(0, planes64.shape[1] - 1)] >= 1e6
    got, ref = d.detach().numpy(), np.asarray(jd).reshape(SPP4, W * H)
    np.testing.assert_allclose(got[~wall.numpy()], ref[~wall.numpy()], rtol=1e-12)
    np.testing.assert_allclose(got[wall.numpy()], ref[wall.numpy()], rtol=1e-11)
    grads = torch.autograd.grad((d * torch.tensor(wgt)).sum(), [*tp.values(), g16, sp])
    for name, got in zip(("pos", "raw_dir", "fov"), grads[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg[0][name]), rtol=1e-9,
                                   err_msg=name)
    for got, ref in zip(grads[3:], jg[1:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(ref).max()))
        assert float(np.abs(ref).max()) > 0


def test_primary_depth_matches_oracle_first_hit(tables):
    """The depth replay (the twin's frozen winners, the primary ray rebuilt
    from suv) against a float64 brute-force first hit over the same rays:
    the winners agree on > 97% of samples and the depths meet
    tests/test_camera_fused.py's gates."""
    jt, port, base = tables
    grid = jt[5]
    _, depth, (wid, _, suv) = dcf.render_with_camera(CameraParams(), *port[:4], port[4],
                                                    **base)
    depth = depth.reshape(-1).numpy()
    ms = _ms(mm, meshes)
    mdev = mm.mesh_scene_to_device(ms, dtype=torch.float64, use_bvh=False)
    cam = dcf.cam_vector(CameraParams(dtype=torch.float64), W, H, dtype=torch.float64).numpy()
    su = suv[0].double().reshape(-1).numpy()
    sv = suv[1].double().reshape(-1).numpy()
    dd = np.stack([su * cam[6] + sv * cam[7] + cam[3], sv * cam[8] + cam[4],
                   sv * cam[9] + cam[5]], 1)
    o = cam[0:3][None] + dd * cam[10]
    d = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    tmin, kind, hid = (x.numpy() for x in mm.first_hit_mesh(
        torch.tensor(np.concatenate([o, d], 1)), mdev))

    code = wid[0].reshape(-1).numpy().astype(np.int64)
    n_s = planes_n = port[0].shape[1]
    is_tri = code >= n_s
    slot = np.where(is_tri, code - n_s, 0)
    face = grid.face_of_slot[slot]
    agree = np.where(code < 0, kind == 0,
                     np.where(is_tri, (kind == 2) & (face == hid), (kind == 1) & (code == hid)))
    assert agree.mean() > 0.97, f"winner agreement only {agree.mean():.3f}"
    hit = (kind > 0) & agree
    assert hit.mean() > 0.9
    rows = port[3].double().numpy()
    cosi = np.abs(np.einsum("ij,ij->i", rows[slot, 13:16], d))
    steep = hit & is_tri & (cosi > 0.1)
    assert steep.sum() > 100
    np.testing.assert_allclose(depth[steep], tmin[steep], rtol=2e-3)
    r2w = port[0][0].numpy()[np.clip(code, 0, planes_n - 1)]
    sph_small = hit & ~is_tri & (r2w < 1e6)
    sph_wall = hit & ~is_tri & (r2w >= 1e6)
    assert sph_small.sum() > 100 and sph_wall.sum() > 100
    np.testing.assert_allclose(depth[sph_small], tmin[sph_small], rtol=2e-3)
    np.testing.assert_allclose(depth[sph_wall], tmin[sph_wall], atol=0.25, rtol=2e-3)
    np.testing.assert_allclose(depth[hit], tmin[hit], rtol=5e-2, atol=0.25)
    assert (depth[code < 0] == 0).all()


def test_camera_gradients_match_fd(tables):
    """With the twin's decisions frozen the depth loss is smooth in the
    camera: float64 AD equals central differences (h = 1e-6) to 1e-4 on
    all 7 coordinates."""
    _, port, base = tables
    _, _, (wid, _, suv) = dcf.render_with_camera(CameraParams(), *port[:4], port[4], **base)
    t64 = port[3].double()[:, :16]
    planes64 = port[0].double()

    def loss(p):
        dep = dcf.primary_depth(p, wid[0], suv, t64, planes64, n_spheres=planes64.shape[1],
                                width=W, height=H)
        return (dep * dep).mean() * 1e-4

    params = {k: v.requires_grad_(True) for k, v in CameraParams(dtype=torch.float64).items()}
    grads = dict(zip(params, torch.autograd.grad(loss(params), list(params.values()))))
    h, checked = 1e-6, 0
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        flat = g.reshape(-1)
        for ci in range(flat.numel()):
            step = torch.zeros_like(params[name]).reshape(-1)
            step[ci] = h
            step = step.reshape(params[name].shape)
            with torch.no_grad():
                lp = float(loss({**params, name: params[name] + step}))
                lm = float(loss({**params, name: params[name] - step}))
            np.testing.assert_allclose(float(flat[ci]), (lp - lm) / (2 * h), rtol=1e-4,
                                       atol=1e-10, err_msg=f"{name}[{ci}]")
            checked += 1
    assert checked == 7
    assert max(float(g.abs().max()) for g in grads.values()) > 0


def test_camera_fd_gate_residual_is_the_difference_quotients(tables, monkeypatch):
    """Where the FD gate's last digits come from, per sample: forward-mode
    AD against the central difference of each sample's loss.  raw_dir[0]:
    one sample on a small sphere holds the error, which grows as h^2 (the
    difference's truncation across sqrt(det)'s curvature where the ray
    grazes).  pos[2]: the wall spheres (r2 = 1e10) hold it, and it shrinks
    as h grows (rounding: c = |oc|^2 - r2 cancels two terms near 1e10).
    Neither is an error of the gradient."""
    _, port, base = tables
    _, _, (wid, _, suv) = dcf.render_with_camera(CameraParams(), *port[:4], port[4], **base)
    # forward-mode AD needs a jvp, which sqrt_rn (a custom Function) lacks;
    # its rounding does not matter here
    monkeypatch.setattr(dcf, "sqrt_rn", torch.sqrt)
    monkeypatch.setattr(dcam, "sqrt_rn", torch.sqrt)
    t64, planes64 = port[3].double()[:, :16], port[0].double()
    n_s = planes64.shape[1]
    code = wid[0].reshape(-1).long()
    params = CameraParams(dtype=torch.float64)

    def per_sample(p):
        dep = dcf.primary_depth(p, wid[0], suv, t64, planes64, n_spheres=n_s, width=W, height=H)
        return (dep * dep).reshape(-1) * (1e-4 / dep.numel())

    def fd_minus_ad(name, ci, h):
        e = torch.zeros_like(params[name]).reshape(-1)
        e[ci] = 1.0
        e = e.reshape(params[name].shape)
        with fwAD.dual_level():
            jvp = fwAD.unpack_dual(per_sample({**params, name: fwAD.make_dual(params[name], e)}))
        with torch.no_grad():
            fd = (per_sample({**params, name: params[name] + h * e})
                  - per_sample({**params, name: params[name] - h * e})) / (2 * h)
        return fd - jvp.tangent

    err6, err5 = fd_minus_ad("raw_dir", 0, 1e-6), fd_minus_ad("raw_dir", 0, 1e-5)
    top = int(err6.abs().argmax())
    assert 0 <= int(code[top]) < n_s and float(planes64[0, code[top]]) < 1e6
    assert float(err6[top]) / float(err6.sum()) > 0.9
    assert 30.0 < float(err5.sum()) / float(err6.sum()) < 300.0
    wall = (code >= 0) & (code < n_s) & (planes64[0][code.clamp(0, n_s - 1)] >= 1e6)
    err6, err5 = fd_minus_ad("pos", 2, 1e-6), fd_minus_ad("pos", 2, 1e-5)
    assert float(err6[wall].sum()) / float(err6.sum()) > 0.99
    assert abs(float(err5.sum())) < abs(float(err6.sum())) / 10.0


def test_primary_depth_grazing_sphere_gradient_is_finite():
    """A primary ray tangent to a sphere (det exactly 0): the depth is the
    tangent point's distance and the gradient is finite (the square
    root's infinite derivative there would make it NaN)."""
    params = {k: v.requires_grad_(True) for k, v in CameraParams(
        pos=(0.0, 0.0, 0.0), raw_dir=(0.0, 0.0, 1.0), dtype=torch.float64).items()}
    planes = torch.zeros((10, 1), dtype=torch.float64)
    planes[0, 0], planes[1, 0], planes[3, 0] = 9.0, 3.0, 200.0  # r = 3, tangent to the z axis
    d = dcf.primary_depth(params, torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros((2, 1, 1), dtype=torch.float64),
                          torch.zeros((1, 16)), planes, n_spheres=1, width=1, height=1)
    assert float(d.detach()) == 60.0  # origin pushed to z = 140, tangent point at z = 200
    grads = torch.autograd.grad(d.sum(), list(params.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)

