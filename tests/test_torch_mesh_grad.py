"""The fused mesh renderer's training step in the port on the CPU: the
replay residuals of ``ops.mesh_pt_kernels.render_pt_mesh(with_residuals=
True)`` against the Pallas kernel's in interpret mode (its u = 0 stream),
the port's ``diff.mesh_fused.replay_backward`` on JAX's own residuals
against JAX's replay, the autograd function against ``jax.grad`` of
``make_render_pt_mesh_pallas_diff`` and against float64 central
differences of the port's own forward, the "scene" grads mode, inverse
rendering of the slot albedo, and ``slot_grads_to_face``.  The scene is
tests/test_mesh_fused_grad.py's: the mixed icosphere s2 (mirror, glass
and emissive faces) in smallpt9, 32 x 32, spp4 4, chunks of 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu.diff import mesh_fused as jax_mf
from ascendpathtracing_tpu.ops import pallas_mesh_pt as jax_mpt
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.diff import mesh_fused as mf
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from tests.test_pallas_mesh_pt import _scene as jax_mixed_scene
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

W = H = 32
SPP4 = 4
TILE = 1024


@pytest.fixture(scope="module")
def jax_tables():
    return jax_mpt.mesh_pt_tables(jax_mixed_scene(), tris_per_chunk=8, supers_per=0)


def _jax_residuals(tables, bounces, rr_depth):
    """The Pallas kernel with residuals in interpret mode -> (image, raw
    wid, raw resv, the port's wid, the port's resv)."""
    planes, cb, sb, t24, mats, grid = tables
    img, wid, resv = jax_mpt.render_pt_mesh_pallas(
        planes.astype(jnp.float32), cb, sb, t24, width=W, height=H, spp4=SPP4,
        materials=mats, bounces=bounces, rr_depth=rr_depth, tile=TILE, interpret=True,
        with_residuals=True, **jax_mpt.pt_tables_kwargs(grid))
    return (np.asarray(img), wid, resv,
            *convert.residuals_from_jax(wid, resv, spp4=SPP4, tile=TILE))


@pytest.fixture(scope="module")
def jax_shallow(jax_tables):
    return _jax_residuals(jax_tables, 1, 1)


@pytest.fixture(scope="module")
def jax_deep(jax_tables):
    """3 bounces, RR from 2: with u = 0 every path survives RR, so s at
    bounce 2 carries 1/pmax."""
    return _jax_residuals(jax_tables, 3, 2)


def _port_tables(tables, dtype=torch.float32):
    planes, cb, sb, t24, mats, grid = tables
    p, c, s, ss, t = convert.mesh_tables_from_numpy(np.asarray(planes, np.float64), cb, sb,
                                                    None, t24, dtype=dtype)
    return p, c, s, ss, t, torch.tensor(mats, dtype=torch.int32), grid


def _zeros(bounces, dtype=torch.float32):
    return torch.zeros((SPP4, ptk.n_uniforms(bounces), W * H), dtype=dtype)


def _port_residuals(tables, bounces, rr_depth):
    p, c, s, ss, t, mats, grid = _port_tables(tables)
    return mpt.render_pt_mesh(p, c, s, t, ss, materials=mats, width=W, height=H, spp4=SPP4,
                              tris_per_chunk=grid.tris_per_chunk, bounces=bounces,
                              rr_depth=rr_depth, uniforms=_zeros(bounces),
                              with_residuals=True)


# ------------------------------------------------------ (a) residuals ----
def _glass(tables, wid):
    """Bounces whose winner is glass: smallpt9's glass sphere or a
    triangle whose refraction one-hot (row float 23) is set."""
    mats = torch.tensor(tables[4])
    s_count = len(mats)
    refr = torch.tensor(np.asarray(tables[3])[:, 23] > 0.5)
    sphere = (wid >= 0) & (wid < s_count) & (mats[wid.clamp(0, s_count - 1).long()] == 2)
    tri = (wid >= s_count) & refr[(wid - s_count).clamp(0, len(refr) - 1).long()]
    return sphere | tri


def _resv_close(resv, jresv, tol):
    """[bounces, spp4, P]: every value of the bounce within ``tol``
    relative (and 1e-6 absolute)."""
    d = (resv - jresv).abs() <= tol * jresv.abs() + 1e-6
    return d.all(dim=1)


def test_residuals_match_pallas_one_bounce(jax_tables, jax_shallow):
    """1 bounce: the winner codes equal on >= 99.9% of samples (all, as
    measured); where they agree, albedo and emission are equal to 1e-6 and
    s is 1 except on glass.  Glass s = Schlick's rscale, a fifth power of
    directions that XLA's CPU arithmetic (interpret mode) and IEEE float32
    round apart: within 1e-4 relative (4.5e-5 measured)."""
    _, _, _, jwid, jresv = jax_shallow
    img, wid, resv = _port_residuals(jax_tables, 1, 1)
    assert wid.shape == (1, SPP4, W * H) and resv.shape == (1, 7, SPP4, W * H)
    same = wid == jwid
    assert float(same.float().mean()) >= 0.999
    live = same & (wid >= 0)
    assert int(live.sum()) > 0.9 * wid.numel()
    assert float((resv - jresv).abs().permute(1, 0, 2, 3)[:6, live].max()) <= 1e-6
    glass = _glass(jax_tables, wid) & live
    assert bool(glass.any()) and bool((resv[:, 6][live & ~glass] == 1.0).all())
    assert bool(_resv_close(resv, jresv, 1e-4)[live].all())
    np.testing.assert_allclose(img.numpy(), jax_shallow[0], rtol=0, atol=1e-6)


def test_residuals_match_pallas_deep_with_rr(jax_tables, jax_deep):
    """3 bounces, RR from 2.  Interpret mode computes with XLA's CPU
    arithmetic and the twin in IEEE float32, so a trail can part at a
    near-tie: >= 99% of samples agree in each bounce's code (99.8% as
    measured).  Where a sample's whole trail agrees, albedo and emission
    are equal to 1e-6; s (glass rscale x 1/pmax) goes through Schlick's
    fifth power of rounded directions: within 1e-6 relative on >= 96% of
    those bounces (96.9% measured), 1e-4 on >= 99% (99.6%), 5% on all
    (2.0%)."""
    _, _, _, jwid, jresv = jax_deep
    _, wid, resv = _port_residuals(jax_tables, 3, 2)
    for k in range(3):
        assert float((wid[k] == jwid[k]).float().mean()) >= 0.99, k
    trail = (wid == jwid).all(dim=0)  # [spp4, P]
    live = trail[None] & (wid >= 0)
    diff = (resv - jresv).abs().permute(1, 0, 2, 3)[:, live]  # [7, n]
    assert float(diff[:6].max()) <= 1e-6
    rel = diff[6] / jresv[:, 6][live].abs()
    assert float((rel <= 1e-6).float().mean()) >= 0.96
    assert float((rel <= 1e-4).float().mean()) >= 0.99 and float(rel.max()) <= 0.05
    # RR from bounce 2 survives with u = 0: s = scl / pmax, and 1 / pmax > 1;
    # before it s is 1 on all but glass.
    plain = live & ~_glass(jax_tables, wid)
    assert bool(plain[2].any()) and bool((resv[2, 6][plain[2]] > 1.0).all())
    assert bool((resv[:2, 6][plain[:2]] == 1.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_image_with_residuals_is_bitwise_the_image_without(jax_tables, dtype):
    """(b) with_residuals must not change the image by one ulp; dead
    bounces hold -1 and zeros (Philox stream, RR from 2 of 5 bounces)."""
    p, c, s, ss, t, mats, grid = _port_tables(jax_tables, dtype)
    kw = dict(materials=mats, width=16, height=12, spp4=8, tris_per_chunk=grid.tris_per_chunk,
              bounces=5, rr_depth=2, seed=4)
    img, wid, resv = mpt.render_pt_mesh(p, c, s, t, ss, with_residuals=True, **kw)
    assert torch.equal(img, mpt.render_pt_mesh(p, c, s, t, ss, **kw))
    assert resv.dtype == dtype and wid.dtype == torch.int32
    dead = wid < 0
    assert bool(dead.any()) and float(resv.permute(1, 0, 2, 3)[:, dead].abs().max()) == 0.0
    # A path stays dead: no live bounce after a dead one.
    assert not bool((dead[:-1] & ~dead[1:]).any())
    assert int(wid.max()) < 9 + t.shape[0]


# --------------------------------------------------------- (c) replay ----
def test_replay_matches_jax_replay_on_jax_residuals(jax_tables, jax_deep):
    """The port's replay on JAX's own residuals (3 bounces, RR from 2) vs
    JAX's replay (its CPU scatter path): f32 sums taken in another order,
    so rtol 1e-5 with atol 1e-6 x max |grad|."""
    _, jwid_raw, jresv_raw, jwid, jresv = jax_deep
    n_slots = jax_tables[3].shape[0]
    g = np.random.RandomState(2).rand(3, W * H).astype(np.float32)
    exp = jax_mf.replay_backward(jwid_raw, jresv_raw, jnp.asarray(g), n_spheres=9,
                                 n_slots=n_slots, spp4=SPP4, tile=TILE, slot_mode="scatter")
    got = mf.replay_backward(jwid, jresv, torch.tensor(g), n_spheres=9, n_slots=n_slots,
                             spp4=SPP4, layer_chunk=3)
    for a, b in zip(got, exp):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
    assert float(got[0][0:4].abs().max()) == 0.0


# ------------------------------------------------------ (d) jax.grad ----
def _split(t24):
    return t24[:, :16], t24[:, 16:19], t24[:, 19:22], t24[:, 22:24]


def test_gradients_match_jax_grad(jax_tables, jax_deep):
    """End to end at 3 bounces, RR from 2, zero uniforms: the port's f32
    gradients vs jax.grad of make_render_pt_mesh_pallas_diff(interpret=
    True).  The cotangent is zeroed on every pixel where any sample's
    winner trail, or a residual beyond 1e-6 relative (glass s, see
    above), differs between the two, so both replay the same chains:
    rtol 1e-5 (f32 sums in another order)."""
    planes, cb, sb, t24, mats, grid = jax_tables
    _, wid_p, resv_p = _port_residuals(jax_tables, 3, 2)
    agree = ((wid_p == jax_deep[3]) & _resv_close(resv_p, jax_deep[4], 1e-6)).all(
        dim=0).all(dim=0)  # [P]
    assert float(agree.float().mean()) >= 0.8
    wgt = np.random.RandomState(0).rand(3, W * H).astype(np.float32) * agree.numpy()

    t24j = jnp.asarray(t24)
    geom16, alb0, emi0, mat2 = _split(t24j)
    render_j = jax_mf.make_render_pt_mesh_pallas_diff(
        cb, sb, geom16, mat2, width=W, height=H, spp4=SPP4, materials=mats,
        tris_per_chunk=grid.tris_per_chunk, supers_per=grid.supers_per, bounces=3,
        rr_depth=2, tile=TILE, interpret=True)
    exp = jax.grad(lambda p, a, e: jnp.sum(jnp.asarray(wgt) * render_j(p, a, e)),
                   argnums=(0, 1, 2))(planes.astype(jnp.float32), alb0, emi0)

    p, c, s, ss, t, mt, _ = _port_tables(jax_tables)
    render = mf.make_render_pt_mesh_diff(
        c, s, t[:, :16], t[:, 22:24], width=W, height=H, spp4=SPP4, materials=mt,
        tris_per_chunk=grid.tris_per_chunk, bounces=3, rr_depth=2, uniforms=_zeros(3))
    leaves = (p.requires_grad_(True), t[:, 16:19].clone().requires_grad_(True),
              t[:, 19:22].clone().requires_grad_(True))
    got = torch.autograd.grad((torch.tensor(wgt) * render(*leaves)).sum(), leaves)
    for a, b in zip(got, exp):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
    assert float(got[0][0:4].abs().max()) == 0.0
    assert float(got[0][4:10].abs().max()) > 0 and float(got[1].abs().max()) > 0


# ----------------------------------------- the port's own forward, f64 ----
@pytest.fixture(scope="module")
def f64_setup(jax_tables):
    """The f64 twin with Philox (seed 3), bounces = rr_depth = 3, a fixed
    weight; the loss and its gradients at the tables' leaves."""
    p, c, s, ss, t, mats, grid = _port_tables(jax_tables, torch.float64)
    wgt = torch.tensor(np.random.RandomState(1).rand(3, W * H))

    def make(**kw):
        return mf.make_render_pt_mesh_diff(
            c, s, t[:, :16], t[:, 22:24], width=W, height=H, spp4=SPP4, materials=mats,
            tris_per_chunk=grid.tris_per_chunk, bounces=3, rr_depth=3, seed=3, **kw)

    render = make()
    alb0 = t[:, 16:19].double()
    emi0 = t[:, 19:22].double()

    def loss(pl, a, e, fn=render):
        return (wgt * fn(pl, a, e)).sum()

    leaves = (p.clone().requires_grad_(True), alb0.clone().requires_grad_(True),
              emi0.clone().requires_grad_(True))
    grads = torch.autograd.grad(loss(*leaves), leaves)
    return dict(make=make, loss=loss, leaves=(p, alb0, emi0), grads=grads, grid=grid)


def _fd(loss, leaves, which, idx, h):
    """Central difference in leaf ``which`` at ``idx``; slot leaves ride
    in the float32 row table, so the step is the realized float32 one."""
    plus = [x.clone() for x in leaves]
    minus = [x.clone() for x in leaves]
    plus[which][idx] += h
    minus[which][idx] -= h
    if which > 0:
        plus[which] = plus[which].float().double()
        minus[which] = minus[which].float().double()
    step = float(plus[which][idx] - minus[which][idx])
    with torch.no_grad():
        return float(loss(*plus) - loss(*minus)) / step


def test_gradients_match_f64_central_differences(f64_setup):
    """(e) At fixed Philox draws with bounces = rr_depth the estimator is
    a polynomial of degree <= 3 in each leaf, so central differences with
    h = 1e-4 are exact to ~1e-9 relative: the gradients of the strongest
    plane coordinate (rows 4-9), slot albedo and slot emission agree to
    1e-6 x max(|fd|, 1e-2)."""
    loss, leaves, grads = f64_setup["loss"], f64_setup["leaves"], f64_setup["grads"]
    assert float(grads[0][0:4].abs().max()) == 0.0
    for which, g in enumerate(grads):
        sel = g.abs().clone()
        if which == 0:
            sel[0:4] = 0
        idx = np.unravel_index(int(sel.argmax()), tuple(sel.shape))
        fd = _fd(loss, leaves, which, idx, 1e-4)
        assert abs(float(g[idx]) - fd) <= 1e-6 * max(abs(fd), 1e-2), (which, idx, float(g[idx]), fd)


def test_scene_grads_mode(f64_setup):
    """(f) grads="scene": the same plane gradients, zero slot gradients."""
    render_s = f64_setup["make"](grads="scene")
    leaves = tuple(x.clone().requires_grad_(True) for x in f64_setup["leaves"])
    gp, ga, ge = torch.autograd.grad(f64_setup["loss"](*leaves, fn=render_s), leaves)
    assert torch.equal(gp, f64_setup["grads"][0])
    assert float(ga.abs().max()) == 0.0 and float(ge.abs().max()) == 0.0
    assert ga.shape == ge.shape == f64_setup["leaves"][1].shape


def test_slot_grads_to_face_roundtrip(f64_setup):
    """(h) Slot rows -> per-face rows as JAX's slot_grads_to_face; pad
    slots carry no gradient."""
    grid, ga = f64_setup["grid"], f64_setup["grads"][1].numpy()
    gf = mf.slot_grads_to_face(grid, ga)
    np.testing.assert_array_equal(gf, jax_mf.slot_grads_to_face(grid, ga))
    fos = np.asarray(grid.face_of_slot)
    liv = fos >= 0
    assert gf.shape == (int(fos.max()) + 1, 3)
    np.testing.assert_array_equal(gf[fos[liv]], ga[liv])
    if (~liv).any():
        assert np.abs(ga[~liv]).max() == 0.0


def test_inverse_rendering_recovers_slot_albedo(jax_tables):
    """(g) Gradient descent on the slot albedos against a target image
    cuts the loss 5x in 10 steps (tests/test_mesh_fused_grad.py:139-166,
    on the port's forward with Philox, seed 0, float32)."""
    p, c, s, ss, t, mats, grid = _port_tables(jax_tables)
    render = mf.make_render_pt_mesh_diff(
        c, s, t[:, :16], t[:, 22:24], width=W, height=H, spp4=SPP4, materials=mats,
        tris_per_chunk=grid.tris_per_chunk, bounces=3, rr_depth=3)
    alb_true, emi0 = t[:, 16:19], t[:, 19:22]
    with torch.no_grad():
        target = render(p, alb_true, emi0)

    def loss_fn(alb):
        return ((render(p, alb, emi0) - target) ** 2).mean()

    alb = (alb_true * 0.4 + 0.2).clamp(0.0, 1.0).requires_grad_(True)
    l0 = float(loss_fn(alb.detach()))
    assert l0 > 0
    for _ in range(10):
        (g,) = torch.autograd.grad(loss_fn(alb), (alb,))
        alb = (alb - 6.0 * g).clamp(0.0, 1.0).detach().requires_grad_(True)
    l1 = float(loss_fn(alb.detach()))
    assert np.isfinite(l1) and l1 < l0 / 5, (l0, l1)


# ------------------------------ the bounce-loop renderer (diff/mesh) ----
# tests/test_mesh_grad.py's scene: icosphere s1 (r 12) in smallpt9, 24x24
# camera rays.  Face attributes reach the radiance; vertices reach the
# first-hit depth AOV (at fixed uniforms the radiance of this all-diffuse
# scene is piecewise constant in the vertices).
def _xla_setup(traversal, dtype=torch.float64):
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.camera import generate_rays_numpy
    from ascendpathtracing_tpu_torch.diff import mesh as dm
    from ascendpathtracing_tpu_torch.models import mesh as mm

    v, f = meshes.icosphere(center=(50, 40, 60), radius=12.0, subdivisions=1)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.6, 0.5, 0.4))
    kw = dict(pallas_bvh_kernel=True) if traversal == "chunks" else dict(use_bvh=False)
    dev = mm.mesh_scene_to_device(ms, dtype=dtype, **kw)
    rays = torch.tensor(generate_rays_numpy(24, 24, 1, seed=0), dtype=dtype)
    return ms, dev, dm.mesh_params(ms, dtype), torch.tensor(f), rays


def _xla_radiance(params, rays, dev, faces, **kw):
    from ascendpathtracing_tpu_torch.diff import mesh as dm

    return dm.render_pt_mesh_params(rays, params, dev, faces, bounces=4, **kw).mean()


def _xla_depth(params, rays, dev, faces):
    from ascendpathtracing_tpu_torch.diff import mesh as dm

    d = dm.depth_aov_params(rays, params, dev, faces)
    return (d * (d < 1e19).to(d.dtype)).sum()


def _grads(fn, params, names):
    leaves = {k: v.detach().clone().requires_grad_(k in names) for k, v in params.items()}
    return dict(zip(names, torch.autograd.grad(fn(leaves), [leaves[k] for k in names])))


def test_xla_mesh_grads_match_jax_grad():
    """Brute, float64, the same uniforms (4 bounces): the port's gradients
    of the mean radiance to face albedo and emission vs jax.grad of JAX's
    build_traced_dev + render_pt_mesh_impl, rtol 1e-9 (0 and 7e-18
    absolute measured); vertex gradients of the first-hit depth, rtol 1e-9.
    The radiance's vertex gradient is finite and exactly 0 in the port;
    JAX's is NaN in every entry (ROADMAP queue 3)."""
    from ascendpathtracing_tpu.diff import mesh as jax_dm
    from ascendpathtracing_tpu.models import mesh as jax_mm

    ms, dev, params, faces, rays = _xla_setup("brute")
    u = np.random.RandomState(0).rand(4, 3, rays.shape[0])
    jms = jax_mm.MeshScene.cornell_with_mesh(ms.vertices, ms.faces, albedo=(0.6, 0.5, 0.4))
    traced, static = jax_mm._split_static(
        jax_mm.mesh_scene_to_device(jms, dtype=jnp.float64, use_bvh=False))
    jfaces, jrays = jnp.asarray(ms.faces), jnp.asarray(rays.numpy())

    def jloss(p):
        d = jax_dm.build_traced_dev(p, traced, jfaces, static)
        return jnp.mean(jax_mm.render_pt_mesh_impl(
            jax.random.PRNGKey(0), jrays, d, bounces=4, static=static, uniforms=jnp.asarray(u)))

    def jdepth(p):
        d = jax_dm.depth_aov_params_impl(jrays, p, traced, jfaces, static=static)
        return jnp.sum(d * jax.lax.stop_gradient(d < 1e19).astype(d.dtype))

    jp = jax_dm.mesh_params(jms, jnp.float64)
    ref = jax.jit(jax.grad(jloss))(jp)
    ref_v = np.asarray(jax.jit(jax.grad(jdepth))(jp)["vertices"])
    got = _grads(lambda p: _xla_radiance(p, rays, dev, faces, uniforms=torch.tensor(u)),
                 params, ("vertices", "face_albedo", "face_emission"))
    for name in ("face_albedo", "face_emission"):
        b = np.asarray(ref[name])
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max())
    assert bool(torch.isfinite(got["vertices"]).all()) and float(got["vertices"].abs().max()) == 0
    got_v = _grads(lambda p: _xla_depth(p, rays, dev, faces), params, ("vertices",))["vertices"]
    assert np.abs(ref_v).max() > 0
    np.testing.assert_allclose(got_v.numpy(), ref_v, rtol=1e-9, atol=1e-12 * np.abs(ref_v).max())


def _fd_params(loss, params, name, idx, h):
    plus = {k: v.clone() for k, v in params.items()}
    minus = {k: v.clone() for k, v in params.items()}
    plus[name][idx] += h
    minus[name][idx] -= h
    with torch.no_grad():
        return (float(loss(plus)) - float(loss(minus))) / (2 * h)


def test_xla_face_attribute_grads_match_fd_float64():
    """tests/test_mesh_grad.py:50-67 on the port (its Philox stream, seed
    7): the five largest face albedo and emission gradients vs central
    differences, rtol 1e-5."""
    _, dev, params, faces, rays = _xla_setup("brute")

    def loss(p):
        return _xla_radiance(p, rays, dev, faces, seed=7)

    g = _grads(loss, params, ("face_albedo", "face_emission"))
    for name, arr in g.items():
        assert float(arr.abs().max()) > 0, name
        for fi in np.argsort(-arr.abs().numpy().ravel())[:5]:
            idx = divmod(int(fi), 3)
            np.testing.assert_allclose(float(arr[idx]), _fd_params(loss, params, name, idx, 1e-6),
                                       rtol=1e-5, atol=1e-10)


def test_xla_vertex_grads_via_depth_match_fd_float64():
    """tests/test_mesh_grad.py:70-84 on the port: the six largest vertex
    gradients of the first-hit depth vs central differences, rtol 1e-4."""
    _, dev, params, faces, rays = _xla_setup("brute")

    def loss(p):
        return _xla_depth(p, rays, dev, faces)

    g = _grads(loss, params, ("vertices",))["vertices"]
    assert float(g.abs().max()) > 0
    for fi in np.argsort(-g.abs().numpy().ravel())[:6]:
        idx = divmod(int(fi), 3)
        np.testing.assert_allclose(float(g[idx]), _fd_params(loss, params, "vertices", idx, 1e-6),
                                   rtol=1e-4, atol=1e-8)


def test_xla_chunks_grads_match_brute():
    """tests/test_mesh_grad.py:87-105 on the port, float32: the chunk
    kernel's twin with the recompute gives brute force's gradients (same
    decisions, float32 formula noise only)."""
    _, dev_b, params, faces, rays = _xla_setup("brute", torch.float32)
    _, dev_c, _, _, _ = _xla_setup("chunks", torch.float32)
    names = ("face_albedo", "face_emission")
    ga = _grads(lambda p: _xla_radiance(p, rays, dev_c, faces, seed=7), params, names)
    gb = _grads(lambda p: _xla_radiance(p, rays, dev_b, faces, seed=7), params, names)
    for name in names:
        a, b = ga[name].numpy(), gb[name].numpy()
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, atol=5e-3 * np.abs(b).max(), rtol=5e-2)
    da = _grads(lambda p: _xla_depth(p, rays, dev_c, faces), params, ("vertices",))["vertices"]
    db = _grads(lambda p: _xla_depth(p, rays, dev_b, faces), params, ("vertices",))["vertices"]
    np.testing.assert_allclose(da.numpy(), db.numpy(), atol=5e-3 * float(db.abs().max()),
                               rtol=5e-2)


def test_xla_vertex_optimization_loop_with_rebuild_guard():
    """tests/test_mesh_grad.py:108-147 on the port: descend on the vertices
    against a depth target in chunks mode, guard each step with
    assert_tables_fresh, rebuild the device scene when it trips."""
    import dataclasses

    from ascendpathtracing_tpu_torch.diff import mesh as dm
    from ascendpathtracing_tpu_torch.models import mesh as mm

    ms, dev, params, faces, rays = _xla_setup("chunks", torch.float32)
    with torch.no_grad():
        target = dm.depth_aov_params(rays, params, dev, faces) * 0.98

    def loss_fn(p, dev):
        d = dm.depth_aov_params(rays, p, dev, faces)
        m = ((d < 1e19) & (target < 1e19)).to(d.dtype)
        return (((d - target) * m) ** 2).mean()

    l0 = float(loss_fn(params, dev))
    rebuilds = 0
    for _ in range(6):
        g = _grads(lambda p: loss_fn(p, dev), params, ("vertices",))["vertices"]
        params = {**params, "vertices": params["vertices"] - 2e-1 * g}
        try:
            dm.assert_tables_fresh(params, dev, faces, tol=1e-4)
        except dm.StaleKernelTablesError:
            ms2 = dataclasses.replace(ms, vertices=params["vertices"].numpy().astype(np.float64))
            dev = mm.mesh_scene_to_device(ms2, pallas_bvh_kernel=True)
            rebuilds += 1
            assert dm.table_drift(params, dev, faces) < 1e-6
    l1 = float(loss_fn(params, dev))
    assert np.isfinite(l1) and l1 < l0, (l0, l1)
    assert rebuilds >= 1


def test_xla_table_drift():
    """tests/test_mesh_grad.py:150-174: 0 for brute; a vertex that is only
    ever a v2 trips the guard."""
    from ascendpathtracing_tpu_torch.diff import mesh as dm
    from ascendpathtracing_tpu_torch.models import mesh as mm

    _, dev, params, faces, _ = _xla_setup("brute")
    assert dm.table_drift(params, dev, faces) == 0.0
    v = np.array([[0.0, 0.0, 0.0], [30.0, 0.0, 0.0], [30.0, 30.0, 0.0],
                  [0.0, 30.0, 0.0]]) + np.array([35.0, 25.0, 50.0])
    f = np.array([[0, 1, 2], [0, 2, 3]])  # vertex 3 is only ever v2
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.6, 0.5, 0.4))
    dev = mm.mesh_scene_to_device(ms, pallas_bvh_kernel=True)
    params = dm.mesh_params(ms)
    faces = torch.tensor(f)
    assert dm.table_drift(params, dev, faces) < 1e-6
    moved = params["vertices"].clone()
    moved[3] += 5.0
    assert dm.table_drift({**params, "vertices": moved}, dev, faces) > 0.01
    with pytest.raises(dm.StaleKernelTablesError):
        dm.assert_tables_fresh({**params, "vertices": moved}, dev, faces)


def test_traced_dev_refuses_bvh_leaf_order():
    """The JAX build_traced_dev writes face-ordered planes over the BVH's
    leaf-ordered tables (diff/mesh.py:72-75): float64, 24x24 rays, the jnp
    device's untraced first hit equals brute force to 1e-12, but its traced
    depth differs from brute on some rays (50 of 2,304 measured).  The port
    refuses the jnp and lockstep modes with a ValueError."""
    from ascendpathtracing_tpu.diff import mesh as jax_dm
    from ascendpathtracing_tpu.models import mesh as jax_mm
    from ascendpathtracing_tpu_torch.diff import mesh as dm
    from ascendpathtracing_tpu_torch.models import mesh as mm

    ms, _, params, faces, rays = _xla_setup("brute")
    jms = jax_mm.MeshScene.cornell_with_mesh(ms.vertices, ms.faces, albedo=(0.6, 0.5, 0.4))
    jb = jax_mm.mesh_scene_to_device(jms, dtype=jnp.float64, use_bvh=False)
    jj = jax_mm.mesh_scene_to_device(jms, dtype=jnp.float64, use_bvh=True)
    jr, jp, jf = jnp.asarray(rays.numpy()), jax_dm.mesh_params(jms, jnp.float64), jnp.asarray(ms.faces)
    np.testing.assert_allclose(np.asarray(jax_mm.first_hit_mesh(jr, jj)[0]),
                               np.asarray(jax_mm.first_hit_mesh(jr, jb)[0]), rtol=1e-12)
    d_j = np.asarray(jax_dm.depth_aov_params(jr, jp, jj, jf))
    d_b = np.asarray(jax_dm.depth_aov_params(jr, jp, jb, jf))
    wrong = int((np.abs(d_j - d_b) > 1e-9 * np.abs(d_b)).sum())
    print(f"JAX traced jnp-BVH depth differs from brute on {wrong} of {d_b.size} rays")
    assert wrong > 0
    for kw in (dict(use_bvh=True), dict(pallas_bvh_kernel=True, pallas_kernel="lockstep")):
        dev = mm.mesh_scene_to_device(ms, dtype=torch.float64, **kw)
        with pytest.raises(ValueError, match="leaf order"):
            dm.depth_aov_params(rays, params, dev, faces)
        with pytest.raises(ValueError, match="leaf order"):
            dm.render_pt_mesh_params(rays, params, dev, faces)
