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
