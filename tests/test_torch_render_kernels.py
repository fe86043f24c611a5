"""The port's reference-render kernels (ascendpathtracing_tpu_torch.ops.
render_kernels): on the CPU the wrappers run their plain twins, held here
against the JAX package's Pallas kernels in interpret mode and the NumPy
oracle.  ``test_torch_cuda.py`` holds the CUDA kernels against the twins
on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, oracle, scenes
from ascendpathtracing_tpu.ops import pallas_kernels as pk
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.ops import build
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn
from tests.test_torch_cuda import _reference_scene
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

LIGHT = 7
TILE = 1024


def _inputs(w=32, np_dt=np.float64, seed=0, device="cpu"):
    """The same rays and scene planes, as numpy and as the port's tensors."""
    t_dt = torch.float64 if np_dt == np.float64 else torch.float32
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(w, w, 1, seed=seed).astype(np_dt)
    planes = scene.soa10(np_dt)
    return (
        scene, rays, planes,
        convert.rays_planes_from_numpy(rays, device=device, dtype=t_dt),
        convert.scene_planes_from_numpy(planes, device=device, dtype=t_dt),
    )


@pytest.mark.parametrize("bounces", [5, 8])
def test_plain_fwd_f64_matches_pallas_and_oracle(bounces):
    scene, rays, planes, rp, sp = _inputs()
    got = rk.render_reference_planes(rp, sp, light_index=LIGHT, bounces=bounces)
    jx = pk.render_reference_pallas_planes(
        jnp.asarray(rays.T.copy()), jnp.asarray(planes), light_index=LIGHT,
        bounces=bounces, tile=TILE, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)
    ora = oracle.render_reference_numpy(rays, scene, bounces=bounces, dtype=np.float64)
    np.testing.assert_array_equal(got.T.numpy(), ora)


def test_plain_fwd_f32_one_bounce_bitwise_vs_oracle():
    scene, rays, _, rp, sp = _inputs(np_dt=np.float32)
    got = rk.render_reference_planes(rp, sp, light_index=LIGHT, bounces=1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.T.numpy(), oracle.render_reference_numpy(rays, scene, bounces=1)
    )


def test_idx_and_colors_match_pallas_with_idx_f64():
    _, rays, planes, rp, sp = _inputs()
    colors, idx = rk.render_reference_planes_with_idx(rp, sp, light_index=LIGHT, bounces=8)
    jc, jidx = pk.render_reference_pallas_planes_with_idx(
        jnp.asarray(rays.T.copy()), jnp.asarray(planes), light_index=LIGHT,
        bounces=8, tile=TILE, interpret=True,
    )
    assert idx.dtype == torch.int32 and idx.shape == (8, rays.shape[0])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(colors.numpy(), np.asarray(jc), rtol=1e-12, atol=1e-12)
    assert torch.equal(colors, rk.render_reference_planes(rp, sp, light_index=LIGHT, bounces=8))


def _agreeing_rays(rays, planes, bounces):
    """Rays whose per-bounce winners agree between the Pallas kernel
    (interpret mode, XLA's CPU arithmetic) and the port (IEEE op by op).
    In float32 the Cornell walls make some winners flip by rounding (see
    tests/test_reference_parity.py); a ray's gradient contribution depends
    only on its winners, so gradients are compared with the cotangent
    zeroed on the rays that flipped."""
    _, jidx = pk.render_reference_pallas_planes_with_idx(
        jnp.asarray(rays.T.copy()), jnp.asarray(planes), light_index=LIGHT,
        bounces=bounces, tile=TILE, interpret=True,
    )
    _, idx = rk.render_reference_planes_with_idx(
        convert.rays_planes_from_numpy(rays), convert.scene_planes_from_numpy(planes),
        light_index=LIGHT, bounces=bounces,
    )
    agree = (np.asarray(jidx) == idx.numpy()).all(axis=0)
    assert agree.mean() >= 0.4, f"only {agree.mean():.1%} of trails agree"
    if bounces == 1:
        assert agree.all()
    return np.asarray(jidx), agree


@pytest.mark.parametrize("bounces", [1, 5])
def test_plain_backwards_match_pallas_backwards(bounces):
    """Same idx and a non-trivial cotangent on both sides; replay and
    recompute against _render_ref_bwd_replay / _render_ref_bwd."""
    _, rays, planes, rp, sp = _inputs(w=16, np_dt=np.float32)
    n = rays.shape[0]
    jidx, agree = _agreeing_rays(rays, planes, bounces)
    g_np = np.arange(3 * n, dtype=np.float32).reshape(3, n) * agree
    pl_j, g_j = jnp.asarray(planes), jnp.asarray(g_np)
    j_rep = np.asarray(pk._render_ref_bwd_replay(
        jnp.asarray(jidx), pl_j, g_j, light_index=LIGHT, bounces=bounces,
        tile=TILE, interpret=True,
    ))
    j_rec = np.asarray(pk._render_ref_bwd(
        jnp.asarray(rays.T.copy()), pl_j, g_j, light_index=LIGHT,
        bounces=bounces, eps=1e-4, tile=TILE, interpret=True,
    ))
    g = torch.tensor(g_np)
    rep = rk.render_ref_bwd_replay(
        torch.tensor(jidx), sp, g, light_index=LIGHT, bounces=bounces
    )
    rec = rk.render_ref_bwd(rp, sp, g, light_index=LIGHT, bounces=bounces)
    np.testing.assert_allclose(rep.numpy(), j_rep, rtol=1e-5)
    np.testing.assert_allclose(rec.numpy(), j_rec, rtol=1e-5)
    assert rep[0:4].abs().max() == 0.0 and rec[0:4].abs().max() == 0.0
    off_light = np.delete(np.arange(8), LIGHT)
    assert rep[4:7, off_light].abs().max() == 0.0


# (S, light): the CUDA launchers dispatch each S to a kernel of its own,
# so the twins are held to the Pallas kernels at S other than cornell8's,
# the light first and last.
SPHERE_COUNTS = [(1, 0), (9, 0), (9, 8), (16, 0), (16, 15)]


def _scene_case(s, light, w=16):
    """Camera rays (4 w^2, float64) and :func:`_reference_scene`'s planes,
    as numpy and as the port's float64 tensors."""
    rays = camera.generate_rays_numpy(w, w, 1, seed=s)
    planes = _reference_scene(s, light)
    return (rays, planes, convert.rays_planes_from_numpy(rays, dtype=torch.float64),
            convert.scene_planes_from_numpy(planes, dtype=torch.float64))


@pytest.mark.parametrize("s,light", SPHERE_COUNTS)
def test_plain_forwards_match_pallas_at_each_sphere_count(s, light):
    rays, planes, rp, sp = _scene_case(s, light)
    kw = dict(light_index=light, bounces=3)
    colors, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    jc, jidx = pk.render_reference_pallas_planes_with_idx(
        jnp.asarray(rays.T.copy()), jnp.asarray(planes), tile=TILE, interpret=True, **kw
    )
    # A ray that misses starts its next bounce 1e20 away, where XLA's CPU
    # arithmetic and the port's IEEE ops round its direction apart, and
    # where the Pallas kernel keeps the miss distance for a hit further
    # still that the twin, as the oracle's argmin, bounces from (only the
    # open one-sphere scene has misses; its light's albedo is 0, so the
    # colors do not depend on them): trails agree up to a first miss.
    miss = idx.numpy() == s
    after_miss = np.cumsum(miss, axis=0) - miss > 0
    assert after_miss.any() == (s == 1)
    np.testing.assert_array_equal(np.where(after_miss, -1, idx.numpy()),
                                  np.where(after_miss, -1, np.asarray(jidx)))
    np.testing.assert_allclose(colors.numpy(), np.asarray(jc), rtol=1e-12, atol=1e-12)
    jf = pk.render_reference_pallas_planes(
        jnp.asarray(rays.T.copy()), jnp.asarray(planes), tile=TILE, interpret=True, **kw
    )
    np.testing.assert_allclose(rk.render_reference_planes(rp, sp, **kw).numpy(), np.asarray(jf),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s,light", SPHERE_COUNTS)
def test_plain_backwards_match_pallas_at_each_sphere_count(s, light):
    """The float64 twins against the Pallas backwards, which take float32
    only: the replay on the twin's trails, the recompute with the
    cotangent zeroed on rays whose float32 Pallas trail differs (3
    bounces: float32 and float64 trails part ways with depth)."""
    rays, planes, rp, sp = _scene_case(s, light)
    kw = dict(light_index=light, bounces=3)
    _, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    r32, p32 = jnp.asarray(rays.T.astype(np.float32)), jnp.asarray(planes.astype(np.float32))
    _, jidx = pk.render_reference_pallas_planes_with_idx(r32, p32, tile=TILE, interpret=True,
                                                         **kw)
    agree = (np.asarray(jidx) == idx.numpy()).all(axis=0)
    assert agree.mean() >= 0.6, f"only {agree.mean():.1%} of trails agree"
    g = np.random.RandomState(s).uniform(0.5, 1.5, (3, rays.shape[0])) * agree
    g_j = jnp.asarray(g.astype(np.float32))
    j_rep = np.asarray(pk._render_ref_bwd_replay(jnp.asarray(idx.numpy()), p32, g_j, tile=TILE,
                                                 interpret=True, **kw))
    j_rec = np.asarray(pk._render_ref_bwd(r32, p32, g_j, eps=1e-4, tile=TILE, interpret=True,
                                          **kw))
    rep = rk.render_ref_bwd_replay(idx, sp, torch.tensor(g), **kw)
    rec = rk.render_ref_bwd(rp, sp, torch.tensor(g), **kw)
    np.testing.assert_allclose(rep.numpy(), j_rep, rtol=1e-5)
    np.testing.assert_allclose(rec.numpy(), j_rec, rtol=1e-5)
    assert rep[7:10].abs().max() > 0 or s == 1


def _discriminants(kind, dtype):
    """Discriminants of one kind: random of either sign, +-0, subnormals,
    +-inf or NaNs."""
    rng = np.random.RandomState(0)
    tiny = np.finfo(dtype).tiny
    return {
        "random": rng.randn(4096) * 10.0 ** rng.randint(-30, 30, 4096),
        "zero": np.array([0.0, 0.0]),
        "negative_zero": np.array([-0.0, -0.0]),
        "subnormal": np.array([tiny / 2, tiny / 1024, -tiny / 2, -tiny / 1024]),
        "inf": np.array([np.inf, -np.inf]),
        "nan": np.array([np.nan, -np.nan]),
    }[kind].astype(dtype)


@pytest.mark.parametrize("kind", ["random", "zero", "negative_zero", "subnormal", "inf", "nan"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sqrt_of_one_on_invalid_lanes_equals_sqrt_of_zero(kind, dtype):
    """render_ref.cu's closest-hit takes valid ? sqrt(valid ? det : 1) : 0
    where the Pallas kernel takes sqrt(valid ? det : 0), valid = det >= 0:
    the same bits for every discriminant."""
    det = torch.from_numpy(_discriminants(kind, dtype))
    valid = det >= 0
    new = torch.where(valid, sqrt_rn(torch.where(valid, det, 1.0)), 0.0)
    old = sqrt_rn(torch.where(valid, det, 0.0))
    bits = torch.int32 if dtype == np.float32 else torch.int64
    assert new.dtype == old.dtype == det.dtype
    assert torch.equal(new.view(bits), old.view(bits))


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("bounces", [1, 5])
def test_custom_vjp_matches_pallas_vjp(bounces, replay):
    _, rays, planes, rp, sp = _inputs(w=16, np_dt=np.float32)
    _, agree = _agreeing_rays(rays, planes, bounces)
    rp_j = jnp.asarray(rays.T.copy())
    w_j = jnp.asarray(np.broadcast_to(agree, (3, agree.size)).astype(np.float32))
    render_j = pk.make_render_reference_pallas_diff(
        light_index=LIGHT, bounces=bounces, tile=TILE, interpret=True, replay=replay
    )
    gj = np.asarray(
        jax.grad(lambda p: jnp.sum(render_j(rp_j, p) * w_j))(jnp.asarray(planes))
    )
    render = rk.make_render_reference_diff(light_index=LIGHT, bounces=bounces, replay=replay)
    p = sp.clone().requires_grad_(True)
    r = rp.clone().requires_grad_(True)
    (render(r, p) * torch.tensor(np.asarray(w_j))).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), gj, rtol=1e-4, atol=1e-3)
    assert p.grad[0:4].abs().max() == 0.0
    assert r.grad.abs().max() == 0.0


def test_module_forward_backward_and_no_grad_forward():
    _, _, _, rp, sp = _inputs(w=16)
    model = rk.RenderReference(sp, light_index=LIGHT, bounces=3)
    assert [n for n, _ in model.named_parameters()] == ["scene_planes"]
    out = model(rp)
    assert torch.equal(out.detach(), rk.render_reference_planes(rp, sp, light_index=LIGHT, bounces=3))
    out.sum().backward()
    assert model.scene_planes.grad.shape == (10, 8)
    assert model.scene_planes.grad[7:10].abs().max() > 0
    with torch.no_grad():
        assert not model(rp).requires_grad


def test_aos_wrapper_pads_ragged_ray_count():
    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(16, 10, 1, seed=1)  # 640 rays, float64
    sp = convert.scene_planes_from_numpy(scene.soa10(np.float64), dtype=torch.float64)
    # 640 rays is no multiple of the Pallas tile (512) nor of the CUDA
    # block (256): the Pallas wrapper pads, the port's kernels guard.
    got = rk.render_reference(torch.tensor(rays), sp, light_index=LIGHT, bounces=2)
    assert got.shape == (640, 3)
    assert torch.isfinite(got).all()
    planes = rk.render_reference_planes(
        convert.rays_planes_from_numpy(rays, dtype=torch.float64), sp,
        light_index=LIGHT, bounces=2,
    )
    assert torch.equal(got, planes.T)
    jx = pk.render_reference_pallas(
        jnp.asarray(rays), jnp.asarray(scene.soa10(np.float64)), light_index=LIGHT,
        bounces=2, tile=512, interpret=True,
    )
    assert np.asarray(jx).shape == (640, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=1e-12, atol=1e-12)


def test_cpu_tensors_run_plain_twins_without_counting():
    _, _, _, rp, sp = _inputs(w=8)
    rk.reset_launches()
    out, idx = rk.render_reference_planes_with_idx(rp, sp, light_index=LIGHT, bounces=2)
    rk.render_ref_bwd_replay(idx, sp, torch.ones_like(out), light_index=LIGHT, bounces=2)
    assert rk.LAUNCHES == {"fwd": 0, "fwd_idx": 0, "bwd_replay": 0, "bwd_recompute": 0}


@pytest.mark.parametrize(
    "mutate,exc",
    [
        (lambda rp, sp: (rp.float(), sp), TypeError),  # mixed dtypes
        (lambda rp, sp: (rp[:5], sp), ValueError),  # not [6, N]
        (lambda rp, sp: (rp, sp[:, :3].contiguous()), ValueError),  # light 7 >= S
        (lambda rp, sp: (rp, torch.zeros(10, 17, dtype=sp.dtype)), ValueError),  # S > MAX_S
        (lambda rp, sp: (rp.T.contiguous().T, sp), ValueError),  # not contiguous
        (lambda rp, sp: (rp.int(), sp.int()), TypeError),  # not float
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, exc):
    _, _, _, rp, sp = _inputs(w=8)
    rp, sp = mutate(rp, sp)
    with pytest.raises(exc):
        rk.render_reference_planes(rp, sp, light_index=LIGHT, bounces=2)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("render_ref")


def test_library_name_tracks_the_sources():
    p = build.library_path("render_ref")
    assert p.parent == build.BUILD_DIR and p.name.startswith("librender_ref-")
    assert p == build.library_path("render_ref")
    assert (build.CSRC_DIR / "render_ref.cu").exists()
    assert "-fmad=false" in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS
