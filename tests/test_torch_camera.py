"""The port's differentiable camera (diff/camera) and finite-difference
checks (diff/fd) on the CPU: the six gates of tests/test_grad.py on the
port's renderers (float64 AD against central differences: albedo,
emission, the zero geometry gradient of the radiance, centers and r^2
through the depth AOV, the camera through camera_rays and the depth AOV,
and the PT estimator at fixed draws), camera_rays against JAX's
camera_rays on JAX's jitter, and fd_grad against JAX's fd_grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import scenes
from ascendpathtracing_tpu.diff import camera as jax_camera
from ascendpathtracing_tpu.diff import fd as jax_fd
from ascendpathtracing_tpu_torch import camera as cam_np
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.diff import CameraParams, camera_rays, check_grads_fd, fd_grad
from ascendpathtracing_tpu_torch.models import megakernel
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

W = H = 12
BOUNCES = 3


def _scene(name, dtype=torch.float64):
    return megakernel.scene_to_device(scenes.get_scene(name), dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    rays = torch.tensor(cam_np.generate_rays_numpy(W, H, 1, seed=0))
    scene = _scene("cornell8")
    with torch.no_grad():
        target = megakernel.render_reference_impl(rays, scene, bounces=BOUNCES)
    return rays, scene, target


def _loss_fn(rays, scene, target):
    def loss(p):
        img = megakernel.render_reference_impl(rays, {**scene, **p}, bounces=BOUNCES)
        return ((img - target + 0.05) ** 2).mean()

    return loss


def _depth_loss(rays, scene):
    def loss(p):
        return (megakernel.render_depth_impl(rays, {**scene, **p}) ** 2).mean() * 1e-4

    return loss


def test_albedo_gradients_match_fd(setup):
    rays, scene, target = setup
    check_grads_fd(_loss_fn(rays, scene, target), {"albedo": scene["albedo"]},
                   eps=1e-6, coords=10, rtol=1e-5, atol=1e-9)


def test_emission_gradients_match_fd(setup):
    rays, scene, target = setup
    check_grads_fd(_loss_fn(rays, scene, target), {"emission": scene["emission"]},
                   eps=1e-6, coords=9, rtol=1e-5, atol=1e-9)


def test_radiance_is_piecewise_constant_in_geometry(setup):
    """The reference-mode radiance is a product of discretely chosen
    albedos, so its r^2 gradient is exactly zero."""
    rays, scene, target = setup
    r2 = scene["r2"].clone().requires_grad_(True)
    out = _loss_fn(rays, scene, target)({"r2": r2})
    # No differentiable path reaches r^2 at all: its gradient is 0.
    g = torch.autograd.grad(out, [r2], allow_unused=True)[0] if out.requires_grad else None
    assert g is None or bool((g == 0).all())


def test_geometry_gradients_match_fd_depth_aov(setup):
    rays, scene, _ = setup
    loss = _depth_loss(rays, scene)
    check_grads_fd(loss, {"center": scene["center"]}, eps=1e-4, coords=8, rtol=5e-4,
                   atol=1e-12)
    # r^2 spans 272 (mirror) .. 1e10 (walls): relative steps.
    check_grads_fd(loss, {"r2": scene["r2"]}, eps=1e-7, rel=True, coords=[0, 4, 6, 7],
                   rtol=1e-3, atol=1e-12)


def test_camera_gradients_match_fd_depth_aov(setup):
    _, scene, _ = setup
    jitter = torch.zeros((W * H * 4, 2), dtype=torch.float64)

    def loss(p):
        rays = camera_rays(p, W, H, 1, jitter=jitter)
        return (megakernel.render_depth_impl(rays, scene) ** 2).mean() * 1e-4

    ad, fd = check_grads_fd(loss, CameraParams(dtype=torch.float64), eps=1e-6, coords=None,
                            rtol=1e-3, atol=1e-8)
    assert set(ad) == {"pos", "raw_dir", "fov"}
    assert max(float(g.abs().max()) for g in ad.values()) > 0


def _jax_draws(key, bounces, k, n):
    """The JAX estimator's per-bounce draws: split, then uniform (k, n)."""
    out = []
    for _ in range(bounces):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (k, n), dtype=jnp.float64)))
    return np.stack(out)


def test_pt_mode_gradients_finite_and_fd_albedo():
    """With the draws fixed (JAX's PRNGKey(2) draws), the path is a
    deterministic function of the parameters, so AD == FD on albedo."""
    rays = torch.tensor(cam_np.generate_rays_numpy(8, 8, 1, seed=1))
    scene = _scene("smallpt9")
    u = convert.uniforms_from_numpy(_jax_draws(jax.random.PRNGKey(2), 3, 3, rays.shape[0]),
                                    dtype=torch.float64)

    def loss(p):
        return megakernel.render_pt_impl(rays, {**scene, **p}, bounces=3, rr_depth=99,
                                         uniforms=u).mean()

    ad, _ = check_grads_fd(loss, {"albedo": scene["albedo"]}, eps=1e-6, coords=8, rtol=1e-4,
                           atol=1e-9)
    assert bool(torch.isfinite(ad["albedo"]).all())


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_camera_rays_match_jax(dtype, rtol):
    """JAX's camera_rays with jitter drawn from a key; the port's on the
    same jitter.  The JAX side computes its index arithmetic in float64
    (x64 is on) and casts at the end, the port in the parameters' dtype:
    float32 agrees to rtol 1e-6 with an absolute floor of 1e-6 (the
    directions are unit vectors)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    key = jax.random.PRNGKey(3)
    w, h, s = 10, 6, 2
    n = w * h * 4 * s
    params = jax_camera.CameraParams(pos=(48.0, 50.0, 290.0), raw_dir=(0.02, -0.05, -1.0),
                                     fov=0.55, dtype=jdt)
    ref = np.asarray(jax_camera.camera_rays(params, w, h, s, key=key))
    r = 2.0 * np.asarray(jax.random.uniform(key, (n, 2), dtype=jdt))
    jit = np.where(r < 1, np.sqrt(r) - 1, 1 - np.sqrt(np.maximum(2 - r, 0)))
    got = camera_rays(CameraParams(pos=(48.0, 50.0, 290.0), raw_dir=(0.02, -0.05, -1.0),
                                   fov=0.55, dtype=dtype), w, h, s,
                      jitter=torch.tensor(jit, dtype=dtype))
    assert got.dtype == dtype and got.shape == (n, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=0.0 if dtype == torch.float64 else 1e-6)
    zero = camera_rays(CameraParams(dtype=dtype), w, h, s)
    ref0 = np.asarray(jax_camera.camera_rays(jax_camera.CameraParams(dtype=jdt), w, h, s))
    np.testing.assert_allclose(zero.numpy(), ref0, rtol=rtol,
                               atol=0.0 if dtype == torch.float64 else 1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = camera_rays(CameraParams(dtype=dtype), w, h, s, generator=gen)
    assert drawn.shape == (n, 6) and not torch.equal(drawn, zero)


def test_camera_rays_default_camera_are_the_host_generator_rays():
    """Zero jitter puts every sample at its sub-pixel centre: the rays of
    generate_rays_numpy with r1 = r2 = 1 (tent offset 0)."""
    w, h = 6, 4
    got = camera_rays(CameraParams(dtype=torch.float64), w, h, 1).numpy()

    class Centre:
        @staticmethod
        def rand(n):
            return np.full(n, 0.5)

    ref = cam_np.generate_rays_numpy(w, h, 1, rng=Centre())
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_fd_grad_matches_jax_fd_grad():
    """One float64 loss, the same sampled coordinates (sorted leaves, one
    RandomState), relative and absolute steps: equal to 1e-12."""
    a0 = np.array([1.5, -0.25, 3.0, 0.75])
    b0 = np.array([[2.0, -1.0], [0.5, 4.0]])

    def loss_j(p):
        a, b = p["a"], p["b"]
        return a[0] * a[1] * b[0, 0] + a[2] * a[2] * a[2] - b[1, 1] * a[0] + b[0, 1] * b[1, 0]

    def loss_t(p):
        a, b = p["a"], p["b"]
        return a[0] * a[1] * b[0, 0] + a[2] * a[2] * a[2] - b[1, 1] * a[0] + b[0, 1] * b[1, 0]

    for kw in (dict(coords=3), dict(coords=None, rel=True), dict(coords=[1, 2], eps=1e-4)):
        ref = jax_fd.fd_grad(loss_j, {"b": jnp.asarray(b0), "a": jnp.asarray(a0)},
                             rng=np.random.RandomState(7), **kw)
        got = fd_grad(loss_t, {"b": torch.tensor(b0), "a": torch.tensor(a0)},
                      rng=np.random.RandomState(7), **kw)
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.isnan(got[k].numpy()), np.isnan(ref[k]))
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-12, atol=0)
