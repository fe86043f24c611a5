"""Plain-torch reference render (ascendpathtracing_tpu_torch.models.megakernel)
against the NumPy oracle and the JAX package's megakernel, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, oracle, scenes
from ascendpathtracing_tpu.models import megakernel as jx_mk
from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.models import megakernel


def _scene_pair(np_dt, t_dt):
    """The same scene through the JAX package and the port."""
    scene = scenes.cornell8()
    jdev = jx_mk.scene_to_device(scene, dtype=np_dt)
    return scene, jdev, convert.scene_dict_from_numpy(jdev, dtype=t_dt)


def test_scene_to_device_matches_jax_dict():
    scene, jdev, tdev = _scene_pair(np.float64, torch.float64)
    mine = megakernel.scene_to_device(scene, dtype=torch.float64)
    for k in ("r2", "center", "emission", "albedo"):
        assert mine[k].dtype == torch.float64
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(jdev[k]))
        assert torch.equal(mine[k], tdev[k])
    assert mine["material"].dtype == torch.int32
    assert mine["light_index"] == tdev["light_index"] == 7


@pytest.mark.parametrize("w,bounces", [(16, 5), (32, 8)])
def test_float64_bitwise_vs_oracle_and_jax(w, bounces):
    """In float64 no eps decision can flip: the plain render equals the
    oracle and the JAX megakernel exactly."""
    scene, jdev, tdev = _scene_pair(np.float64, torch.float64)
    rays = camera.generate_rays_numpy(w, w, 1, seed=0)
    got = megakernel.render_reference_impl(torch.tensor(rays), tdev, bounces=bounces)
    assert got.dtype == torch.float64
    expect = oracle.render_reference_numpy(rays, scene, bounces=bounces, dtype=np.float64)
    np.testing.assert_array_equal(got.numpy(), expect)
    jx = np.asarray(jx_mk.render_reference(rays, jdev, bounces=bounces))
    np.testing.assert_allclose(got.numpy(), jx, rtol=1e-12, atol=1e-12)


def test_float32_single_bounce_bitwise_vs_oracle():
    scene, _, tdev = _scene_pair(np.float32, torch.float32)
    rays = camera.generate_rays_numpy(32, 32, 1, seed=0).astype(np.float32)
    got = megakernel.render_reference_impl(torch.tensor(rays), tdev, bounces=1)
    np.testing.assert_array_equal(
        got.numpy(), oracle.render_reference_numpy(rays, scene, bounces=1)
    )


def test_hits_trail_matches_jax_and_oracle_float64():
    scene, jdev, tdev = _scene_pair(np.float64, torch.float64)
    rays = camera.generate_rays_numpy(16, 16, 1, seed=1)
    got = megakernel.render_reference_hits_impl(torch.tensor(rays), tdev, bounces=6)
    assert got.dtype == torch.int32 and got.shape == (6, rays.shape[0])
    jx = np.asarray(jx_mk.render_reference_hits(jnp.asarray(rays), jdev, bounces=6))
    np.testing.assert_array_equal(got.numpy(), jx)
    ora = oracle.render_reference_hits_numpy(rays, scene, bounces=6, dtype=np.float64)
    np.testing.assert_array_equal(got.numpy(), ora)
    assert (got.numpy() == -2).any()  # some rays ended on the light


def test_float32_multibounce_trail_envelope_vs_oracle():
    """f32 multi-bounce is chaotic (see tests/test_reference_parity.py):
    every ray whose decision trail equals the oracle's is bitwise equal,
    and flips stay a minority."""
    w, bounces = 32, 6
    rays = camera.generate_rays_numpy(w, w, 2, seed=3).astype(np.float32)
    scene, _, tdev = _scene_pair(np.float32, torch.float32)
    expect = oracle.render_reference_numpy(rays, scene, bounces=bounces)
    got = megakernel.render_reference_impl(torch.tensor(rays), tdev, bounces=bounces).numpy()
    hits = megakernel.render_reference_hits_impl(
        torch.tensor(rays), tdev, bounces=bounces
    ).numpy()
    hits_ora = oracle.render_reference_hits_numpy(rays, scene, bounces=bounces)
    flipped = (hits != hits_ora).any(axis=0)
    assert flipped.mean() <= 0.60, f"{flipped.mean():.1%} rays flipped"
    diff = np.abs(expect - got).max(1)
    assert (diff[~flipped] == 0).all()


@pytest.mark.parametrize("bounces", [1, 5])
def test_autograd_matches_jax_grad(bounces):
    """torch autograd of the plain render equals jax.grad of the JAX one
    for the albedo and emission leaves (float64: the trails agree)."""
    _, jdev, tdev = _scene_pair(np.float64, torch.float64)
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0)

    def jloss(alb, emi):
        sc = dict(jdev, albedo=alb, emission=emi)
        return jnp.sum(jx_mk.render_reference_impl(jnp.asarray(rays), sc, bounces=bounces))

    ga, ge = jax.grad(jloss, argnums=(0, 1))(jdev["albedo"], jdev["emission"])
    alb = tdev["albedo"].clone().requires_grad_(True)
    emi = tdev["emission"].clone().requires_grad_(True)
    megakernel.render_reference_impl(
        torch.tensor(rays), dict(tdev, albedo=alb, emission=emi), bounces=bounces
    ).sum().backward()
    np.testing.assert_allclose(alb.grad.numpy(), np.asarray(ga), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(emi.grad.numpy(), np.asarray(ge), rtol=1e-12, atol=1e-12)
    assert np.abs(alb.grad.numpy()).max() > 0


def test_select_by_id_matches_gather_and_masks_backward():
    plane = torch.tensor([1.0, 2.0, 3.0, 4.0], requires_grad=True)
    gid = torch.tensor([3, 0, 0, 2], dtype=torch.int32)
    out = megakernel.select_by_id(gid, plane)
    assert torch.equal(out, plane.detach()[gid.long()])
    out.sum().backward()
    np.testing.assert_array_equal(plane.grad.numpy(), [2.0, 0.0, 1.0, 1.0])
