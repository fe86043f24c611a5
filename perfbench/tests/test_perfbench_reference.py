"""The plain reference against the program's CPU twins at 16 x 16 (the
reference itself imports nothing of the program; this test does)."""

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import refmode


def _cfg(name):
    return inputs.load_json("configs", name)


def _rel_l1(a, b):
    return float((a.double() - b.double()).abs().sum() / b.double().abs().sum())


def test_camera_rays_match_the_upstream_generator():
    from ascendpathtracing_tpu_torch import camera

    cfg = _cfg("cornell8")
    gen = torch.Generator().manual_seed(3)
    rays = inputs.camera_rays(cfg, 8, 6, gen, torch.float64)
    # The same jitter through the program's copy of gen_data.py's loops.
    u = torch.rand((2, 8 * 6 * 4), generator=torch.Generator().manual_seed(3),
                   dtype=torch.float64).T.reshape(-1).numpy()

    class Fixed:
        def rand(self, n):
            return u[:n]

    want = camera.generate_rays_numpy(8, 6, 1, rng=Fixed())
    np.testing.assert_allclose(rays.T.numpy(), want, rtol=0, atol=1e-12)
    assert inputs.camera_constants(cfg, 8, 6) == pytest.approx(
        __import__("ascendpathtracing_tpu_torch.ops.pt_kernels",
                   fromlist=["x"]).camera_constants(8, 6))


def test_icosphere_and_scenes_match_the_program():
    from ascendpathtracing_tpu_torch import scenes
    from ascendpathtracing_tpu_torch.accel import meshes

    v, f = inputs.icosphere((50, 40, 60), 14.0, 4)
    v2, f2 = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=4)
    np.testing.assert_array_equal(f, f2)
    np.testing.assert_allclose(v, v2, rtol=0, atol=1e-12)
    assert f.shape == (5120, 3)
    for name, prog in (("cornell8", scenes.cornell8()), ("smallpt9_ico4", scenes.smallpt9())):
        planes, mats, light = inputs.sphere_planes(_cfg(name))
        np.testing.assert_allclose(planes, prog.soa10(np.float64), rtol=1e-15)
        np.testing.assert_array_equal(mats, prog.material)
        assert light == prog.light_index


def test_reference_mode_matches_the_twin():
    from ascendpathtracing_tpu_torch.ops import render_kernels

    cfg = _cfg("cornell8")
    planes64, _, light = inputs.sphere_planes(cfg)
    planes = torch.tensor(planes64, dtype=torch.float32)
    rays = inputs.camera_rays(cfg, 16, 16, torch.Generator().manual_seed(5))
    want, idx = render_kernels.render_reference_planes_with_idx_plain(
        rays, planes, light_index=light, bounces=8)
    got = refmode.render(refmode.params_of(planes), rays, light=light, bounces=8, eps=1e-4)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    shade, _ = refmode.winners(rays, planes, light, 8, 1e-4)
    s = planes.shape[1]
    assert torch.equal(shade, torch.where(idx.long() == s, s - 1, idx.long()))


def test_sgd_steps_match_the_train_step_twin():
    from ascendpathtracing_tpu_torch.parallel.sharded import make_train_step

    cfg = _cfg("cornell8")
    planes64, _, light = inputs.sphere_planes(cfg)
    truth = refmode.params_of(torch.tensor(planes64, dtype=torch.float32))
    p0 = dict(truth, albedo=truth["albedo"] + 0.08)
    gen = torch.Generator().manual_seed(9)
    batches = []
    for _ in range(3):
        rays = inputs.camera_rays(cfg, 16, 16, gen)
        batches.append((rays, refmode.render(truth, rays, light=light, bounces=8, eps=1e-4)))
    step = make_train_step(None, bounces=8, learning_rate=0.05)
    params, losses = dict(p0), []
    for rays, target in batches:
        loss, params = step(params, {"light_index": light}, rays.T, target.T)
        losses.append(float(loss))
    ref_losses, _, states = refmode.sgd_steps(dict(p0), batches, lr=0.05, light=light,
                                              bounces=8, eps=1e-4)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for k in refmode.KEYS:
        torch.testing.assert_close(params[k], states[2][k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["cornell8", "smallpt9_ico4"])
def test_path_tracer_matches_the_twin(name):
    from perfbench.traffic import render

    cfg = _cfg(name)
    wl = {"width": 16, "height": 16, "spp4": 4}
    seed = 2 ** 31 + 11
    img = render.make_frame(cfg, wl, torch.device("cpu"))(seed)
    pixels = torch.arange(16 * 16)
    counts = {}
    ref = render.reference_pixels(cfg, wl, render.reference_scene(cfg, "cpu", torch.float32),
                                  pixels, seed, torch.float32, counts)
    assert _rel_l1(img, ref) < 1e-5
    assert counts["live_bounces"] > 16 * 16 * 4
    if name == "smallpt9_ico4":
        assert counts["triangle_hits"] > 0
    control = render.reference_pixels(
        cfg, wl, render.reference_scene(cfg, "cpu", torch.bfloat16), pixels, seed, torch.bfloat16)
    assert _rel_l1(control, ref) > 0.1
