"""The port's post-processing (post.py) on the CPU against the JAX
package's: each function on the same inputs in float64 (at 1e-12) and
float32 (rtol 1e-5), to_u8's bytes equal on the same HDR image, and the
JAX CLI's post pipeline (tests/test_post.py:132) on the port, whose
final.ppm from the JAX CLI's own color.bin and G-buffer is JAX's within
one level."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu import post as jax_post
from ascendpathtracing_tpu_torch import camera, cli, post, scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.utils import io
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

RTOL = {np.float64: 1e-12, np.float32: 1e-5}


def _inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.gamma(1.0, 0.6, (24, 20, 3)).astype(dtype)
    img[0, 0] = 0.0
    img[1, 1] = 40.0
    colors = rng.gamma(1.0, 3.0, (300, 3)).astype(dtype)
    colors[:5] *= 100.0  # fireflies
    return img, colors


def _close(got, want, dtype):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("max_radiance", [2.0, 10.0])
def test_firefly_clamp_matches_jax(dtype, max_radiance):
    _, colors = _inputs(dtype)
    got = post.firefly_clamp(torch.tensor(colors), max_radiance=max_radiance)
    want = jax_post.firefly_clamp(jnp.asarray(colors), max_radiance=max_radiance)
    assert got.dtype == torch.from_numpy(colors).dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("exposure", [1.0, 0.37])
@pytest.mark.parametrize("name", ["tonemap_reinhard", "tonemap_aces"])
def test_tonemaps_match_jax(dtype, exposure, name):
    img, _ = _inputs(dtype)
    got = getattr(post, name)(torch.tensor(img), exposure)
    _close(got, getattr(jax_post, name)(jnp.asarray(img), exposure), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("gamma", [2.2, 1.8])
def test_gamma_encode_matches_jax(dtype, gamma):
    img, _ = _inputs(dtype)
    img = img / 3.0 - 0.1  # both clip edges
    _close(post.gamma_encode(torch.tensor(img), gamma),
           jax_post.gamma_encode(jnp.asarray(img), gamma), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_to_u8_bytes_equal_jax(dtype):
    """The same HDR image, tone-mapped by JAX, gives the same bytes
    through both to_u8 (values on the .5 boundaries included)."""
    img, _ = _inputs(dtype)
    hdr = np.asarray(jax_post.gamma_encode(jax_post.tonemap_aces(jnp.asarray(img))))
    edges = (np.arange(24 * 20 * 3).reshape(24, 20, 3) % 256 + 0.5) / 255.0 - 0.5 / 255.0
    for x in (hdr, edges.astype(dtype), np.clip(img, -1, 2)):
        got, want = post.to_u8(torch.tensor(x)), jax_post.to_u8(jnp.asarray(x))
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -1), (-3, 4), (7, 0), (0, -25)])
def test_shift2_equals_jax(dy, dx):
    img, _ = _inputs(np.float32)
    for x in (img, img[..., 0]):
        np.testing.assert_array_equal(post._shift2(torch.tensor(x), dy, dx).numpy(),
                                      np.asarray(jax_post._shift2(jnp.asarray(x), dy, dx)))


def _guides(seed=1):
    rng = np.random.RandomState(seed)
    nrm = rng.randn(24, 20, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return {"normal": nrm.astype(np.float32),
            "depth": rng.uniform(1.0, 3.0, (24, 20)).astype(np.float32),
            "albedo": rng.uniform(0.0, 1.0, (24, 20, 3)).astype(np.float32)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("guides", [(), ("normal",), ("depth",), ("albedo",),
                                    ("normal", "depth", "albedo")])
def test_atrous_denoise_matches_jax(dtype, guides):
    """JAX's denoiser computes in float32 whatever the input (and returns
    the input's dtype), and so does the port's: both dtypes are compared
    at float32's rtol 1e-5 (exp and the power differ in the last bits
    between XLA and torch)."""
    img, _ = _inputs(dtype)
    g = {k: v for k, v in _guides().items() if k in guides}
    got = post.atrous_denoise(torch.tensor(img), iterations=3,
                              **{k: torch.tensor(v) for k, v in g.items()})
    want = jax_post.atrous_denoise(jnp.asarray(img), iterations=3,
                                   **{k: jnp.asarray(v) for k, v in g.items()})
    assert got.dtype == torch.from_numpy(img).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_atrous_keeps_a_noise_free_image_under_albedo_demodulation():
    """tests/test_post.py's round trip: constant irradiance passes."""
    alb = np.zeros((32, 32, 3), np.float32)
    alb[:, :16] = (0.9, 0.2, 0.2)
    alb[:, 16:] = (0.2, 0.9, 0.2)
    img = alb * 0.5
    out = post.atrous_denoise(torch.tensor(img), albedo=torch.tensor(alb), iterations=2)
    np.testing.assert_allclose(out.numpy(), img, atol=1e-4)


ARGS = ["render", "--width", "16", "--height", "16", "--backend", "cpu", "--mode", "pt",
        "--bounces", "3", "--denoise", "2", "--tonemap", "aces", "--clamp", "8",
        "--aov", "gbuffer"]


def test_cli_post_pipeline_equals_the_jax_cli(tmp_path):
    """tests/test_post.py:132 on both CLIs.  The path-traced colors differ
    (each package's own random stream), so the port's pipeline
    (cli.post_pipeline) runs on the JAX CLI's color.bin with the port's
    G-buffer of the same rays: final.ppm within one level of JAX's (XLA's
    and torch's float32 exp and power differ in the last bits).  The
    port's own run writes every artifact."""
    assert jax_cli.main([*ARGS, "--out", str(tmp_path / "jax")]) == 0
    assert cli.main([*ARGS, "--renderer", "plain", "--out", str(tmp_path / "port")]) == 0
    for name in ("color.ppm", "final.ppm", "depth.ppm", "normal.ppm", "albedo.ppm"):
        assert (tmp_path / "port" / name).exists(), name
    assert io.read_ppm(str(tmp_path / "port" / "final.ppm")).shape == (16, 16, 3)
    for name in ("depth.ppm", "normal.ppm", "albedo.ppm"):
        a, b = (io.read_ppm(str(tmp_path / d / name)).astype(int) for d in ("port", "jax"))
        assert np.abs(a - b).max() <= 1, name

    colors = io.read_color_bin(str(tmp_path / "jax" / "color.bin"))
    rays = torch.tensor(camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32))
    gbuf = megakernel.render_gbuffer_impl(
        rays, megakernel.scene_to_device(scenes.get_scene("smallpt9")))
    final = cli.post_pipeline(torch.tensor(colors), gbuf, 16, 16, 1, clamp=8.0, denoise=2,
                              tonemap="aces", exposure=1.0)
    want = io.read_ppm(str(tmp_path / "jax" / "final.ppm")).astype(int)
    assert final.dtype == np.uint8 and final.shape == (16, 16, 3)
    diff = np.abs(final.astype(int) - want)
    assert diff.max() <= 1 and diff.mean() < 0.05


@pytest.mark.parametrize("tonemap,denoise,clamp", [("none", 0, 4.0), ("reinhard", 1, 0.0),
                                                   ("none", 1, 0.0)])
def test_cli_post_options_equal_the_jax_cli_in_reference_mode(tmp_path, capsys, tonemap,
                                                              denoise, clamp):
    """Reference mode renders the same colors in both CLIs at 1 bounce
    (bit for bit), so final.ppm compares end to end: within one level."""
    args = ["render", "--width", "16", "--height", "16", "--backend", "cpu", "--bounces", "1",
            "--tonemap", tonemap, "--denoise", str(denoise), "--clamp", str(clamp),
            "--exposure", "0.8"]
    assert jax_cli.main([*args, "--renderer", "pallas", "--out", str(tmp_path / "jax")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main([*args, "--out", str(tmp_path / "port")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(ref) and got["final"].endswith("final.ppm")
    assert (tmp_path / "jax" / "color.bin").read_bytes() == \
        (tmp_path / "port" / "color.bin").read_bytes()
    a, b = (io.read_ppm(str(tmp_path / d / "final.ppm")).astype(int) for d in ("port", "jax"))
    assert np.abs(a - b).max() <= 1
