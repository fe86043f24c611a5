"""The fused path tracer of the port (ascendpathtracing_tpu_torch.ops.
pt_kernels) and its entry points on the CPU: the plain twin against the
Pallas kernel in interpret mode (zero uniforms, its u = 0 estimator) and
against the plain estimator (Philox), the wrapper's checks, and the CLI's
pt mode against the JAX CLI.  ``test_torch_cuda.py`` holds the CUDA
kernel against the twin on a card."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, scenes
from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu.ops import pallas_kernels as pk
from ascendpathtracing_tpu.utils import io
from ascendpathtracing_tpu_torch import bench, cli, convert
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import rng
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)


def _scene(name="cornell8", dtype=torch.float32, device="cpu"):
    sc = scenes.get_scene(name)
    return (
        sc,
        convert.scene_planes_from_numpy(sc.soa10(np.float64), device=device, dtype=dtype),
        torch.tensor(sc.material, dtype=torch.int32, device=device),
    )


def _pallas_zero_uniforms(sc, w, spp4, bounces, rr_depth):
    """The Pallas kernel in interpret mode: its PRNG becomes zeros."""
    return np.asarray(pk.render_pt_pallas(
        jnp.asarray(sc.soa10()), width=w, height=w, spp4=spp4,
        materials=tuple(int(m) for m in sc.material), bounces=bounces,
        rr_depth=rr_depth, tile=1024, interpret=True,
    ))


# ---------------------------------------------------------- the twin ----
def test_twin_zero_uniforms_matches_pallas_one_bounce():
    """cornell8, 32x32, spp4 = 4, 1 bounce: allclose rtol 1e-5 (equal in
    every pixel as measured)."""
    sc, planes, mats = _scene()
    u = torch.zeros((4, ptk.n_uniforms(1), 32 * 32))
    got = ptk.render_pt(planes, mats, width=32, height=32, spp4=4, bounces=1, uniforms=u)
    jx = _pallas_zero_uniforms(sc, 32, 4, 1, 5)
    assert got.shape == (3, 32 * 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jx, rtol=1e-5, atol=0)
    assert float(got.max()) > 0


def test_twin_zero_uniforms_matches_pallas_three_bounces():
    """cornell8, 32x32, spp4 = 4, 3 bounces, RR from 2 (the RR phase runs
    with u = 0).  Pallas interpret mode computes with XLA's CPU
    arithmetic and the twin op by op in IEEE float32, so a path may flip;
    bounds: >= 99% of pixels within 1e-4 relative (100% measured) and the
    means within 1e-5 relative (equal as measured)."""
    sc, planes, mats = _scene()
    u = torch.zeros((4, ptk.n_uniforms(3), 32 * 32))
    got = ptk.render_pt(planes, mats, width=32, height=32, spp4=4, bounces=3,
                        rr_depth=2, uniforms=u).numpy()
    jx = _pallas_zero_uniforms(sc, 32, 4, 3, 2)
    share = (np.abs(got - jx) <= 1e-4 * np.abs(jx)).mean()
    assert share >= 0.99, share
    assert abs(got.mean() - jx.mean()) <= 1e-5 * jx.mean()


def test_twin_philox_matches_plain_estimator_energy():
    """Independent streams, cornell8, 128x128 x spp4 = 64 (1,048,576
    paths), 4 bounces, RR from 3: relative mean difference < 0.025 (its
    standard error is ~0.7% here; 0.09% measured) and pixel correlation
    > 0.9 (as tests/test_pallas_pt_tpu.py:47-50; 0.994 measured)."""
    sc, planes, mats = _scene()
    w, spp4 = 128, 64
    img = ptk.render_pt(planes, mats, width=w, height=w, spp4=spp4, bounces=4, rr_depth=3)
    rays = camera.generate_rays_numpy(w, w, spp4 // 4, seed=0).astype(np.float32)
    est = megakernel.render_pt_impl(torch.tensor(rays), megakernel.scene_to_device(sc),
                                    bounces=4, rr_depth=3).numpy()
    ref = est.reshape(w * w, spp4, 3).mean(1).T  # per-pixel means, [3, W*H]
    img = img.numpy()
    assert np.isfinite(img).all() and img.min() >= 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.025
    assert np.corrcoef(img.reshape(-1), ref.reshape(-1))[0, 1] > 0.9


def test_twin_stream_is_the_philox_uniforms():
    """uniforms=None draws uniform q of pixel p, layer a from the fused
    stream at counter (p, a, q // 4, 0): passing those in gives the same
    image; another seed gives another image."""
    _, planes, mats = _scene("smallpt9")
    kw = dict(width=8, height=6, spp4=8, bounces=4, rr_depth=2)
    pix = torch.arange(8 * 6)
    u = torch.stack([rng.uniforms(5, pix, a, ptk.n_uniforms(4), stream=rng.STREAM_FUSED,
                                  dtype=torch.float32) for a in range(8)])
    img = ptk.render_pt(planes, mats, seed=5, **kw)
    assert torch.equal(img, ptk.render_pt(planes, mats, uniforms=u, **kw))
    assert not torch.equal(img, ptk.render_pt(planes, mats, seed=6, **kw))


def test_twin_float64_ragged_image():
    """Any W*H (no tile multiple) and float64."""
    _, planes, mats = _scene("smallpt9", torch.float64)
    img = ptk.render_pt(planes, mats, width=10, height=7, spp4=4, bounces=5)
    assert img.shape == (3, 70) and img.dtype == torch.float64
    assert torch.isfinite(img).all() and float(img.min()) >= 0


def _twin_cutting_zero_throughput(planes, mats, **kw):
    """The twin with render_pt.cu's zero-throughput exit modelled around
    it (no option of the twin): a hit function that tracks each channel's
    zero albedos over a path's taken bounces and returns a miss for a path
    whose three channels have all met one -> (image, paths cut)."""
    planes_pad, mat_pad = ptk.pad_scene(planes, mats)
    eps, state = kw["eps"], {"cut": 0}

    def hit_fn(o3, d3, alive, layer, k):
        tmin, win = ptk.sphere_hits(planes_pad, *o3, *d3, eps)
        if k == 0:
            state["zero"] = torch.zeros((3,) + alive.shape, dtype=torch.bool)
        dead = alive & state["zero"].all(dim=0)
        state["cut"] += int(dead.sum())
        tmin = torch.where(dead, torch.full_like(tmin, ptk.MISS_T), tmin)
        srf = ptk.surface(planes_pad, mat_pad, win, tmin, o3, d3)
        state["zero"] |= alive & ~dead & (tmin < ptk.MISS_T) & (torch.stack(srf[3]) == 0)
        return tmin, srf, win

    img = ptk.render_layers(hit_fn, dtype=planes.dtype, device=planes.device,
                            uniforms=None, cam=ptk.camera_constants(kw["width"], kw["height"]),
                            **{k: v for k, v in kw.items() if k != "uniforms"})
    return img, state["cut"]


@pytest.mark.parametrize("name", ["cornell8", "smallpt9"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zero_throughput_bounces_add_plus_zero(name, dtype):
    """A path whose throughput is exactly zero in all three channels (it
    met the black front wall or the light, albedo (0, 0, 0)) adds +0 at
    every later bounce of the twin: ending such paths, as render_pt.cu's
    kernel does, leaves the twin's image bit for bit; and the twin's path
    record marks the queries of the same paths from there on."""
    _, planes, mats = _scene(name, dtype)
    kw = dict(width=16, height=16, spp4=8, bounces=8, rr_depth=5, eps=1e-4, seed=3)
    want = ptk.render_pt_plain(planes, mats, **kw)
    got, cut = _twin_cutting_zero_throughput(planes, mats, **kw)
    assert cut > 100
    assert torch.equal(got, want)
    img, queried, live, zero = ptk.path_record_plain(planes, mats, **kw)
    assert torch.equal(img, want)
    assert int(zero.any(dim=1).sum()) == cut and bool((zero <= queried).all())
    assert bool((live <= queried).all()) and int(live.sum()) > int((live & zero).sum()) > 0


def test_camera_constants_follow_camera_basis():
    pos, d0, cx, cy = camera.Camera().basis(64, 32)
    got = ptk.camera_constants(64, 32)
    assert got == (*pos, *d0, cx[0], cy[0], cy[1], cy[2], camera.ORIGIN_PUSH)
    assert all(isinstance(x, float) for x in got)


def test_cpu_tensors_run_the_twin_without_counting():
    _, planes, mats = _scene()
    ptk.reset_launches()
    ptk.render_pt(planes, mats, width=4, height=4, spp4=4, bounces=2)
    assert ptk.LAUNCHES == {"pt": 0}


@pytest.mark.parametrize(
    "change,exc",
    [
        (dict(planes=torch.zeros(10, 17)), ValueError),  # S > MAX_S
        (dict(planes=torch.zeros(10, 8, dtype=torch.int32)), TypeError),
        (dict(planes=torch.zeros(8, 8)), ValueError),  # not [10, S]
        (dict(mats=torch.zeros(8, dtype=torch.int64)), TypeError),
        (dict(mats=torch.zeros(7, dtype=torch.int32)), ValueError),
        (dict(spp4=6), ValueError),  # not a multiple of 4
        (dict(spp4=0), ValueError),
        (dict(width=0), ValueError),
        (dict(uniforms=torch.zeros(4, 8, 16)), ValueError),  # wrong shape
        (dict(uniforms=torch.zeros(4, 11, 16, dtype=torch.float64)), TypeError),
        (dict(planes=torch.zeros(8, 10).T), ValueError),  # not contiguous
    ],
)
def test_wrapper_rejects_bad_inputs(change, exc):
    _, planes, mats = _scene()
    kw = dict(planes=planes, mats=mats, width=4, height=4, spp4=4, uniforms=None)
    kw.update(change)
    with pytest.raises(exc):
        ptk.render_pt(kw.pop("planes"), kw.pop("mats"), bounces=3, **kw)


# ------------------------------------------------------ entry points ----
PT_ARGS = ["render", "--mode", "pt", "--backend", "cpu", "--width", "32",
           "--height", "32", "--bounces", "5", "--seed", "3", "--aov", "gbuffer"]


@pytest.fixture(scope="module")
def cli_pt_runs(tmp_path_factory):
    """One pt-mode render with the G-buffer AOVs through each CLI."""
    out = tmp_path_factory.mktemp("pt")
    assert jax_cli.main([*PT_ARGS, "--out", str(out / "jax")]) == 0
    assert cli.main([*PT_ARGS, "--renderer", "plain", "--out", str(out / "port")]) == 0
    return out / "jax", out / "port"


@pytest.mark.parametrize("name", ["rays.bin", "spheres.bin"])
def test_cli_pt_inputs_byte_identical_to_jax_cli(cli_pt_runs, name):
    """pt mode defaults to smallpt9 and writes the same rays and spheres."""
    jx, port = cli_pt_runs
    assert (port / name).read_bytes() == (jx / name).read_bytes()
    assert io.read_spheres_bin(str(port / "spheres.bin")).n_spheres == 9


def test_cli_pt_image_mean_within_monte_carlo_error_of_jax_cli(cli_pt_runs):
    """The two CLIs draw different random streams (threefry vs Philox):
    the per-sample means agree within 4 standard errors."""
    jx, port = cli_pt_runs
    a = io.read_color_bin(str(jx / "color.bin")).mean(1)
    b = io.read_color_bin(str(port / "color.bin")).mean(1)
    assert a.shape == b.shape == (32 * 32 * 4,) and np.isfinite(b).all()
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 4 * se


@pytest.mark.parametrize("name,share", [("albedo.ppm", 1.0), ("depth.ppm", 0.99),
                                        ("normal.ppm", 0.85)])
def test_cli_gbuffer_ppms_match_jax_cli(cli_pt_runs, name, share):
    """The AOV images equal the JAX CLI's pixel for pixel where no
    rounding enters (albedo: every pixel).  Depth and normal are floats
    quantized to 8 bits; XLA's fused arithmetic and the port's IEEE ops
    differ in the last bit, which moves a pixel by one level where the
    value sits on a level boundary (axis-aligned wall normals map to
    255.0 exactly).  Measured: depth 99.9%, normal 88.9% of pixels equal;
    every pixel within one level."""
    jx, port = cli_pt_runs
    a = io.read_ppm(str(jx / name)).astype(int)
    b = io.read_ppm(str(port / name)).astype(int)
    assert (a == b).all(axis=-1).mean() >= share
    assert np.abs(a - b).max() <= 1


def test_cli_pt_nee_and_reference_aov_run(tmp_path, capsys):
    args = ["render", "--backend", "cpu", "--width", "8", "--height", "8",
            "--check-finite"]
    assert cli.main([*args, "--mode", "pt", "--renderer", "plain", "--nee",
                     "--out", str(tmp_path / "nee")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["mode"] == "pt" and stats["scene"] == "smallpt9"
    assert (tmp_path / "nee" / "color.ppm").exists()
    assert cli.main([*args, "--aov", "depth", "--out", str(tmp_path / "ref")]) == 0
    assert (tmp_path / "ref" / "depth.ppm").exists()
    assert not (tmp_path / "ref" / "normal.ppm").exists()


def test_bench_pt_steps_on_the_host():
    """The bench's pt cells' steps (the bench itself needs a card)."""
    sc = scenes.smallpt9()
    step = bench.make_pt_step("kernel", True, scenes.cornell8(), device=torch.device("cpu"),
                              bounces=2, width=4, height=4, spp4=4)
    out, grads = step()
    assert out.shape == (3, 16) and grads == ()
    rays = torch.tensor(camera.generate_rays_numpy(4, 4, 1, seed=0).astype(np.float32))
    step = bench.make_pt_step("plain", False, sc, device=torch.device("cpu"), bounces=3,
                              rays=rays)
    loss, grads = step()
    assert [tuple(g.shape) for g in grads] == [(9, 3), (9, 3), (9, 3), (9,)]
    assert all(torch.isfinite(g).all() for g in grads)
