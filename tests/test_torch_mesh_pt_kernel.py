"""The fused sphere+mesh path tracer of the port (ascendpathtracing_tpu_torch.
ops.mesh_pt_kernels) and its entry points on the CPU: the plain twin
against the Pallas kernel in interpret mode (zero uniforms, its u = 0
estimator) and against the JAX tests' float64 mirror of that estimator,
the unreachable-mesh identity with the sphere path tracer, the wrapper's
checks, and the CLI's and bench's mesh cells.  Tests marked ``cuda`` hold
the CUDA kernel against the twin on a card and skip without one."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera
from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu.ops import pallas_mesh_pt as jax_mpt
from ascendpathtracing_tpu.utils import io
from ascendpathtracing_tpu_torch import bench, cli, convert
from ascendpathtracing_tpu_torch.host import meshes, scenes
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import rng
from tests.test_pallas_mesh_pt import _oracle_u0
from tests.test_pallas_mesh_pt import _scene as jax_mixed_scene

W = H = 32
SPP4 = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mixed_scene():
    """tests/test_pallas_mesh_pt.py:34-45 in the port's MeshScene: an
    icosphere s2 in smallpt9 with mirror, glass and emissive faces."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=2)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2), base_scene="smallpt9")
    nf = ms.faces.shape[0]
    ms.face_material[: nf // 3] = scenes.SPEC
    ms.face_material[nf // 3: nf // 2] = scenes.REFR
    ms.face_emission[:4] = (0.0, 2.0, 0.5)
    return ms


def _jax(bounces, rr_depth, supers_per=0, cam=None):
    """The Pallas kernel in interpret mode (its PRNG becomes zeros) and
    its tables, tris_per_chunk 8."""
    planes, cb, sb, t24, mats, grid = jax_mpt.mesh_pt_tables(
        jax_mixed_scene(), tris_per_chunk=8, supers_per=supers_per)
    img = np.asarray(jax_mpt.render_pt_mesh_pallas(
        planes.astype(jnp.float32), cb, sb, t24, width=W, height=H, spp4=SPP4,
        materials=mats, bounces=bounces, rr_depth=rr_depth, tile=1024,
        interpret=True, cam=cam, **jax_mpt.pt_tables_kwargs(grid)))
    return img, (planes, cb, sb, t24, mats, grid)


def _port(tables, bounces, rr_depth, dtype=torch.float32, **kw):
    """The twin on the same tables (carried over from JAX's), zero
    uniforms."""
    planes, cb, sb, t24, mats, grid = tables
    p, c, s, ss, t = convert.mesh_tables_from_numpy(
        np.asarray(planes, np.float64), cb, sb, None, t24, dtype=dtype)
    u = torch.zeros((SPP4, ptk.n_uniforms(bounces), W * H), dtype=dtype)
    return mpt.render_pt_mesh(
        p, c, s, t, ss, materials=torch.tensor(mats, dtype=torch.int32), width=W,
        height=H, spp4=SPP4, tris_per_chunk=grid.tris_per_chunk,
        supers_per=grid.supers_per, bounces=bounces, rr_depth=rr_depth, uniforms=u,
        **kw).numpy()


@pytest.fixture(scope="module")
def jax_shallow():
    return _jax(1, 1)


@pytest.fixture(scope="module")
def jax_deep():
    return _jax(4, 2)


# ---------------------------------------------------------- the twin ----
def test_twin_matches_pallas_one_bounce(jax_shallow):
    """1 bounce, f32: equal to the Pallas interpreter within 1e-6 (equal in
    every pixel as measured)."""
    jx, tables = jax_shallow
    got = _port(tables, 1, 1)
    assert got.shape == (3, W * H) and got.max() > 0
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-6)


def test_twin_matches_pallas_deep(jax_deep):
    """4 bounces, RR from 2.  Interpret mode computes with XLA's CPU
    arithmetic, the twin op by op in IEEE float32, so a path can flip at a
    near-tie and differ from then on: >= 99% of pixels within 1e-4
    relative (99.9% measured, 98.9% bitwise) and the means within 1e-5
    relative."""
    jx, tables = jax_deep
    got = _port(tables, 4, 2)
    assert np.isfinite(got).all()
    assert (np.abs(got - jx) <= 1e-4 * np.abs(jx)).mean() >= 0.99
    assert abs(got.mean() - jx.mean()) <= 1e-5 * jx.mean()


@pytest.mark.parametrize("bounces,rr_depth", [(1, 1), (4, 2)])
def test_twin_float64_matches_the_u0_oracle(jax_shallow, jax_deep, bounces, rr_depth):
    """float64 twin against the JAX tests' float64 mirror _oracle_u0.  1
    bounce: equal to 1e-12 relative (bitwise as measured).  4 bounces: the
    mirror's origin offset is float32 math (max(f32 eps, f32 1e-6 *
    sqrt(f32 r2))), the twin's float64, so some trails part: >= 95% of
    pixels within 1e-9 relative (97.7% measured) and the medians within
    1e-3 (the JAX deep test's gate)."""
    tables = (jax_shallow if bounces == 1 else jax_deep)[1]
    got = _port(tables, bounces, rr_depth, dtype=torch.float64)
    exp = _oracle_u0(jax_mixed_scene(), np.asarray(tables[3]), tables[4], W, H, SPP4,
                     bounces, rr_depth)
    close = np.abs(got - exp) <= 1e-9 * np.abs(exp)
    if bounces == 1:
        np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)
    else:
        assert close.mean() >= 0.95, close.mean()
        assert abs(np.median(got) - np.median(exp)) < 1e-3


def test_twin_with_camera_and_supers_matches_pallas():
    """A non-default 11-float camera and a 2-level grid (supers of 4
    chunks), 2 bounces: equal to the Pallas interpreter within 1e-5 on
    >= 99% of pixels (every pixel as measured, 99.8% bitwise), means
    within 1e-6 (equal as measured)."""
    pos, d0, cx, cy = camera.Camera().basis(W, H)
    cam = np.asarray([pos[0] + 3.0, pos[1] - 2.0, pos[2], d0[0] + 0.02, d0[1], d0[2],
                      cx[0] * 0.9, cy[0], cy[1] * 0.9, cy[2], camera.ORIGIN_PUSH],
                     np.float32)
    jx, tables = _jax(2, 2, supers_per=4, cam=cam)
    assert tables[5].n_supers == 10
    got = _port(tables, 2, 2, cam=cam.tolist())
    default = _port(tables, 2, 2)
    assert not np.array_equal(got, default)
    assert (np.abs(got - jx) <= 1e-5 * np.abs(jx)).mean() >= 0.99
    assert abs(got.mean() - jx.mean()) <= 1e-6 * jx.mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unreachable_mesh_gives_the_sphere_path_tracer_bitwise(dtype):
    """A cube behind the front wall: no path reaches it, so the image is
    render_pt's bit for bit (same camera, Philox stream and shading)."""
    v, f = meshes.cube(center=(50, 40, 250), size=25.0)
    ms = mm.MeshScene.cornell_with_mesh(v, f, base_scene="smallpt9")
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(ms, dtype=dtype)
    kw = dict(width=24, height=20, spp4=8, bounces=6, rr_depth=2, seed=3)
    img = mpt.render_pt_mesh(planes, cb, sb, t24, materials=mats, **kw,
                             **mpt.pt_tables_kwargs(grid))
    assert torch.equal(img, ptk.render_pt_plain(planes, mats, **kw))


def test_twin_stream_is_the_philox_uniforms():
    """uniforms=None draws the fused stream (pixel, layer, block, 0): the
    same numbers passed in give the same image; another seed another."""
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), tris_per_chunk=8)
    kw = dict(materials=mats, width=8, height=6, spp4=8, bounces=4, rr_depth=2,
              **mpt.pt_tables_kwargs(grid))
    pix = torch.arange(8 * 6)
    u = torch.stack([rng.uniforms(5, pix, a, ptk.n_uniforms(4), stream=rng.STREAM_FUSED,
                                  dtype=torch.float32) for a in range(8)])
    img = mpt.render_pt_mesh(planes, cb, sb, t24, seed=5, **kw)
    assert torch.equal(img, mpt.render_pt_mesh(planes, cb, sb, t24, uniforms=u, **kw))
    assert not torch.equal(img, mpt.render_pt_mesh(planes, cb, sb, t24, seed=6, **kw))
    assert torch.isfinite(img).all() and float(img.min()) >= 0


def test_tables_equal_jax_mesh_pt_tables():
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene())
    ref = jax_mpt.mesh_pt_tables(jax_mixed_scene())
    np.testing.assert_array_equal(planes.numpy(), np.asarray(ref[0]))
    for a, b in zip((cb, sb, t24), ref[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(mats.tolist()) == ref[4]
    assert mpt.pt_tables_kwargs(grid) == dict(tris_per_chunk=16, supers_per=0)


def test_cpu_tensors_run_the_twin_without_counting():
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), tris_per_chunk=8)
    mpt.reset_launches()
    mpt.render_pt_mesh(planes, cb, sb, t24, materials=mats, width=4, height=4, spp4=4,
                       bounces=2, **mpt.pt_tables_kwargs(grid))
    assert mpt.LAUNCHES == {"mesh_pt": 0}


@pytest.mark.parametrize(
    "change,exc",
    [
        (dict(planes=torch.zeros(10, 17)), ValueError),  # S > MAX_S
        (dict(mats=torch.zeros(9, dtype=torch.int64)), TypeError),
        (dict(spp4=6), ValueError),
        (dict(t24=torch.zeros(320, 13)), ValueError),  # 13-float rows
        (dict(cb=torch.zeros(40, 6, dtype=torch.float64)), TypeError),
        (dict(sb=torch.zeros(3, 6), supers_per=4), ValueError),  # 3 x 4 != 40 chunks
        (dict(tris_per_chunk=4), ValueError),  # rows != C * T
        (dict(cam=(1.0, 2.0)), ValueError),  # not 11 floats
        (dict(uniforms=torch.zeros(4, 3, 16)), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(change, exc):
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(_mixed_scene(), tris_per_chunk=8)
    kw = dict(planes=planes, mats=mats, cb=cb, sb=sb, t24=t24, width=4, height=4, spp4=4,
              tris_per_chunk=8, supers_per=0, cam=None, uniforms=None)
    kw.update(change)
    with pytest.raises(exc):
        mpt.render_pt_mesh(kw.pop("planes"), kw.pop("cb"), kw.pop("sb"), kw.pop("t24"),
                           materials=kw.pop("mats"), bounces=2, **kw)


# ------------------------------------------------------ entry points ----
MESH_ARGS = ["render", "--scene", "mesh-cube", "--mode", "pt", "--backend", "cpu",
             "--width", "32", "--height", "32", "--samples", "2", "--bounces", "4",
             "--seed", "1"]


@pytest.fixture(scope="module")
def cli_mesh_runs(tmp_path_factory):
    """One mesh-cube render through each CLI (the JAX CLI's CPU path is
    its jit mesh renderer)."""
    out = tmp_path_factory.mktemp("mesh")
    assert jax_cli.main([*MESH_ARGS, "--renderer", "pallas", "--out", str(out / "jax")]) == 0
    assert cli.main([*MESH_ARGS, "--renderer", "kernel", "--out", str(out / "port")]) == 0
    return out / "jax", out / "port"


@pytest.mark.parametrize("name", ["rays.bin", "spheres.bin"])
def test_cli_mesh_inputs_byte_identical_to_jax_cli(cli_mesh_runs, name):
    jx, port = cli_mesh_runs
    assert (port / name).read_bytes() == (jx / name).read_bytes()


def test_cli_mesh_colors_have_the_jax_layout(cli_mesh_runs):
    """color.bin holds [W*H*4*s, 3], each pixel's mean repeated over its
    8 slots; the image's mean is within 4 standard errors of the JAX
    CLI's (different random streams)."""
    jx, port = cli_mesh_runs
    a = io.read_color_bin(str(jx / "color.bin"))
    b = io.read_color_bin(str(port / "color.bin"))
    assert a.shape == b.shape == (32 * 32 * 8, 3) and np.isfinite(b).all()
    slots = b.reshape(32 * 32, 8, 3)
    assert (slots == slots[:, :1]).all()
    assert io.read_ppm(str(port / "color.ppm")).shape == io.read_ppm(str(jx / "color.ppm")).shape
    am, bm = a.mean(1), slots[:, 0].mean(1)
    se = np.sqrt(am.var() / am.size + bm.var() / bm.size)
    assert abs(am.mean() - bm.mean()) < 4 * se


def test_cli_mesh_obj_and_refusals(tmp_path, capsys):
    v, f = meshes.icosphere(subdivisions=1)
    meshes.save_obj(tmp_path / "m.obj", v, f)
    args = ["render", "--mode", "pt", "--backend", "cpu", "--width", "8", "--height", "8",
            "--bounces", "2", "--check-finite"]
    assert cli.main([*args, "--scene", f"mesh-obj:{tmp_path / 'm.obj'}",
                     "--out", str(tmp_path / "obj")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["scene"].startswith("mesh-obj:") and stats["renderer"] == "kernel"
    for argv, message in (
        (["render", "--scene", "mesh-cube"], "mesh scenes require --mode pt"),
        ([*args, "--scene", "mesh-torus"], "unknown mesh scene"),
        ([*args, "--scene", f"mesh-obj:{tmp_path / 'none.obj'}"], "error"),
    ):
        assert cli.main([*argv, "--backend", "cpu", "--out", str(tmp_path / "x")]) == 2
        assert message in capsys.readouterr().err
    assert not (tmp_path / "x" / "color.bin").exists()


def test_bench_mesh_steps_on_the_host():
    """The bench's mesh cell step (the bench itself needs a card)."""
    ms = bench.mesh_scene(1)
    step, grid = bench.make_mesh_step("kernel", ms, device=torch.device("cpu"), bounces=2,
                                      width=4, height=4, spp4=4)
    out, grads = step()
    assert out.shape == (3, 16) and grads == () and grid.n_chunks == 5
    plain, _ = bench.make_mesh_step("plain", ms, device=torch.device("cpu"), bounces=2,
                                    width=4, height=4, spp4=4)
    assert torch.equal(plain()[0], out)


# ------------------------------------------------------- on a card ----
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_twin(cuda, dtype):
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
