"""The bounce-loop mesh renderer of the port on the CPU (models/mesh in its
four traversal modes): the device tables against the JAX package's, the
first-hit query and ``render_pt_mesh_impl`` against the JAX versions with
the same uniforms, the Morton sort before a kernel, and the CLI's mesh
``--renderer plain`` against the JAX CLI.

The JAX package builds its BVH with its C++ builder where it loads, whose
tables differ from the NumPy builder's; so BVH-mode results are compared
over JAX's own tables carried by ``convert.mesh_dev_from_jax``, and the
tables themselves with JAX's ``build_bvh`` pointed at its NumPy builder
inside the test.  Pallas kernels run in interpret mode."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera, scenes
from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu.accel import bvh as jax_bvh
from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.models import mesh as jax_mesh
from ascendpathtracing_tpu.utils import io as jax_io
from ascendpathtracing_tpu_torch import cli, convert
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

MODES = {  # traversal -> mesh_scene_to_device arguments
    "chunks": dict(pallas_bvh_kernel=True),
    "lockstep": dict(pallas_bvh_kernel=True, pallas_kernel="lockstep"),
    "jnp": dict(use_bvh=True),
    "brute": dict(use_bvh=False),
}


def _mixed_scene(module, sub=2):
    """tests/test_pallas_mesh_pt.py:34-45's scene: icosphere s2 in
    smallpt9, a third of the faces mirrors, a sixth glass, four
    emissive."""
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=sub)
    ms = module.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2),
                                            base_scene="smallpt9")
    nf = ms.faces.shape[0]
    ms.face_material[: nf // 3] = scenes.SPEC
    ms.face_material[nf // 3: nf // 2] = scenes.REFR
    ms.face_emission[:4] = (0.0, 2.0, 0.5)
    return ms


@pytest.fixture
def numpy_builder(monkeypatch):
    """JAX's build_bvh on its NumPy builder, for this test only."""
    monkeypatch.setattr(jax_bvh, "build_bvh",
                        lambda v, f, *, max_leaf=4, backend="auto":
                        jax_bvh.build_bvh_numpy(v, f, max_leaf=max_leaf))


def _assert_same(got, ref, key=""):
    """A port table (tensor, tuple, dict, None, scalar) equals the JAX
    one: same values and dtype."""
    if ref is None:
        assert got is None, key
    elif isinstance(ref, dict):
        assert set(got) == set(ref), (key, set(got) ^ set(ref))
        for k in ref:
            _assert_same(got[k], ref[k], f"{key}.{k}")
    elif isinstance(ref, tuple) and not hasattr(ref, "_fields"):
        assert isinstance(got, tuple) and len(got) == len(ref), key
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same(a, b, f"{key}[{i}]")
    elif hasattr(ref, "_fields"):  # StaticConf
        assert tuple(got) == tuple(ref) and got._fields == ref._fields, key
    elif isinstance(ref, (int, float)):
        assert got == ref, key
    else:
        a, b = got.numpy(), np.asarray(ref)
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", list(MODES) + ["chunks_diff"])
def test_tables_equal_jax(numpy_builder, mode, dtype):
    """Every table of mesh_scene_to_device equals JAX's, key for key."""
    kw = dict(MODES.get(mode, MODES["chunks"]), diff=mode == "chunks_diff")
    got = mm.mesh_scene_to_device(_mixed_scene(mm), dtype=getattr(torch, dtype), **kw)
    ref = jax_mesh.mesh_scene_to_device(_mixed_scene(jax_mesh), dtype=jnp.dtype(dtype), **kw)
    _assert_same(got, ref)
    assert got["static"].traversal == mode.split("_")[0]


def test_max_leaf_defaults_and_bad_kernel():
    ms = _mixed_scene(mm, sub=1)
    assert mm.mesh_scene_to_device(ms, **MODES["lockstep"])["static"].max_leaf == 64
    assert mm.mesh_scene_to_device(ms, **MODES["jnp"])["static"].max_leaf == 4
    assert mm.mesh_scene_to_device(ms, max_leaf=8, **MODES["jnp"])["static"].max_leaf == 8
    with pytest.raises(ValueError):
        mm.mesh_scene_to_device(ms, pallas_bvh_kernel=True, pallas_kernel="wide")


def test_mesh_dev_from_jax_carries_every_table():
    jdev = jax_mesh.mesh_scene_to_device(_mixed_scene(jax_mesh), **MODES["lockstep"])
    got = convert.mesh_dev_from_jax(jdev)
    _assert_same(got, jdev)
    jdev = jax_mesh.mesh_scene_to_device(_mixed_scene(jax_mesh), dtype=jnp.float64,
                                         **MODES["jnp"])
    got = convert.mesh_dev_from_jax(jdev)
    _assert_same(got, jdev)
    assert got["spheres"]["r2"].dtype == torch.float64


# ---------------------------------------------------------- first hit ----
def _jax_and_port(mode, dtype, **kw):
    jdev = jax_mesh.mesh_scene_to_device(_mixed_scene(jax_mesh), dtype=jnp.dtype(dtype),
                                         **MODES[mode], **kw)
    return jdev, convert.mesh_dev_from_jax(jdev)


@pytest.mark.parametrize("mode", ["brute", "jnp"])
def test_first_hit_float64_equals_jax(mode):
    """float64, 24x24 camera rays: kind and id equal, t to 1e-12 (the jnp
    mode over JAX's own BVH tables)."""
    jdev, pdev = _jax_and_port(mode, "float64")
    rays = camera.generate_rays_numpy(24, 24, 1, seed=0)
    ref = jax_mesh.first_hit_mesh(jnp.asarray(rays), jdev)
    got = mm.first_hit_mesh(torch.tensor(rays), pdev)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-12)
    assert (got[1].numpy() == 2).sum() > 50


@pytest.mark.parametrize("mode", ["chunks", "lockstep"])
def test_first_hit_kernels_equal_jax_interpret(mode):
    """float32, 24x24 camera rays through the traversal twins vs the
    Pallas kernels in interpret mode: kind and id equal; triangle t within
    8 ulp, sphere t within 8 ulp of 1e5 (XLA's CPU arithmetic against
    op-by-op IEEE)."""
    kw = dict(max_leaf=16) if mode == "lockstep" else {}
    jdev, pdev = _jax_and_port(mode, "float32", **kw)
    rays = camera.generate_rays_numpy(24, 24, 1, seed=0).astype(np.float32)
    ref = jax_mesh.first_hit_mesh(jnp.asarray(rays), jdev)
    wk.reset_launches()
    bk.reset_launches()
    got = mm.first_hit_mesh(torch.tensor(rays), pdev)
    assert wk.LAUNCHES["wbvh"] == bk.LAUNCHES["bvh"] == 0  # CPU: the twins
    kind = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1].numpy(), kind)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    t_got, t_ref = got[0].numpy(), np.asarray(ref[0])
    tri_px = kind == 2
    assert tri_px.sum() > 50
    assert np.abs(t_got[tri_px].view(np.int32) - t_ref[tri_px].view(np.int32)).max() <= 8
    # sphere pixels: the float32 sphere quadratic cancels against b ~ r =
    # 1e5 on the walls, so XLA and IEEE part by ulps of 1e5 (4 measured)
    np.testing.assert_allclose(t_got[~tri_px], t_ref[~tri_px], rtol=0,
                               atol=8 * np.spacing(np.float32(1e5)))


@pytest.mark.parametrize("mode", ["chunks", "lockstep", "jnp"])
def test_first_hit_modes_match_brute(mode):
    """As tests/test_mesh_render.py:18-93 on the port alone, float32: each
    mode finds the same kind and the same face as brute force (through
    face_of_slot or tri_order), t to 1e-4 relative."""
    ms = _mixed_scene(mm)
    rays = torch.tensor(camera.generate_rays_numpy(24, 24, 1, seed=1).astype(np.float32))
    dev = mm.mesh_scene_to_device(ms, **MODES[mode])
    t, k, h = mm.first_hit_mesh(rays, dev)
    tb, kb, hb = mm.first_hit_mesh(rays, mm.mesh_scene_to_device(ms, use_bvh=False))
    assert torch.equal(k, kb)
    tri_px = kb == 2
    assert int(tri_px.sum()) > 50
    if mode == "chunks":
        face = dev["face_of_slot"][h[tri_px].long()]
    else:
        order = torch.tensor(mm.bvh_mod.build_bvh(ms.vertices.astype(np.float32), ms.faces,
                                                  max_leaf=dev["static"].max_leaf).tri_order)
        face = order[h[tri_px].long()]
    assert torch.equal(face.long(), hb[tri_px].long())
    np.testing.assert_allclose(t[tri_px].numpy(), tb[tri_px].numpy(), rtol=1e-4)


@pytest.mark.parametrize("mode", ["chunks", "lockstep"])
def test_mesh_hit_sorted_equals_unsorted(monkeypatch, mode):
    """tests/test_pallas_bvh.py:41-71 on the port: with _SORT_MIN_N
    lowered, sorting the rays before the kernel changes no result."""
    v, f = meshes.icosphere(subdivisions=2)
    ms = mm.MeshScene.cornell_with_mesh(v * 10 + 50, f)
    dev = mm.mesh_scene_to_device(ms, **MODES[mode])
    rng = np.random.RandomState(1)
    o = (rng.randn(4096, 3) * 20 + 50).astype(np.float32)
    d = rng.randn(4096, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o3 = tuple(torch.tensor(o[:, i]) for i in range(3))
    d3 = tuple(torch.tensor(d[:, i]) for i in range(3))
    monkeypatch.setattr(mm, "_SORT_MIN_N", 0)
    sorted_ = mm._mesh_hit(o3, d3, dev, 1e-4, sort=True)
    unsorted = mm._mesh_hit(o3, d3, dev, 1e-4, sort=False)
    assert int((~unsorted[2]).sum()) > 200
    for a, b in zip(sorted_[:3], unsorted[:3]):
        assert torch.equal(a, b)
    if mode == "chunks":
        assert all(torch.equal(a, b) for a, b in zip(sorted_[3], unsorted[3]))


def test_render_sort_per_bounce_changes_nothing(monkeypatch):
    """render_pt_mesh_impl(sort_per_bounce=True) with _SORT_MIN_N lowered:
    the same image, bit for bit, in both kernel modes."""
    ms = _mixed_scene(mm, sub=1)
    rays = torch.tensor(camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32))
    monkeypatch.setattr(mm, "_SORT_MIN_N", 0)
    for mode in ("chunks", "lockstep"):
        dev = mm.mesh_scene_to_device(ms, **MODES[mode])
        a = mm.render_pt_mesh(rays, dev, bounces=3, seed=2, sort_per_bounce=True)
        assert torch.equal(a, mm.render_pt_mesh(rays, dev, bounces=3, seed=2)), mode


# ------------------------------------------------------------- render ----
B = 4


def _uniforms(n, dtype):
    return np.random.RandomState(0).rand(B, 3, n).astype(dtype)


@pytest.mark.parametrize("mode", ["brute", "jnp"])
def test_render_float64_equals_jax(mode):
    """float64, 16x16 camera rays, 4 bounces, the same uniforms: rtol
    1e-9 (2e-15 absolute measured), over JAX's own tables."""
    jdev, pdev = _jax_and_port(mode, "float64")
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0)
    u = _uniforms(rays.shape[0], np.float64)
    ref = np.asarray(jax_mesh.render_pt_mesh(jax.random.PRNGKey(0), jnp.asarray(rays), jdev,
                                             bounces=B, uniforms=jnp.asarray(u)))
    got = mm.render_pt_mesh_impl(torch.tensor(rays), pdev, bounces=B, uniforms=torch.tensor(u))
    assert got.shape == (rays.shape[0], 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=0)
    assert ref.max() > 0.1


@pytest.mark.parametrize("mode", ["chunks", "lockstep"])
def test_render_float32_kernels_match_jax_interpret(mode):
    """float32 through the traversal twins vs the Pallas kernels in
    interpret mode, 16x16 rays, 4 bounces, the same uniforms: >= 99% of
    pixels within 1e-5 relative in every channel (99.9% measured; the one
    other ray's bounce trail parts by rounding), means within 2%."""
    kw = dict(max_leaf=16) if mode == "lockstep" else {}
    jdev, pdev = _jax_and_port(mode, "float32", **kw)
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    u = _uniforms(rays.shape[0], np.float32)
    ref = np.asarray(jax_mesh.render_pt_mesh(jax.random.PRNGKey(0), jnp.asarray(rays), jdev,
                                             bounces=B, uniforms=jnp.asarray(u)))
    got = mm.render_pt_mesh_impl(torch.tensor(rays), pdev, bounces=B,
                                 uniforms=torch.tensor(u)).numpy()
    share = (np.abs(got - ref) <= 1e-5 * np.abs(ref)).all(axis=1).mean()
    print(f"{mode} float32: {share:.2%} of pixels within 1e-5")
    assert share >= 0.99
    assert abs(got.mean() - ref.mean()) <= 0.02 * ref.mean()


def test_render_modes_agree_and_philox_stream():
    """The port alone, float32, 16x16, 4 bounces, its Philox stream (seed
    3): chunks (fast and diff), lockstep and jnp give the same image as
    brute on >= 99% of pixels (the kernels' float32 forms differ in the
    last bits); a render repeats bit for bit; another seed changes it."""
    ms = _mixed_scene(mm, sub=1)
    rays = torch.tensor(camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32))
    brute = mm.render_pt_mesh(rays, mm.mesh_scene_to_device(ms, use_bvh=False), bounces=B,
                              seed=3)
    assert bool(torch.isfinite(brute).all()) and float(brute.min()) >= 0
    for mode, extra in (("chunks", {}), ("chunks", dict(diff=True)), ("lockstep", {}),
                        ("jnp", {})):
        dev = mm.mesh_scene_to_device(ms, **MODES[mode], **extra)
        img = mm.render_pt_mesh(rays, dev, bounces=B, seed=3)
        close = ((img - brute).abs() <= 1e-4 * brute.abs() + 1e-6).all(dim=1)
        assert float(close.float().mean()) >= 0.99, (mode, extra)
        assert torch.equal(img, mm.render_pt_mesh(rays, dev, bounces=B, seed=3))
    assert not torch.equal(img, mm.render_pt_mesh(rays, dev, bounces=B, seed=4))
    with pytest.raises(ValueError):
        mm.render_pt_mesh(rays, dev, bounces=B, uniforms=torch.zeros(B, 3, 5))


def test_emissive_mesh_lights_the_box():
    """tests/test_mesh_render.py:57-71: an emissive mesh lights cornell8
    with the sphere light switched off (jnp mode)."""
    v, f = meshes.cube(center=(50, 75, 80), size=25.0)
    ms = mm.MeshScene.cornell_with_mesh(v, f, albedo=(0, 0, 0), emission=(15, 15, 15),
                                        base_scene="cornell8")
    ms.spheres.emission[:] = 0
    rays = torch.tensor(camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32))
    img = mm.render_pt_mesh(rays, mm.mesh_scene_to_device(ms), bounces=B)
    assert float(img.max()) > 0.5


# ---------------------------------------------------------------- CLI ----
def test_cli_mesh_plain_matches_jax_cli(tmp_path, capsys):
    """cli render --scene mesh-icosphere --mode pt --renderer plain on the
    CPU (the jnp BVH walk) vs the JAX CLI (its jnp walk over its own BVH)
    at --bounces 1, where no random draw reaches the image: color.bin
    within 1e-6, the other artifacts byte for byte."""
    args = ["render", "--scene", "mesh-icosphere", "--mode", "pt", "--backend", "cpu",
            "--width", "16", "--height", "16", "--samples", "2", "--bounces", "1"]
    assert cli.main([*args, "--renderer", "plain", "--out", str(tmp_path / "port")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["renderer"] == "plain" and stats["backend"] == "cpu"
    assert jax_cli.main([*args, "--out", str(tmp_path / "jax")]) == 0
    got = jax_io.read_color_bin(tmp_path / "port" / "color.bin")
    ref = jax_io.read_color_bin(tmp_path / "jax" / "color.bin")
    assert got.shape == ref.shape == (16 * 16 * 4 * 2, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (ref > 0).any(axis=1).mean() > 0.01  # the light, seen directly
    for name in ("rays.bin", "spheres.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_jax_mesh_cli_scene_is_the_ports():
    """The CLI's mesh-icosphere is the JAX CLI's (cli.py:147-166)."""
    v, f = jax_meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=3)
    got = cli._mesh_scene("icosphere")
    np.testing.assert_array_equal(got.vertices, v)
    np.testing.assert_array_equal(got.faces, f)
    np.testing.assert_array_equal(got.face_albedo[0], (0.85, 0.55, 0.2))
