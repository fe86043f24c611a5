"""The port's native (C++) host library (``accel/native.py`` and
``native/*.cpp``) against the JAX package's: the BVH builder array for
array, the PPM codec byte for byte (and against the port's Python path),
the OBJ loader value for value and error for error, the sources byte for
byte, the mesh tables that take the builder by default, and the build
itself (hashed name and log under ``build/``, concurrent builders).
Tests that need g++ skip without it, as ``tests/test_native_bvh.py``
does."""

import re
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.accel import native as jax_native
from ascendpathtracing_tpu.models import mesh as jax_mesh
from ascendpathtracing_tpu.utils import io as jax_io
from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import meshes, native
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.utils import io
from tests.test_torch_mesh_render import _assert_same, _mixed_scene

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("bmin", "bmax", "first", "count", "miss", "tri_order")
MESHES = {
    "s1": lambda m: m.icosphere(subdivisions=1),
    "s2": lambda m: m.icosphere(subdivisions=2),
    "s3": lambda m: m.icosphere(subdivisions=3),
    "s4": lambda m: m.icosphere(subdivisions=4),
    "cube": lambda m: m.cube(center=(50, 30, 60), size=25.0),
    "quad": lambda m: m.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)),
}


@pytest.fixture
def toolchain():
    """Both packages' native libraries, or a skip without g++."""
    if not (native.is_available() and jax_native.is_available()):
        pytest.skip("native toolchain unavailable")


# ------------------------------------------------------------ BVH ----
@pytest.mark.parametrize("max_leaf", [4, 8, 64])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_bvh_native_equals_jax(toolchain, mesh, max_leaf):
    v, f = MESHES[mesh](meshes)
    jv, jf = MESHES[mesh](jax_meshes)
    got = native.build_bvh_native(v, f, max_leaf=max_leaf)
    ref = jax_native.build_bvh_native(jv, jf, max_leaf=max_leaf)
    assert type(got) is bvh_mod.FlatBVH and got.max_leaf == ref.max_leaf == max_leaf
    for k in FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the default route takes it too
    auto = bvh_mod.build_bvh(v, f, max_leaf=max_leaf)
    assert all(np.array_equal(getattr(auto, k), getattr(got, k)) for k in FIELDS)


@pytest.mark.parametrize("mode", ["lockstep", "jnp"])
def test_mesh_tables_equal_jax_defaults(toolchain, mode):
    """mesh_scene_to_device's tables with both packages' default BVH
    builders (native on both sides), s2, key for key."""
    kw = (dict(pallas_bvh_kernel=True, pallas_kernel="lockstep") if mode == "lockstep"
          else dict(use_bvh=True))
    got = mm.mesh_scene_to_device(_mixed_scene(mm), **kw)
    ref = jax_mesh.mesh_scene_to_device(_mixed_scene(jax_mesh), dtype=jnp.float32, **kw)
    _assert_same(got, ref)
    assert got["static"].traversal == mode


# ------------------------------------------------------------ PPM ----
@pytest.mark.parametrize("w,h,s", [(8, 8, 1), (16, 16, 2), (64, 64, 4)])
def test_encode_ppm_native_byte_equal(toolchain, w, h, s):
    rng = np.random.RandomState(w + s)
    # values straddling the clip bounds and the digit widths
    planes = rng.rand(3, w * h * 4 * s).astype(np.float32) * 1.4 - 0.2
    text = native.encode_ppm_native(planes, w, h, s)
    assert text == jax_native.encode_ppm_native(planes, w, h, s)
    assert text == io.encode_ppm(io.decode_color(planes, w, h, s))


def test_write_render_ppm_native_modes(toolchain, tmp_path):
    """auto, always and never write the same bytes as the JAX package's
    write_render_ppm and return the same image; a bad mode and a bad
    plane shape raise."""
    colors = np.random.RandomState(1).rand(16 * 16 * 4 * 2, 3).astype(np.float32)
    want = jax_io.write_render_ppm(colors, 16, 16, 2, str(tmp_path / "jax.ppm"))
    for mode in ("auto", "always", "never"):
        img = io.write_render_ppm(colors, 16, 16, 2, str(tmp_path / f"{mode}.ppm"),
                                  native=mode)
        np.testing.assert_array_equal(img, want)
        assert (tmp_path / f"{mode}.ppm").read_bytes() == (tmp_path / "jax.ppm").read_bytes()
    with pytest.raises(ValueError, match="bad native mode"):
        io.write_render_ppm(colors, 16, 16, 2, str(tmp_path / "x.ppm"), native="sometimes")
    with pytest.raises(ValueError, match="planes"):
        native.encode_ppm_native(colors.T[:, :-4], 16, 16, 2)


def test_write_render_ppm_falls_back_only_when_unavailable(monkeypatch, tmp_path):
    """"auto" takes the Python path on NativeUnavailable and nowhere
    else: a codec error propagates; "always" re-raises the
    unavailability."""
    colors = np.random.RandomState(2).rand(8 * 8 * 4, 3).astype(np.float32)

    def unavailable(*a, **k):
        raise native.NativeUnavailable("no g++")

    def broken(*a, **k):
        raise RuntimeError("apt_encode_ppm: buffer too small")

    monkeypatch.setattr(native, "encode_ppm_native", unavailable)
    img = io.write_render_ppm(colors, 8, 8, 1, str(tmp_path / "a.ppm"))
    np.testing.assert_array_equal(img, io.decode_color(colors, 8, 8, 1))
    assert (tmp_path / "a.ppm").read_text() == io.encode_ppm(img)
    with pytest.raises(native.NativeUnavailable):
        io.write_render_ppm(colors, 8, 8, 1, str(tmp_path / "b.ppm"), native="always")
    monkeypatch.setattr(native, "encode_ppm_native", broken)
    with pytest.raises(RuntimeError, match="buffer too small"):
        io.write_render_ppm(colors, 8, 8, 1, str(tmp_path / "c.ppm"))


def test_build_bvh_falls_back_only_when_unavailable(monkeypatch):
    v, f = meshes.icosphere(subdivisions=1)

    def unavailable(*a, **k):
        raise native.NativeUnavailable("no g++")

    def broken(*a, **k):
        raise RuntimeError("apt_build_bvh: node buffer too small")

    monkeypatch.setattr(native, "build_bvh_native", unavailable)
    got = bvh_mod.build_bvh(v, f)
    ref = bvh_mod.build_bvh_numpy(v, f)
    assert all(np.array_equal(getattr(got, k), getattr(ref, k)) for k in FIELDS)
    with pytest.raises(native.NativeUnavailable):
        bvh_mod.build_bvh(v, f, backend="native")
    monkeypatch.setattr(native, "build_bvh_native", broken)
    with pytest.raises(RuntimeError, match="node buffer"):
        bvh_mod.build_bvh(v, f)


# ------------------------------------------------------------ OBJ ----
def _obj_files(d):
    """tests/test_obj.py's files: an icosphere round trip, a quad with
    v/vt/vn tuples and a negative-index face, no geometry, an index out
    of range; and a malformed token."""
    v, f = meshes.icosphere(radius=1.0, subdivisions=1)
    meshes.save_obj(d / "ico.obj", v, f)
    (d / "quad.obj").write_text(
        "# a unit quad with vt/vn tuples and a negative-index triangle\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -4 -3 -2\n")
    (d / "empty.obj").write_text("# nothing\n")
    (d / "bad.obj").write_text("v 0 0 0\nf 1 2 3\n")
    (d / "token.obj").write_text("v 0 0 0\nv 1 x 0\nv 0 1 0\nf 1 2 3\n")
    return {"ico.obj": None, "quad.obj": None, "empty.obj": "no geometry",
            "bad.obj": "out of range", "token.obj": "malformed token"}


def test_load_obj_native_equals_jax(toolchain, tmp_path):
    for name, error in _obj_files(tmp_path).items():
        path = tmp_path / name
        if error is None:
            got = native.load_obj_native(path)
            ref = jax_native.load_obj_native(str(path))
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            for mode in ("auto", "always", "never"):
                v, f = meshes.load_obj(path, native=mode)
                np.testing.assert_array_equal(v, ref[0])
                np.testing.assert_array_equal(f, ref[1])
        else:
            with pytest.raises(ValueError) as got:
                native.load_obj_native(path)
            with pytest.raises(ValueError) as ref:
                jax_native.load_obj_native(path)
            assert error in str(got.value)
            assert str(got.value) == str(ref.value)
            # the Python parser: the same messages, and float()'s own one
            # on a malformed token
            with pytest.raises(ValueError, match=error if error != "malformed token"
                               else "could not convert"):
                meshes.load_obj(path, native="never")
    with pytest.raises(RuntimeError, match="apt_obj_count failed"):
        native.load_obj_native(tmp_path / "missing.obj")


# ---------------------------------------------------- the library ----
@pytest.mark.parametrize("name", native.SOURCES)
def test_sources_byte_equal_to_the_jax_package(name):
    """Byte for byte, but for one comment of obj_loader.cpp that gives
    the upstream reference's source by its checkout's absolute path; the
    port's copy gives it relative to that repository (``src/...``)."""
    ours = (REPO / "ascendpathtracing_tpu_torch" / "native" / name).read_bytes()
    theirs = (REPO / "ascendpathtracing_tpu" / "native" / name).read_bytes()
    assert ours == re.sub(rb"\S*/reference/src/", b"src/", theirs), name
    assert (ours == theirs) == (name != "obj_loader.cpp"), name


def test_library_builds_under_build_with_a_log(toolchain):
    path = native.build()
    assert path.parent == REPO / "build" / "ascendpathtracing_tpu_torch"
    assert path.name.startswith("libaptnative-") and path.exists()
    log = path.with_suffix(".log").read_text()
    assert all(flag in log for flag in native.CXX_FLAGS)
    assert all(src in log for src in native.SOURCES)
    assert "ascendpathtracing_tpu/native" not in log.replace(
        "ascendpathtracing_tpu_torch/native", "")


def test_concurrent_builders_each_see_a_whole_library(toolchain, tmp_path, monkeypatch):
    """Six threads build into an empty directory at once: each writes its
    own temporary file and renames it into place, so all return the same
    path to a library that loads."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    got, errors = [], []

    def run():
        try:
            got.append(native.build())
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(got) == 6 and len(set(got)) == 1
    import ctypes

    assert ctypes.CDLL(str(got[0])).apt_build_bvh is not None
    assert [p.name for p in (tmp_path / "build").iterdir() if ".tmp" in p.name] == []


def test_no_compiler_is_unavailable(monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-apt")
    with pytest.raises(native.NativeUnavailable, match="no C\\+\\+ compiler"):
        native.build()
