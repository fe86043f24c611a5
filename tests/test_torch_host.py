"""The port's own copies of the JAX package's NumPy host modules (config,
scenes, camera, oracle, utils.io, accel.meshes) against their originals:
equal tables, rays, oracle renders, meshes, and files byte for byte."""

import dataclasses

import numpy as np
import pytest

from ascendpathtracing_tpu import camera as jax_camera
from ascendpathtracing_tpu import config as jax_config
from ascendpathtracing_tpu import oracle as jax_oracle
from ascendpathtracing_tpu import scenes as jax_scenes
from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.utils import io as jax_io
from ascendpathtracing_tpu_torch import camera, config, oracle, scenes
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.utils import io

SCENES = ("cornell8", "smallpt9", "cornell-smalllight")


def test_config_copies():
    for name in ("REFERENCE_CONFIG", "BASELINE_CONFIG_1", "BASELINE_CONFIG_2"):
        assert (dataclasses.asdict(getattr(config, name))
                == dataclasses.asdict(getattr(jax_config, name)))
    cfg = config.RenderConfig(width=8, height=4, samples=2, mode="pt").validate()
    ref = jax_config.RenderConfig(width=8, height=4, samples=2, mode="pt").validate()
    assert (cfg.n_rays, cfg.n_pixels, cfg.rays_per_pixel) == (ref.n_rays, ref.n_pixels,
                                                              ref.rays_per_pixel)
    with pytest.raises(ValueError):
        config.RenderConfig(mode="wavefront").validate()


@pytest.mark.parametrize("name", SCENES)
def test_scene_tables_equal(name):
    a, b = scenes.get_scene(name), jax_scenes.get_scene(name)
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(a.soa10(dtype), b.soa10(dtype))
    np.testing.assert_array_equal(a.material, b.material)
    assert a.light_index == b.light_index
    assert (scenes.DIFF, scenes.SPEC, scenes.REFR) == (jax_scenes.DIFF, jax_scenes.SPEC,
                                                       jax_scenes.REFR)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_rays_numpy_equal(seed):
    got = camera.generate_rays_numpy(12, 8, 2, seed=seed)
    np.testing.assert_array_equal(got, jax_camera.generate_rays_numpy(12, 8, 2, seed=seed))
    for a, b in zip(camera.Camera().basis(12, 8), jax_camera.Camera().basis(12, 8)):
        np.testing.assert_array_equal(a, b)
    r = np.linspace(0.0, 1.999, 101)
    np.testing.assert_array_equal(camera.tent_filter(r), jax_camera.tent_filter(r))
    assert not hasattr(camera, "generate_rays_jax")


@pytest.mark.parametrize("name,dtype", [("cornell8", np.float32), ("smallpt9", np.float64)])
def test_oracle_renders_equal(name, dtype):
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0)
    a, b = scenes.get_scene(name), jax_scenes.get_scene(name)
    np.testing.assert_array_equal(
        oracle.render_reference_numpy(rays, a, bounces=5, dtype=dtype),
        jax_oracle.render_reference_numpy(rays, b, bounces=5, dtype=dtype))
    for x, y in zip(oracle.render_reference_hits_numpy(rays, a, bounces=3),
                    jax_oracle.render_reference_hits_numpy(rays, b, bounces=3)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(oracle.render_first_hit_numpy(rays, a),
                                  jax_oracle.render_first_hit_numpy(rays, b))


def test_io_files_byte_equal(tmp_path):
    rays = camera.generate_rays_numpy(8, 8, 1, seed=3)
    colors = np.random.RandomState(0).rand(rays.shape[0], 3).astype(np.float32) * 1.2
    scene = scenes.cornell8()
    for mod, d in ((io, tmp_path / "port"), (jax_io, tmp_path / "jax")):
        mod.write_rays_bin(rays, str(d / "rays.bin"))
        mod.write_spheres_bin(scene, str(d / "spheres.bin"))
        mod.write_color_bin(colors, str(d / "color.bin"))
        mod.write_render_ppm(colors, 8, 8, 1, str(d / "color.ppm"))
        mod.write_ppm(mod.decode_color(colors, 8, 8, 1), str(d / "plain.ppm"))
    for name in ("rays.bin", "spheres.bin", "color.bin", "color.ppm", "plain.ppm"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    port = tmp_path / "port"
    np.testing.assert_array_equal(io.read_rays_bin(str(port / "rays.bin")),
                                  rays.astype(np.float32))
    np.testing.assert_array_equal(io.read_color_bin(str(port / "color.bin")), colors)
    back = io.read_spheres_bin(str(port / "spheres.bin"))
    np.testing.assert_array_equal(back.soa10(), scene.soa10())
    np.testing.assert_array_equal(io.read_ppm(str(port / "color.ppm")),
                                  jax_io.read_ppm(str(port / "color.ppm")))
    np.testing.assert_array_equal(io.decode_color_hdr(colors, 8, 8, 1),
                                  jax_io.decode_color_hdr(colors, 8, 8, 1))


def test_meshes_equal(tmp_path):
    pairs = [
        (meshes.icosphere(center=(1, 2, 3), radius=2.0, subdivisions=3),
         jax_meshes.icosphere(center=(1, 2, 3), radius=2.0, subdivisions=3)),
        (meshes.cube(center=(50, 30, 60), size=25.0),
         jax_meshes.cube(center=(50, 30, 60), size=25.0)),
        (meshes.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)),
         jax_meshes.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))),
        (meshes.clustered_icospheres([((0, 0, 0), 1.0, 1), ((3, 0, 0), 0.2, 2)]),
         jax_meshes.clustered_icospheres([((0, 0, 0), 1.0, 1), ((3, 0, 0), 0.2, 2)])),
    ]
    for (va, fa), (vb, fb) in pairs:
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)
    v, f = pairs[0][0]
    np.testing.assert_array_equal(meshes.transform(v, scale=1.5, rotate_y=0.7, translate=(1, 2, 3)),
                                  jax_meshes.transform(v, scale=1.5, rotate_y=0.7,
                                                       translate=(1, 2, 3)))
    meshes.save_obj(tmp_path / "a.obj", v, f)
    jax_meshes.save_obj(tmp_path / "b.obj", v, f)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()
    # A quad face with v/vt/vn tuples and a negative index: fan-triangulated.
    (tmp_path / "q.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                    "f 1/1/1 2/2/2 3/3/3 -1\n")
    for path in (tmp_path / "a.obj", tmp_path / "q.obj"):
        got = meshes.load_obj(path)
        ref = jax_meshes.load_obj(path, native="never")
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
