"""The port's wavefront renderers (``ascendpathtracing_tpu_torch/models/
wavefront.py``) against the JAX package's (``ascendpathtracing_tpu/models/
wavefront.py``) and against the port's bounce-loop estimators, on the CPU
at small sizes.

- The camera rays of a sample index, with JAX's threefry jitter injected,
  equal JAX's.
- float64: each sample's path is a pure function of its index, so the
  wavefront's image equals the per-pixel means of ``render_pt_impl``
  (``render_pt_mesh_impl``) on the wavefront's own camera rays for every
  pool size, compaction, coherence sort and sort_every, at rtol 1e-12 (the
  two sum a pixel's samples in other orders).  Those estimators are held
  against the JAX package's in ``test_torch_pt.py`` and
  ``test_torch_mesh_render.py``.
- float32 with JAX's camera and per-iteration draws injected, the port
  traces JAX's schedule: the images agree pixel by pixel.
- The gates of ``tests/test_wavefront.py``, mirrored at its sizes, port
  against JAX.
- The CLI's ``--renderer wavefront`` against the JAX CLI's.
"""

import contextlib
import io as pyio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera as jcamera
from ascendpathtracing_tpu import cli as jax_cli
from ascendpathtracing_tpu import scenes as jscenes
from ascendpathtracing_tpu.accel import meshes as jmeshes
from ascendpathtracing_tpu.models import megakernel as jmk
from ascendpathtracing_tpu.models import mesh as jmm
from ascendpathtracing_tpu.models import wavefront as jwf
from ascendpathtracing_tpu_torch import bench, cli, scenes
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.camera import Camera
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.models import wavefront as wf
from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk
from ascendpathtracing_tpu_torch.utils import io
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

F64 = torch.float64


def _cube_scene(jax_side=False):
    """tests/test_wavefront.py's mesh scene: a 30-unit cube in smallpt9."""
    lib, mod = (jmeshes, jmm) if jax_side else (meshes, mm)
    v, f = lib.cube(center=(50, 30, 60), size=30.0)
    return mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))


def _camera_rays(w, h, spp4, seed, dtype=F64):
    """The wavefront's own camera rays of samples 0..total-1, [N, 6]."""
    o3, d3, _, _ = wf._sample_camera_rays(torch.arange(w * h * spp4), w, h, spp4, seed,
                                          Camera(), dtype)
    return torch.stack([*o3, *d3], dim=1)


def _pixel_means(colors, w, h, spp4):
    return colors.reshape(w * h, spp4, 3).mean(dim=1)


def _jax_draws(key, total, pool, iterations):
    """JAX's draws: the camera jitter of each sample index
    (wavefront.py:55-58) and the per-iteration bounce uniforms
    (wavefront.py:142-143), as torch tensors."""
    bits = jax.random.fold_in(key, 0)
    cam = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(bits, i), (2,),
                                                dtype=jnp.float32))(jnp.arange(total))
    draws = np.zeros((iterations, 3, pool), np.float32)
    for it in range(iterations):
        key, k1 = jax.random.split(key)
        draws[it] = np.asarray(jax.random.uniform(k1, (3, pool), dtype=jnp.float32))
    return torch.tensor(np.asarray(cam)), torch.tensor(draws)


def _corr(a, b):
    return np.corrcoef(np.asarray(a).reshape(-1), np.asarray(b).reshape(-1))[0, 1]


# ------------------------------------------------------------ camera ----
@pytest.mark.parametrize("w,h,spp4", [(8, 6, 8), (5, 7, 4)])
def test_sample_camera_rays_match_jax(w, h, spp4):
    """JAX's threefry jitter injected: pixel and sample-in-pixel equal,
    origins and directions within 1e-6 (float32: the tent filter's sqrt
    and rsqrt of two libraries; measured <= 2.4e-7 relative)."""
    total = w * h * spp4
    key = jax.random.PRNGKey(3)
    cam_u, _ = _jax_draws(key, total, 1, 0)
    jo, jd, jp, js = jwf._sample_camera_rays(jnp.arange(total), w, h, spp4, key,
                                             jcamera.Camera(), jnp.float32)
    o3, d3, pixel, sip = wf._sample_camera_rays(torch.arange(total), w, h, spp4, 0, Camera(),
                                                torch.float32, uniforms=cam_u)
    np.testing.assert_array_equal(pixel.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(sip.numpy(), np.asarray(js))
    for a, b in zip((*jo, *jd), (*o3, *d3)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    # the layout of camera.generate_rays_numpy: a pixel's samples contiguous
    np.testing.assert_array_equal(pixel.numpy(), np.repeat(np.arange(w * h), spp4))


def test_camera_stream_is_keyed_by_sample_index():
    """Any subset of sample indices gets the rays it gets in the full set."""
    full = _camera_rays(6, 5, 8, seed=9)
    sub = torch.tensor([239, 0, 17, 17, 100])
    o3, d3, _, _ = wf._sample_camera_rays(sub, 6, 5, 8, 9, Camera(), F64)
    assert torch.equal(torch.stack([*o3, *d3], dim=1), full[sub])


# --------------------------------------------- float64 vs bounce loop ----
@pytest.mark.parametrize("name", ["cornell8", "smallpt9"])
@pytest.mark.parametrize("bounces", [3, 8])
@pytest.mark.parametrize("pool,compact", [(256, True), (1000, True), (1024, False),
                                          (1500, True)])
def test_wavefront_equals_render_pt_impl_f64(name, bounces, pool, compact):
    w, h, spp4, seed = 8, 8, 16, 3
    sc = megakernel.scene_to_device(scenes.get_scene(name), dtype=F64)
    ref = _pixel_means(megakernel.render_pt_impl(_camera_rays(w, h, spp4, seed), sc,
                                                 bounces=bounces, rr_depth=2, seed=seed),
                       w, h, spp4)
    img = wf.render_wavefront(seed, sc, width=w, height=h, spp4=spp4, pool=pool,
                              bounces=bounces, rr_depth=2, compact=compact, dtype=F64)
    assert img.shape == (w * h, 3) and img.dtype == F64
    torch.testing.assert_close(img, ref, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("coherence_sort", [True, False])
@pytest.mark.parametrize("sort_every", [1, 2, 3])
@pytest.mark.parametrize("pool", [256, 1000, 2048])
def test_wavefront_mesh_equals_render_pt_mesh_impl_f64(coherence_sort, sort_every, pool):
    """Brute force; pools that are not multiples of 2,048 (the JAX
    package's TPU tile) included."""
    w, h, spp4, seed = 8, 8, 16, 5
    dev = mm.mesh_scene_to_device(_cube_scene(), dtype=F64, use_bvh=False)
    ref = _pixel_means(mm.render_pt_mesh(_camera_rays(w, h, spp4, seed), dev, bounces=8,
                                         rr_depth=2, seed=seed), w, h, spp4)
    img = wf.render_wavefront_mesh(seed, dev, width=w, height=h, spp4=spp4, pool=pool,
                                   bounces=8, rr_depth=2, coherence_sort=coherence_sort,
                                   sort_every=sort_every, dtype=F64)
    torch.testing.assert_close(img, ref, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("kw", [dict(use_bvh=True),
                                dict(pallas_bvh_kernel=True, tris_per_chunk=8),
                                dict(pallas_bvh_kernel=True, pallas_kernel="lockstep")],
                         ids=["jnp", "chunks", "lockstep"])
def test_wavefront_mesh_traversals_equal_their_bounce_loops_f64(kw):
    """jnp walk, the chunk kernel's twin (with its winners' shading
    planes) and the BVH kernel's twin: the same render as the bounce loop
    over the same tables."""
    w, h, spp4, seed = 8, 8, 16, 6
    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=2)
    dev = mm.mesh_scene_to_device(mm.MeshScene.cornell_with_mesh(v, f), dtype=F64, **kw)
    ref = _pixel_means(mm.render_pt_mesh(_camera_rays(w, h, spp4, seed), dev, bounces=6,
                                         rr_depth=3, seed=seed), w, h, spp4)
    img = wf.render_wavefront_mesh(seed, dev, width=w, height=h, spp4=spp4, pool=333,
                                   bounces=6, rr_depth=3, dtype=F64)
    torch.testing.assert_close(img, ref, rtol=1e-12, atol=0.0)


def test_wavefront_mesh_chunks_vs_brute_f64():
    """The chunk grid's traversal takes float32 rays and its triangle test
    is not watertight (the reference's fault 4), so its hit points differ
    from brute force's float64 ones in the last float32 bits: every pixel
    within rtol 1e-5 (measured: all within 1e-6, ~90% bitwise)."""
    w = h = 16
    spp4 = 16
    ms = _cube_scene()
    imgs = [wf.render_wavefront_mesh(4, mm.mesh_scene_to_device(ms, dtype=F64, **kw),
                                     width=w, height=h, spp4=spp4, pool=1024, bounces=8,
                                     rr_depth=2, dtype=F64)
            for kw in (dict(use_bvh=False), dict(pallas_bvh_kernel=True, tris_per_chunk=8))]
    close = ((imgs[1] - imgs[0]).abs() <= 1e-5 * imgs[0].abs()).all(dim=1)
    assert float(close.float().mean()) >= 0.9999


# ----------------------------------------- float32, JAX's schedule ----
@pytest.mark.parametrize("bounces,compact", [(2, True), (3, True), (3, False)])
def test_wavefront_traces_the_jax_schedule(bounces, compact):
    """JAX's camera and per-iteration draws injected: the same schedule,
    so the same image but for the last bits of two libraries' float32
    arithmetic.  A differing bit can end a ray one iteration earlier and
    shift every later slot (a cascade), hence few bounces (no RR) and a
    share: >= 98% of the 64 pixels within rtol 1e-4 (measured 100% at 1-3
    bounces; 98.4% at 5)."""
    w, h, spp4 = 8, 8, 16
    total = w * h * spp4
    pool = 256 if compact else total
    key = jax.random.PRNGKey(1)
    a = np.asarray(jwf.render_wavefront(key, jmk.scene_to_device(jscenes.cornell8()), width=w,
                                        height=h, spp4=spp4, pool=pool, bounces=bounces,
                                        compact=compact))
    b = wf.render_wavefront(0, megakernel.scene_to_device(scenes.cornell8()), width=w,
                            height=h, spp4=spp4, pool=pool, bounces=bounces, compact=compact,
                            uniforms=_jax_draws(key, total, pool, 64)).numpy()
    assert b.dtype == np.float32 and a.shape == b.shape
    share = np.isclose(b, a, rtol=1e-4, atol=1e-6).all(axis=1).mean()
    assert share >= 0.98, share


def test_wavefront_mesh_traces_the_jax_schedule():
    """The same for the mesh (brute force, no coherence sort: the JAX
    package sorts the same keys, but ties would add a second source of
    slot shifts)."""
    w, h, spp4, pool = 8, 8, 32, 2048
    key = jax.random.PRNGKey(7)
    jdev = jmm.mesh_scene_to_device(_cube_scene(jax_side=True), use_bvh=False)
    a = np.asarray(jwf.render_wavefront_mesh(key, jdev, width=w, height=h, spp4=spp4,
                                             pool=pool, bounces=3, coherence_sort=False))
    dev = mm.mesh_scene_to_device(_cube_scene(), use_bvh=False)
    b = wf.render_wavefront_mesh(0, dev, width=w, height=h, spp4=spp4, pool=pool, bounces=3,
                                 coherence_sort=False,
                                 uniforms=_jax_draws(key, w * h * spp4, pool, 64)).numpy()
    share = np.isclose(b, a, rtol=1e-4, atol=1e-6).all(axis=1).mean()
    assert share >= 0.98, share


def test_too_few_injected_draws_raise():
    with pytest.raises(ValueError, match="iterations of draws"):
        wf.render_wavefront(0, megakernel.scene_to_device(scenes.cornell8()), width=4,
                            height=4, spp4=4, pool=64, bounces=3,
                            uniforms=(torch.zeros((64, 2)), torch.zeros((1, 3, 64))))


def test_refusals():
    sc = megakernel.scene_to_device(scenes.cornell8())
    with pytest.raises(ValueError, match="compact=False"):
        wf.render_wavefront(0, sc, width=4, height=4, spp4=4, pool=63, compact=False)
    with pytest.raises(ValueError, match="sort_every"):
        wf.render_wavefront_mesh(0, mm.mesh_scene_to_device(_cube_scene(), use_bvh=False),
                                 width=4, height=4, spp4=4, pool=64, sort_every=0)


# ------------------------------- tests/test_wavefront.py, mirrored ----
def _jax_pixel_means_pt(key, w, h, spp4, bounces):
    rays = jcamera.generate_rays_numpy(w, h, spp4 // 4, seed=0).astype(np.float32)
    img = np.asarray(jmk.render_pt(key, jnp.asarray(rays), jmk.scene_to_device(
        jscenes.cornell8()), bounces=bounces))
    return img.reshape(w * h, spp4, 3).mean(1)


@pytest.mark.parametrize("pool,compact", [(100, True), (512, False)])
def test_iterations_stat_counts_the_pool_loop(monkeypatch, pool, compact):
    """STATS holds the last render's iterations: one image scatter each;
    without compaction the loop ends when the longest path does."""
    calls = []
    scatter = hk.segment_rows_matmul
    monkeypatch.setattr(hk, "segment_rows_matmul",
                        lambda *a, **kw: calls.append(1) or scatter(*a, **kw))
    sc = megakernel.scene_to_device(scenes.cornell8())
    wf.render_wavefront(0, sc, width=8, height=8, spp4=8, pool=pool, bounces=4,
                        compact=compact)
    assert wf.STATS["iterations"] == len(calls) > 0
    if not compact:
        assert len(calls) <= 4
    else:
        assert len(calls) >= 8 * 8 * 8 // pool


def test_wavefront_deterministic():
    sc = megakernel.scene_to_device(scenes.smallpt9())
    kw = dict(width=8, height=8, spp4=8, pool=256, bounces=4)
    a = wf.render_wavefront(0, sc, **kw).numpy()
    np.testing.assert_array_equal(a, wf.render_wavefront(0, sc, **kw).numpy())
    assert np.isfinite(a).all() and a.max() > 0.1


def test_wavefront_pool_size_consistency():
    """Pool 256 and 2,048 schedule the same sample stream: the port's two
    images agree to rounding (its draws follow the sample).  The JAX test
    correlates two images of the same camera jitter and other bounce
    draws; so does this one, the port's pool 256 on JAX's jitter (its own
    bounce stream) against JAX's pool 2,048.  (With the port's own jitter
    too, 8x8 x 32 samples correlate at ~0.87.)"""
    sc = megakernel.scene_to_device(scenes.cornell8())
    kw = dict(width=8, height=8, spp4=32, bounces=4)
    a = wf.render_wavefront(1, sc, pool=256, **kw).numpy()
    b = wf.render_wavefront(1, sc, pool=2048, **kw).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    key = jax.random.PRNGKey(1)
    j = np.asarray(jwf.render_wavefront(key, jmk.scene_to_device(jscenes.cornell8()),
                                        pool=2048, **kw))
    cam_u, _ = _jax_draws(key, 8 * 8 * 32, 1, 0)
    c = wf.render_wavefront(1, sc, pool=256, uniforms=(cam_u, None), **kw).numpy()
    assert _corr(c, j) > 0.95


def test_wavefront_matches_megakernel_statistically():
    w = h = 8
    spp4 = 256
    a = wf.render_wavefront(2, megakernel.scene_to_device(scenes.cornell8()), width=w,
                            height=h, spp4=spp4, pool=4096, bounces=5).numpy()
    b = _jax_pixel_means_pt(jax.random.PRNGKey(3), w, h, spp4, 5)
    assert _corr(a, b) > 0.96
    assert 0.85 < a.mean() / max(b.mean(), 1e-9) < 1.15


def test_wavefront_no_compaction_path():
    sc = megakernel.scene_to_device(scenes.cornell8())
    kw = dict(width=8, height=8, spp4=4, pool=256, bounces=3)
    a = wf.render_wavefront(4, sc, compact=False, **kw).numpy()
    assert np.isfinite(a).all() and a.max() > 0.1
    np.testing.assert_allclose(a, wf.render_wavefront(4, sc, **kw).numpy(), rtol=1e-6)


def test_wavefront_mesh_matches_pt_mesh_statistically():
    w = h = 16
    spp4 = 64
    a = wf.render_wavefront_mesh(2, mm.mesh_scene_to_device(_cube_scene(), use_bvh=False),
                                 width=w, height=h, spp4=spp4, pool=4096, bounces=5).numpy()
    rays = jcamera.generate_rays_numpy(w, h, spp4 // 4, seed=0).astype(np.float32)
    b = np.asarray(jmm.render_pt_mesh(
        jax.random.PRNGKey(3), jnp.asarray(rays),
        jmm.mesh_scene_to_device(_cube_scene(jax_side=True), use_bvh=False), bounces=5,
    )).reshape(w * h, spp4, 3).mean(1)
    assert np.isfinite(a).all()
    assert _corr(a, b) > 0.93
    assert 0.85 < a.mean() / max(b.mean(), 1e-9) < 1.15


@pytest.fixture(scope="module")
def jax_mesh_8x8():
    """JAX's mesh wavefront at tests/test_wavefront.py's 8x8 x 32 cell."""
    jdev = jmm.mesh_scene_to_device(_cube_scene(jax_side=True), use_bvh=False)
    return np.asarray(jwf.render_wavefront_mesh(jax.random.PRNGKey(7), jdev, width=8,
                                                height=8, spp4=32, pool=2048, bounces=4))


def test_wavefront_mesh_pool_size_consistency(jax_mesh_8x8):
    dev = mm.mesh_scene_to_device(_cube_scene(), use_bvh=False)
    imgs = [wf.render_wavefront_mesh(7, dev, width=8, height=8, spp4=32, pool=pool,
                                     bounces=4).numpy() for pool in (2048, 4096)]
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-6, atol=0)
    for img in imgs:
        assert 0.8 < img.mean() / max(jax_mesh_8x8.mean(), 1e-9) < 1.25


def test_wavefront_mesh_sort_every_energy_invariant(jax_mesh_8x8):
    dev = mm.mesh_scene_to_device(_cube_scene(), use_bvh=False)
    imgs = [wf.render_wavefront_mesh(7, dev, width=8, height=8, spp4=32, pool=2048, bounces=4,
                                     sort_every=se).numpy() for se in (1, 2, 3)]
    for img in imgs[1:]:
        np.testing.assert_allclose(img, imgs[0], rtol=1e-6, atol=0)
    for img in imgs:
        assert 0.8 < img.mean() / max(jax_mesh_8x8.mean(), 1e-9) < 1.25


# -------------------------------------------------- entry points ----
WF_ARGS = ["render", "--renderer", "wavefront", "--mode", "pt", "--backend", "cpu",
           "--width", "16", "--height", "16", "--samples", "2", "--bounces", "4",
           "--seed", "1", "--clamp", "8", "--denoise", "1", "--tonemap", "aces"]
CLI_SCENES = ["smallpt9", "mesh-cube"]


@pytest.fixture(scope="module")
def cli_wavefront_runs(tmp_path_factory):
    """One wavefront render of each scene through each CLI -> {scene:
    {"jax"|"port": (out dir, JSON line)}}."""
    out = tmp_path_factory.mktemp("wavefront")
    runs = {}
    for scene in CLI_SCENES:
        for who, main in (("jax", jax_cli.main), ("port", cli.main)):
            d = out / scene / who
            buf = pyio.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main([*WF_ARGS, "--scene", scene, "--out", str(d)]) == 0
            runs.setdefault(scene, {})[who] = (d, json.loads(buf.getvalue().splitlines()[-1]))
    return runs


@pytest.mark.parametrize("scene", CLI_SCENES)
def test_cli_wavefront_has_the_jax_layout(cli_wavefront_runs, scene):
    """The same files and JSON keys as the JAX CLI; rays.bin and
    spheres.bin byte for byte; color.bin [W*H*4*s, 3] with each pixel's
    mean repeated over its 8 slots, its mean within 4 standard errors of
    JAX's (different random streams); final.ppm written."""
    (jd, jline), (pd, pline) = cli_wavefront_runs[scene]["jax"], cli_wavefront_runs[scene]["port"]
    assert set(pline) == set(jline) and pline["renderer"] == "wavefront"
    assert sorted(p.name for p in pd.iterdir()) == sorted(p.name for p in jd.iterdir())
    for name in ("rays.bin", "spheres.bin"):
        assert (pd / name).read_bytes() == (jd / name).read_bytes()
    a = io.read_color_bin(str(jd / "color.bin"))
    b = io.read_color_bin(str(pd / "color.bin"))
    assert a.shape == b.shape == (16 * 16 * 8, 3) and np.isfinite(b).all()
    slots = b.reshape(16 * 16, 8, 3)
    assert (slots == slots[:, :1]).all()
    am, bm = a.reshape(16 * 16, 8, 3)[:, 0].mean(1), slots[:, 0].mean(1)
    se = np.sqrt(am.var() / am.size + bm.var() / bm.size)
    assert abs(am.mean() - bm.mean()) < 4 * se
    for name in ("color.ppm", "final.ppm"):
        assert io.read_ppm(str(pd / name)).shape == io.read_ppm(str(jd / name)).shape


@pytest.mark.parametrize("argv,message", [
    ([], "--renderer wavefront is a path-tracing renderer (use --mode pt)"),
    (["--scene", "mesh-cube"], "mesh scenes require --mode pt"),
])
def test_cli_wavefront_refuses_reference_mode_as_jax(argv, message, tmp_path, capsys):
    args = ["render", "--renderer", "wavefront", "--backend", "cpu", *argv]
    assert jax_cli.main([*args, "--out", str(tmp_path / "jax")]) == 2
    assert message in capsys.readouterr().err
    assert cli.main([*args, "--out", str(tmp_path / "port")]) == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "port" / "color.bin").exists()


@pytest.mark.parametrize("mode", ["pt", "mesh"])
def test_bench_wavefront_step_on_the_host(mode):
    """The bench's wavefront cells' step (the bench itself needs a card):
    a new seed every call."""
    step = bench.make_wavefront_step(mode, device=torch.device("cpu"), bounces=3, width=8,
                                     height=8, spp4=4, pool=100, subdiv=1)
    a, grads = step()
    b, _ = step()
    assert a.shape == (64, 3) and grads == () and bool(torch.isfinite(a).all())
    assert not torch.equal(a, b)
