"""utils/debug.py and the kernels' debug dumps in the port, against the JAX
package on the CPU: print_data's strings and assert_finite's errors equal
to JAX's, checkify_render agreeing with JAX's checkify on a clean and a
poisoned ray, and the debug dumps of the three kernel twins
(ops/pt_kernels.render_pt, ops/wbvh_kernels.intersect_chunks,
ops/mesh_pt_kernels.render_pt_mesh) against the Pallas interpreter's
kernel_dump lines on the inputs of tests/test_debug_dumps.py (the twins
take zero uniforms, the interpreter's u = 0 stream), plus cases whose
counts vary from bounce to bounce and tile to tile.  The lines are parsed
from capfd: the same number of lines, the same labels and values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import camera as jax_camera
from ascendpathtracing_tpu import scenes as jax_scenes
from ascendpathtracing_tpu.accel import meshes as jax_meshes
from ascendpathtracing_tpu.models import megakernel as jax_mk
from ascendpathtracing_tpu.models import mesh as jax_mesh
from ascendpathtracing_tpu.ops import pallas_kernels as jax_pk
from ascendpathtracing_tpu.ops import pallas_mesh_pt as jax_mpt
from ascendpathtracing_tpu.ops import pallas_wbvh as jax_wbvh
from ascendpathtracing_tpu.utils import debug as jax_dbg
from ascendpathtracing_tpu_torch import convert, scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import chunk_grid
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
from ascendpathtracing_tpu_torch.utils import debug as dbg
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

LABELS = ("pt_pallas alive", "wbvh tile worklist k", "mesh_pt worklist k", "mesh_pt alive")


def dump_lines(text: str) -> list:
    """The dump lines of captured output, as (label, value) in order."""
    out = []
    for ln in text.splitlines():
        label, _, value = ln.partition(": ")
        if label in LABELS:
            out.append((label, value))
    return out


def captured(capfd) -> list:
    return dump_lines("".join(capfd.readouterr()))


# ---------------------------------------------------------- print_data ----
@pytest.mark.parametrize("as_tensor", [False, True])
def test_print_data_string_equals_jax(capsys, as_tensor):
    arr = np.arange(20, dtype=np.float32).reshape(4, 5)
    arr[1, 1] = np.nan
    x = torch.tensor(arr) if as_tensor else arr
    msg = dbg.print_data("hit_t", x, max_items=4)
    err = capsys.readouterr().err
    assert msg == jax_dbg.print_data("hit_t", arr, max_items=4)
    assert msg in err and "finite=19/20" in msg and "0, 1, 2, 3, ..." in msg


@pytest.mark.parametrize("arr", [np.asarray([3, 1, 2], np.int32), np.zeros((0,), np.float32),
                                 np.linspace(-1.0, 1.0, 7), np.asarray([np.inf, 1.0, -2.5])])
def test_print_data_int_empty_and_float64_equal_jax(arr):
    assert dbg.print_data("x", arr) == jax_dbg.print_data("x", arr)
    assert dbg.print_data("x", torch.from_numpy(arr)) == jax_dbg.print_data("x", arr)


def test_assert_finite_raises_as_jax():
    good = np.ones((4, 3), np.float32)
    assert dbg.assert_finite(good) is good
    bad = good.copy()
    bad[0, 1], bad[2, 2] = np.nan, np.inf
    with pytest.raises(jax_dbg.NonFiniteRenderError) as ej:
        jax_dbg.assert_finite(bad, "render")
    with pytest.raises(dbg.NonFiniteRenderError) as et:
        dbg.assert_finite(torch.tensor(bad), "render")
    assert str(et.value) == str(ej.value) == "render: 2 non-finite of 12 (nan=1, inf=1)"


# ------------------------------------------------------- checkify ----
def _outcome(fn, rays):
    try:
        out = fn(rays)
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return type(e).__name__, None
    return "ok", np.asarray(out)


def test_checkify_render_agrees_with_jax_on_clean_and_poisoned_rays():
    """The JAX CLI's selftest check 7 on both packages: a clean reference
    render passes and equals the unchecked render, and a ray with a NaN
    direction component raises in both (JAX's checkify float checks, the
    port's dispatch-mode guard)."""
    rays = jax_camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    jdev = jax_mk.scene_to_device(jax_scenes.cornell8())
    tdev = megakernel.scene_to_device(scenes.cornell8())
    jfn = jax_dbg.checkify_render(lambda r: jax_mk.render_reference_impl(r, jdev, bounces=2))
    tfn = dbg.checkify_render(lambda r: megakernel.render_reference_impl(r, tdev, bounces=2))
    bad = rays.copy()
    bad[0, 3] = np.nan
    (jc, jout), (tc, tout) = _outcome(jfn, jnp.asarray(rays)), _outcome(tfn, torch.tensor(rays))
    assert jc == tc == "ok"
    np.testing.assert_array_equal(
        tout, megakernel.render_reference_impl(torch.tensor(rays), tdev, bounces=2).numpy())
    assert np.isfinite(jout).all() and np.isfinite(tout).all()
    (jc, _), (tc, _) = _outcome(jfn, jnp.asarray(bad)), _outcome(tfn, torch.tensor(bad))
    assert jc == "JaxRuntimeError" or "Error" in jc
    assert tc == "NonFiniteRenderError"


def test_checkify_render_catches_an_inf_made_inside():
    """An op that makes an inf from finite inputs raises where it
    happens, with the op's name."""
    guarded = dbg.checkify_render(lambda x: torch.exp(x * 10.0))
    assert torch.equal(guarded(torch.ones(3)), torch.exp(torch.full((3,), 10.0)))
    with pytest.raises(dbg.NonFiniteRenderError, match="aten.exp.*inf=3"):
        guarded(torch.full((3,), 10.0))


# ------------------------------------------------------ render_pt dump ----
def _pt_planes(keep):
    sc = scenes.cornell8()
    planes, mats = np.ascontiguousarray(sc.soa10()[:, keep]), np.asarray(sc.material)[keep]
    return planes, tuple(int(m) for m in mats)


@pytest.mark.parametrize("keep", [list(range(8)), [6, 7]],
                         ids=["cornell8", "ball_and_light"])
def test_pt_dump_equals_pallas_interpreter(capfd, keep):
    """tests/test_debug_dumps.py:85's render (32 x 32 x 4, 3 bounces, RR
    from 2, one 1024-pixel tile); and the same with cornell8's ball and
    light alone, so that misses end paths and the counts fall."""
    planes, mats = _pt_planes(keep)
    capfd.readouterr()
    jimg = jax_pk.render_pt_pallas(jnp.asarray(planes), width=32, height=32, spp4=4,
                                   materials=mats, bounces=3, rr_depth=2, tile=1024,
                                   interpret=True, debug=True)
    jax.block_until_ready(jimg)
    want = captured(capfd)
    kw = dict(width=32, height=32, spp4=4, bounces=3, rr_depth=2,
              uniforms=torch.zeros((4, ptk.n_uniforms(3), 1024)))
    args = (convert.scene_planes_from_numpy(planes), torch.tensor(mats, dtype=torch.int32))
    img = ptk.render_pt(*args, debug=True, debug_tile=1024, **kw)
    got = captured(capfd)
    assert len(want) == 3 and got == want
    assert torch.equal(img, ptk.render_pt(*args, **kw))
    assert captured(capfd) == []  # debug off prints nothing
    if keep != list(range(8)):
        assert len({v for _, v in got}) > 1, got


# ----------------------------------------------------------- wbvh dump ----
def _sphere_rays(n, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.randn(3, n).astype(np.float32)
    o /= np.linalg.norm(o, axis=0)
    o *= 3.0
    d = rng.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return np.concatenate([o, d], 0)


def _bundle_rays(n, seed=1, spread=0.03):
    """Two ray tiles of n / 2: narrow cones at the unit icosphere from +z
    and from -x, so that each tile enters its own part of the grid."""
    rng = np.random.RandomState(seed)
    out = []
    for origin in ((0.0, 0.0, 3.0), (-3.0, 0.0, 0.0)):
        o = np.asarray(origin, np.float32)[:, None] + 0.05 * rng.randn(3, n // 2).astype(
            np.float32)
        d = -np.asarray(origin, np.float32)[:, None] / 3.0 + spread * rng.randn(3, n // 2).astype(
            np.float32)
        d /= np.linalg.norm(d, axis=0)
        out.append(np.concatenate([o, d], 0))
    return np.concatenate(out, 1).astype(np.float32)


@pytest.mark.parametrize("case", ["test_debug_dumps", "supers_bundles"])
def test_wbvh_dump_equals_pallas_interpreter(capfd, case):
    """tests/test_debug_dumps.py:58's traversal (icosphere s2, chunks of
    32: 10 chunks, no supers; 2,048 rays from radius 3 in two 1024-ray
    tiles); and icosphere s3 in chunks of 16 under supers of 8 (80 chunks,
    10 supers, no pad chunks: 80 is a multiple of 8) against two narrow
    bundles, one a tile, whose worklists differ."""
    if case == "test_debug_dumps":
        sub, tpc, sp, rays = 2, 32, 0, _sphere_rays(2048)
    else:
        sub, tpc, sp, rays = 3, 16, 8, _bundle_rays(2048)
    v, f = jax_meshes.icosphere(subdivisions=sub)
    v32 = np.asarray(v, np.float32)
    grid = jax_wbvh.build_chunk_grid(v32, f, tris_per_chunk=tpc, supers_per=sp)
    assert grid.n_chunks % max(sp, 1) == 0
    cb, sb, t13, _ = jax_wbvh.chunk_grid_to_device(grid)
    capfd.readouterr()
    jt, jh = jax_wbvh.intersect_chunks_pallas(jnp.asarray(rays), cb, sb, t13,
                                              tris_per_chunk=tpc, supers_per=sp, tile=1024,
                                              interpret=True, debug=True)
    jax.block_until_ready(jt)
    want = captured(capfd)
    pgrid = chunk_grid.build_chunk_grid(v32, f, tris_per_chunk=tpc, supers_per=sp)
    pcb, psb, pt13, _ = chunk_grid.chunk_grid_to_device(pgrid, "cpu")
    kw = dict(tris_per_chunk=tpc, supers_per=sp)
    tmin, hit = wk.intersect_chunks(torch.tensor(rays), pcb, psb, pt13, debug=True,
                                    debug_tile=1024, **kw)
    got = captured(capfd)
    assert len(want) == 2 and got == want
    t0, h0 = wk.intersect_chunks(torch.tensor(rays), pcb, psb, pt13, **kw)
    assert torch.equal(tmin, t0) and torch.equal(hit, h0)
    assert captured(capfd) == []
    if case != "test_debug_dumps":
        ks = [int(v) for _, v in got]
        assert ks[0] != ks[1] and max(ks) < grid.n_chunks, ks


def test_wbvh_dump_prints_every_tile_in_order(capfd):
    """A ragged last tile: N = 2,500 rays in tiles of 1,000 gives three
    lines, each the union of its tile's listings (from the twin's per-ray
    marks over the same walk)."""
    rays = torch.tensor(np.concatenate([_bundle_rays(2000, spread=0.01), _sphere_rays(500)],
                                       1))
    v, f = jax_meshes.icosphere(subdivisions=2)
    g = chunk_grid.build_chunk_grid(np.asarray(v, np.float32), f, tris_per_chunk=16,
                                    supers_per=4)
    cb, sb, t13, _ = chunk_grid.chunk_grid_to_device(g, "cpu")
    capfd.readouterr()
    wk.intersect_chunks(rays, cb, sb, t13, tris_per_chunk=16, supers_per=4, debug=True,
                        debug_tile=1000)
    got = [int(v) for _, v in captured(capfd)]
    per_ray = []
    for t in range(3):
        grp = wk.level_marks(wk.plain_grid(cb, sb, sb[:0], t13, torch.float32, tris_per_chunk=16,
                                           supers_per=4, supers2_per=0),
                             torch.zeros(min(1000, 2500 - 1000 * t), dtype=torch.long), 1)
        sl = rays[:, 1000 * t:1000 * (t + 1)]
        tm = torch.full((sl.shape[1],), 1e20)
        wk.walk_plain(wk.plain_grid(cb, sb, sb[:0], t13, torch.float32, tris_per_chunk=16,
                                    supers_per=4, supers2_per=0),
                      tuple(sl[0:3]), tuple(sl[3:6]), tm, eps=1e-4, marks=(grp,))
        per_ray.append(int(grp[1][0].sum()))
    assert got == per_ray and len(set(got)) > 1


# -------------------------------------------------------- mesh_pt dump ----
def _mesh_case(size):
    v, f = jax_meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=1)
    ms = jax_mesh.MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2),
                                              base_scene="smallpt9")
    return jax_mpt.mesh_pt_tables(ms, tris_per_chunk=8, supers_per=0), size


@pytest.mark.parametrize("size,bounces,with_stats", [(32, 2, False), (64, 3, True)],
                         ids=["test_debug_dumps", "64x64_quarter_cell_with_stats"])
def test_mesh_pt_dump_equals_pallas_interpreter(capfd, size, bounces, with_stats):
    """tests/test_debug_dumps.py:103's render (icosphere s1 in smallpt9,
    chunks of 8 with no supers, 32 x 32 x 4, 2 bounces, RR from 2, one
    1024-pixel tile: cell (0, 0) is the whole image); and 64 x 64 with 3
    bounces, where cell (0, 0) is the first 16 columns, with with_stats on
    too (the dump's worklist k equals kstats' row of cell 0, layer 0)."""
    (planes, cb, sb, t24, mats, grid), w = _mesh_case(size)
    capfd.readouterr()
    jout = jax_mpt.render_pt_mesh_pallas(
        planes, cb, sb, t24, width=w, height=w, spp4=4, materials=mats,
        tris_per_chunk=grid.tris_per_chunk, supers_per=grid.supers_per, bounces=bounces,
        rr_depth=2, tile=1024, interpret=True, debug=True)
    jax.block_until_ready(jout)
    want = captured(capfd)
    p, c, s, ss, t = convert.mesh_tables_from_numpy(np.asarray(planes), cb, sb, None, t24)
    kw = dict(materials=torch.tensor(mats, dtype=torch.int32), width=w, height=w, spp4=4,
              tris_per_chunk=grid.tris_per_chunk, supers_per=grid.supers_per,
              bounces=bounces, rr_depth=2,
              uniforms=torch.zeros((4, ptk.n_uniforms(bounces), w * w)))
    out = mpt.render_pt_mesh(p, c, s, t, ss, debug=True, debug_tile=1024,
                             with_stats=with_stats, stats_tile=1024, **kw)
    got = captured(capfd)
    assert len(want) == 2 * bounces and got == want
    assert [lab for lab, _ in got] == ["mesh_pt worklist k", "mesh_pt alive"] * bounces
    plain = mpt.render_pt_mesh(p, c, s, t, ss, with_stats=with_stats, stats_tile=1024, **kw)
    if with_stats:
        assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
        assert [int(v) for lab, v in got if lab == "mesh_pt worklist k"] == \
            out[1][0:bounces, 0].tolist()
    else:
        assert torch.equal(out, plain)
    assert captured(capfd) == []
