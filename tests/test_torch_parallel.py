"""The sharded port (``ascendpathtracing_tpu_torch/parallel``) against its
one-rank self and the JAX package's ``parallel/``, on the CPU.

Worlds of 1, 2 and 4 gloo ranks (``parallel/distributed.run_local_world``,
one thread a rank) are spawned once each, and every rank runs every case
(``tests/test_torch_parallel_ranks.world_cases``, jax-free: the ranks
import it); the JAX side runs here on the 8 virtual CPU devices.  The
cases mirror tests/test_parallel.py, tests/test_pipeline.py and
tests/test_assembly.py at 16 x 16 camera rays (1,024 rays) and 3-8
bounces.  Tolerances, float64 throughout:

- the port's n-rank results against its one-rank results: bitwise, but
  the training step (loss rtol 1e-12, parameters rtol 1e-9, atol 1e-12:
  the sums run in another order) and ``bit_equal=False`` (independent
  streams: means within 4 standard errors);
- the port against the JAX package: the reference renders, rings and
  training step at test_torch_megakernel's and test_parallel's
  tolerances (renders rtol 1e-12 atol 1e-12: XLA reassociates; loss rtol
  1e-12, parameters rtol 1e-9), the mesh renders at
  test_torch_mesh_render's rtol 1e-9, each over the JAX package's draws
  (and its BVH tables for the walk); the PT ring over JAX's draws bitwise
  the port's render_pt_impl over them, which test_torch_pt.py holds to
  JAX's render_pt.

Every spawn has its own timeout; a rank that fails or hangs fails the
test with its log.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu import parallel as jpar
from ascendpathtracing_tpu import scenes as jscenes
from ascendpathtracing_tpu.models import megakernel as jmk
from ascendpathtracing_tpu.models import mesh as jmesh
from ascendpathtracing_tpu_torch import cli, convert, graft_entry, scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import render_kernels
from ascendpathtracing_tpu_torch.parallel import mesh_shape_for
from ascendpathtracing_tpu_torch.parallel.distributed import run_local_world
from ascendpathtracing_tpu_torch.utils import io
from tests import test_torch_parallel_ranks as ranks
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

WORLDS = (1, 2, 4)
N = ranks.W * ranks.W * 4
MESH_CASES = ("true_brute", "true_walk", "indexed_walk", "indexed_chunks", "true_brute_jax",
              "indexed_walk_jax")


def _split_draws(key, bounces, n):
    """The JAX estimators' draws: split, then uniform (3, n), a bounce."""
    out = []
    for _ in range(bounces):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (3, n), dtype=jnp.float64)))
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's results on its 8 virtual devices, and the draws
    and tables the port's ranks take from it."""
    if len(jax.devices()) < 8:
        pytest.fail("the JAX side needs tests/conftest.py's 8 virtual CPU devices")
    rays = jnp.asarray(ranks.rays64().numpy())
    cornell = jmk.scene_to_device(jscenes.cornell8(), dtype=jnp.float64)
    out = {"ref": {}}
    for mp in (1, 2, 4):
        mesh = jpar.make_mesh(8, model_parallel=mp)
        out["ref"][mp] = np.asarray(jpar.render_reference_sharded(
            jpar.shard_rays(rays, mesh), cornell, mesh, bounces=5))
    mesh = jpar.make_mesh(8)
    key = jax.random.PRNGKey(3)
    cube = jmesh.mesh_scene_to_device(ranks.mesh_scene("cube"), dtype=jnp.float64, use_bvh=False)
    out["mesh_true_brute_jax"] = np.asarray(jpar.render_pt_mesh_sharded(
        key, rays, cube, mesh, bounces=4))
    ico = jmesh.mesh_scene_to_device(ranks.mesh_scene("ico"), dtype=jnp.float64, use_bvh=True)
    out["mesh_indexed_walk_jax"] = np.asarray(jpar.render_pt_mesh_sharded(
        key, rays, ico, mesh, bounces=4, bit_equal="indexed"))
    gidx = jnp.arange(N, dtype=jnp.int32)
    u_indexed = np.stack([np.asarray(jmk.indexed_uniforms(key, d, gidx, jnp.float64))
                          for d in range(4)])

    target = jmk.render_reference(rays, cornell, bounces=3)
    params, aux = jpar.split_scene_params(cornell)
    # copies: the step donates its parameters, which alias the scene's arrays
    params = {k: jnp.array(v) for k, v in dict(params, albedo=params["albedo"] + 0.03).items()}
    loss, new = jpar.make_train_step(mesh, bounces=3, learning_rate=1.0)(
        params, aux, jpar.shard_rays(rays, mesh), jpar.shard_rays(target, mesh))
    out["train"] = (float(loss), {k: np.asarray(v) for k, v in new.items()})

    # tests/test_pipeline.py's gates hold the rings to the one-device renders
    out["reference8"] = np.asarray(jmk.render_reference(rays, cornell, bounces=8))
    out["inputs"] = {
        "u_true": torch.tensor(_split_draws(key, 4, N)),
        "u_indexed": torch.tensor(u_indexed),
        "u_ring": torch.tensor(_split_draws(jax.random.PRNGKey(11), ranks.PT_RING["bounces"], N)),
        "ico_jnp": convert.mesh_dev_from_jax(ico),
        "ppm": str(tmp_path_factory.mktemp("assembly") / "assembled"),
    }
    return out


@pytest.fixture(scope="module")
def worlds(jax_side):
    """{world size: [each rank's world_cases results]}."""
    return {n: run_local_world(ranks.world_cases, n, device="cpu", args=(jax_side["inputs"],),
                               timeout=240) for n in WORLDS}


def _ranks_agree(results, key):
    for res in results[1:]:
        np.testing.assert_array_equal(res[key], results[0][key])
    return results[0][key]


def test_worlds_run_on_gloo_with_the_jax_mesh_rule(worlds):
    for n, results in worlds.items():
        assert [r["info"]["process_index"] for r in results] == list(range(n))
        assert {r["info"]["backend"] for r in results} == {"gloo"}
        assert {r["info"]["device"] for r in results} == {"cpu"}
        assert results[0]["mesh"] == dict(zip(("data", "model"), mesh_shape_for(n)))
    assert worlds[4][0]["mesh"] == {"data": 2, "model": 2}


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_sharded_render_matches_single_device(worlds, jax_side, model_parallel):
    """DP x TP: bitwise the one-rank render (the reference kernel's twin)
    in every world the model axis divides, rtol 1e-12 from JAX's."""
    key = f"ref_mp{model_parallel}"
    one = worlds[1][0]["ref_mp1"]
    ran = [n for n in WORLDS if n % model_parallel == 0]
    assert ran == [n for n in WORLDS if n >= model_parallel]
    for n in ran:
        got = _ranks_agree(worlds[n], key)
        assert worlds[n][0][f"{key}_rows"] == N // n
        np.testing.assert_array_equal(got, one)
        np.testing.assert_allclose(got, jax_side["ref"][model_parallel], rtol=1e-12, atol=1e-12)
    assert one.max() > 0.1


@pytest.mark.parametrize("case", MESH_CASES)
def test_sharded_mesh_render_matches_one_rank(worlds, case):
    """render_pt_mesh_sharded (brute force, the per-ray BVH walk, the
    chunk twin; True and "indexed"): bitwise the one-rank render."""
    one = worlds[1][0][f"mesh_{case}"]
    assert np.isfinite(one).all() and one.max() > 0
    for n in WORLDS[1:]:
        np.testing.assert_array_equal(_ranks_agree(worlds[n], f"mesh_{case}"), one)


def test_sharded_mesh_render_modes_draw_the_one_device_stream(worlds):
    """True and "indexed" give the one-device render of all the rays with
    its default stream (Philox at the ray index), bit for bit."""
    rays = ranks.rays64()
    expect = mm.render_pt_mesh(rays, ranks.mesh_dev(use_bvh=False), bounces=4, seed=3)
    np.testing.assert_array_equal(worlds[4][0]["mesh_true_brute"], expect.numpy())
    indexed = mm.render_pt_mesh(rays.float(), ranks.mesh_dev("ico", torch.float32,
                                                             pallas_bvh_kernel=True),
                                bounces=3, seed=3)
    np.testing.assert_array_equal(worlds[2][0]["mesh_indexed_chunks"], indexed.numpy())


@pytest.mark.parametrize("case", ["true_brute_jax", "indexed_walk_jax"])
def test_sharded_mesh_render_matches_jax(worlds, jax_side, case):
    """Over the JAX package's draws (its split stream for True, its
    ``indexed_uniforms`` for "indexed") and its BVH tables, every world
    within rtol 1e-9 of JAX's render_pt_mesh_sharded on 8 devices."""
    for n in WORLDS:
        np.testing.assert_allclose(worlds[n][0][f"mesh_{case}"], jax_side[f"mesh_{case}"],
                                   rtol=1e-9, atol=0)


def test_sharded_mesh_render_independent_rng_energy(worlds):
    """bit_equal=False (a seed of each shard's own): 32 x 32 x 4 rays, the
    mean within 4 standard errors of the one-device render's."""
    ref = mm.render_pt_mesh(ranks.rays64(32), ranks.mesh_dev(use_bvh=False), bounces=4,
                            seed=3).numpy().mean(1)
    for n in WORLDS:
        got = worlds[n][0]["mesh_independent_brute"].mean(1)
        assert np.isfinite(got).all() and not np.array_equal(got, ref)
        se = np.sqrt(got.var() / got.size + ref.var() / ref.size)
        assert abs(got.mean() - ref.mean()) <= 4 * se, (n, got.mean(), ref.mean(), se)


def test_sharded_grads_match_single_device(worlds, jax_side):
    """The data-parallel step (one all-reduce of loss and gradient): loss
    rtol 1e-12 and new parameters rtol 1e-9 (atol 1e-12) against JAX's
    GSPMD step and the one-rank step; every rank's parameters equal."""
    j_loss, j_new = jax_side["train"]
    one_loss, one_new = worlds[1][0]["train"]
    for n in WORLDS:
        for loss, new in (r["train"] for r in worlds[n]):
            for ref_loss, ref_new in ((j_loss, j_new), (one_loss, one_new)):
                assert np.isclose(loss, ref_loss, rtol=1e-12, atol=0)
                for k in ref_new:
                    np.testing.assert_allclose(new[k], ref_new[k], rtol=1e-9, atol=1e-12)
            for k in new:
                np.testing.assert_array_equal(new[k], worlds[n][0]["train"][1][k])


def test_train_step_runs_and_reduces_loss(worlds):
    for n in WORLDS:
        losses = worlds[n][0]["train_losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], (n, losses)
        assert all(r["train_losses"] == losses for r in worlds[n])


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("name", ["pipelined", "ring_scene"])
def test_rings_equal_megakernel(worlds, jax_side, name, stages):
    """The bounce pipeline and the scene ring (8 bounces; 4 stages put two
    spheres on each): bitwise the one-device plain loop, rtol 1e-12 from
    JAX's render_reference."""
    rays = ranks.rays64()
    cornell = megakernel.scene_to_device(scenes.cornell8(), dtype=torch.float64)
    expect = megakernel.render_reference_impl(rays, cornell, bounces=8).numpy()
    got = _ranks_agree(worlds[stages], name)
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(worlds[1][0][name], expect)
    np.testing.assert_allclose(got, jax_side["reference8"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["pipelined", "ring_scene"])
def test_ring_outputs_are_stage_sharded(worlds, name):
    """Each stage returns its N/S rows, not a replica."""
    for n in WORLDS:
        assert [r[f"{name}_rows"] for r in worlds[n]] == [N // n] * n


@pytest.mark.parametrize("stages", [2, 4])
def test_pt_ring_scene_equals_megakernel(worlds, jax_side, stages):
    """The PT estimator over the scene ring (smallpt9 padded to a multiple
    of the stages with spheres no ray hits, 6 bounces, RR from 4): with
    the port's stream bitwise render_pt_impl; with JAX's draws (split,
    then uniform, as tests/test_pipeline.py's render_pt draws them)
    bitwise render_pt_impl over the same draws, which
    tests/test_torch_pt.py holds to JAX's render_pt at rtol 1e-12."""
    rays = ranks.rays64()
    sc = megakernel.scene_to_device(scenes.smallpt9(), dtype=torch.float64)
    expect = megakernel.render_pt_impl(rays, sc, seed=11, **ranks.PT_RING).numpy()
    np.testing.assert_array_equal(_ranks_agree(worlds[stages], "pt_ring"), expect)
    u = jax_side["inputs"]["u_ring"]
    expect_u = megakernel.render_pt_impl(rays, sc, uniforms=u, **ranks.PT_RING).numpy()
    got = _ranks_agree(worlds[stages], "pt_ring_jax")
    np.testing.assert_array_equal(got, expect_u)
    assert got.max() > 0


@pytest.mark.parametrize("check", ["pipelined_bounces", "shard_rays", "ring_spheres"])
def test_rings_validate_divisibility(worlds, check):
    """Bounces, rays and spheres that do not divide by the stages raise
    ValueError("... not divisible ...") in every rank."""
    for n in (2, 4):
        msgs = [r["errors"][check] for r in worlds[n]]
        assert all(m is not None and "not divisible" in m for m in msgs), msgs


def test_sharded_assembly_ppm_byte_identical(worlds, jax_side):
    """assemble_ppm_host0: rank 0 writes, the other ranks return None, and
    the bytes equal the single-device pipeline's."""
    rays = ranks.rays64().float()
    colors = render_kernels.render_reference(
        rays, convert.scene_planes_from_numpy(scenes.cornell8().soa10()), light_index=7,
        bounces=5)
    single = jax_side["inputs"]["ppm"] + "_single.ppm"
    io.write_ppm(io.decode_color(colors.numpy(), ranks.W, ranks.W, 1), single)
    for n in WORLDS:
        paths = [r["ppm"] for r in worlds[n]]
        assert paths == [f"{jax_side['inputs']['ppm']}_{n}.ppm"] + [None] * (n - 1)
        assert open(paths[0], "rb").read() == open(single, "rb").read()


def test_cli_shard_flag_renders_and_assembles(tmp_path, capsys):
    """render --shard 4 (a (2, 2) mesh: the model axis's hit combine)
    writes the unsharded render's artifacts byte for byte; --shard 3 does
    not divide the 1,024 rays and exits 2."""
    args = ["render", "--width", "16", "--height", "16", "--samples", "1", "--bounces", "4",
            "--mode", "reference", "--backend", "cpu"]
    assert cli.main(args + ["--out", str(tmp_path / "a")]) == 0
    assert cli.main(args + ["--shard", "4", "--out", str(tmp_path / "b")]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"shard": 4' in line and '"dist_backend": "gloo"' in line
    for name in ("rays.bin", "spheres.bin", "color.bin", "color.ppm"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    assert cli.main(args + ["--shard", "3", "--out", str(tmp_path / "c")]) == 2
    assert "must divide the ray count" in capsys.readouterr().err
    assert not (tmp_path / "c" / "color.bin").exists()


def test_dryrun_multichip():
    """The port's dry run at 4 ranks: DP x TP render, training step, bounce
    pipeline at 8 bounces and the mesh DP render, each against one rank."""
    got = graft_entry.dryrun_multichip(4, device="cpu")
    assert got["mesh"] == {"data": 2, "model": 2} and np.isfinite(got["loss"])


def test_entry_runs():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert out.shape == (args[0].shape[0], 3) and bool(torch.isfinite(out).all())
