"""The sharded port's rank side (``parallel/``) on the CPU, and its checks
that need no JAX.

:func:`world_cases` runs every case of ``tests/test_torch_parallel.py``
in each rank of a gloo world (``parallel/distributed.run_local_world``,
one thread a rank) and returns the results; that file spawns worlds of
1, 2 and 4 ranks once each and compares.  Spawned ranks import this
module, so it imports no jax and nothing of the JAX package.  The tests
here hold the launcher (a failing or hung rank fails the call with its
log), the mesh rules, the split-stable Philox stream and ``ppermute``.
"""

import pytest
import torch
import torch.distributed as dist

from ascendpathtracing_tpu_torch import camera, scenes
from ascendpathtracing_tpu_torch.accel import meshes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.parallel import (
    assemble_ppm_host0, gather_colors, make_mesh, make_train_step, mesh_shape_for,
    render_pt_mesh_sharded, render_reference_sharded, shard_rays, split_scene_params)
from ascendpathtracing_tpu_torch.parallel import mesh as pmesh
from ascendpathtracing_tpu_torch.parallel import pipeline
from ascendpathtracing_tpu_torch.parallel.distributed import process_info, run_local_world

W = 16  # 16 x 16 camera rays x 1 sample = 1,024 rays
F64 = torch.float64
PT_RING = dict(bounces=6, rr_depth=4)  # tests/test_pipeline.py's PT ring


def rays64(w=W):
    return torch.tensor(camera.generate_rays_numpy(w, w, 1, seed=0))


def mesh_scene(kind="cube"):
    """tests/test_parallel.py's mesh scenes: a cube, or an 80-triangle
    icosphere, in smallpt9."""
    v, f = (meshes.cube(center=(50, 30, 60), size=25.0) if kind == "cube" else
            meshes.icosphere(center=(50, 30, 60), radius=14.0, subdivisions=1))
    return mm.MeshScene.cornell_with_mesh(v, f, albedo=(0.8, 0.5, 0.2))


def mesh_dev(kind="cube", dtype=F64, **kw):
    return mm.mesh_scene_to_device(mesh_scene(kind), dtype=dtype, **kw)


def padded_smallpt9(stages):
    """smallpt9 padded to a multiple of ``stages`` spheres with spheres
    no ray hits (r² = -1), as tests/test_pipeline.py pads it."""
    sc = megakernel.scene_to_device(scenes.smallpt9(), dtype=F64)
    pad = -sc["r2"].shape[0] % stages
    z3 = torch.zeros((pad, 3), dtype=F64)
    return dict(sc, r2=torch.cat([sc["r2"], torch.full((pad,), -1.0, dtype=F64)]),
                center=torch.cat([sc["center"], z3]), albedo=torch.cat([sc["albedo"], z3]),
                emission=torch.cat([sc["emission"], z3]),
                material=torch.cat([sc["material"], torch.zeros(pad, dtype=torch.int32)]))


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def world_cases(inputs: dict) -> dict:
    """Every case in this rank -> {name: result}; gathered colors are
    [N, 3] arrays (every rank's are the same).  ``inputs``: the JAX
    package's draws and tables, and a path for the PPM."""
    n = dist.get_world_size()
    rays = rays64()
    cornell = megakernel.scene_to_device(scenes.cornell8(), dtype=F64)
    out = {"info": process_info(), "mesh": pmesh.mesh_shape(make_mesh(n))}

    # DP x TP reference renders (tests/test_parallel.py's model 1, 2, 4)
    for mp in (1, 2, 4):
        if n % mp == 0:
            mesh = make_mesh(n, model_parallel=mp)
            local = render_reference_sharded(shard_rays(rays, mesh), cornell, mesh, bounces=5)
            out[f"ref_mp{mp}"] = gather_colors(local)
            out[f"ref_mp{mp}_rows"] = local.shape[0]
    mesh = make_mesh(n, model_parallel=1)

    # the mesh path tracer in its three random-number modes
    cube = mesh_dev(use_bvh=False)
    local = shard_rays(rays, mesh)
    mesh_cases = {
        "true_brute_jax": (cube, True, 4, local, inputs["u_true"]),
        "true_brute": (cube, True, 4, local, None),
        "true_walk": (mesh_dev(use_bvh=True), True, 4, local, None),
        "indexed_walk_jax": (inputs["ico_jnp"], "indexed", 4, local, inputs["u_indexed"]),
        "indexed_walk": (inputs["ico_jnp"], "indexed", 4, local, None),
        "indexed_chunks": (mesh_dev("ico", torch.float32, pallas_bvh_kernel=True), "indexed", 3,
                           local.float(), None),
        "independent_brute": (cube, False, 4, shard_rays(rays64(32), mesh), None),
    }
    for name, (mdev, bit_equal, bounces, r, u) in mesh_cases.items():
        out[f"mesh_{name}"] = gather_colors(render_pt_mesh_sharded(
            3, r, mdev, mesh, bounces=bounces, bit_equal=bit_equal, uniforms=u))

    # the training step (tests/test_parallel.py:196-250)
    target = megakernel.render_reference_impl(rays, cornell, bounces=3)
    params, aux = split_scene_params(cornell)
    step = make_train_step(mesh, bounces=3, learning_rate=1.0)
    loss, new = step(dict(params, albedo=params["albedo"] + 0.03), aux, shard_rays(rays, mesh),
                     shard_rays(target, mesh))
    out["train"] = (float(loss), {k: v.numpy() for k, v in new.items()})
    p = dict(params, albedo=params["albedo"] + 0.05)
    step = make_train_step(mesh, bounces=3, learning_rate=0.02)
    losses = []
    for _ in range(10):
        loss, p = step(p, aux, shard_rays(rays, mesh), shard_rays(target, mesh))
        losses.append(float(loss))
    out["train_losses"] = losses

    # host-0 assembly
    out["ppm"] = assemble_ppm_host0(
        render_reference_sharded(local.float(), megakernel.scene_to_device(scenes.cornell8()),
                                 mesh, bounces=5), W, W, 1, f"{inputs['ppm']}_{n}.ppm")

    # the rings over a ("stage",) mesh of every rank
    ring = make_mesh(axis_names=("stage",))
    local = shard_rays(rays, ring)
    for name, fn in (("pipelined", pipeline.render_reference_pipelined),
                     ("ring_scene", pipeline.render_reference_ring_scene)):
        c = fn(local, cornell, ring, bounces=8)
        out[name], out[f"{name}_rows"] = gather_colors(c), c.shape[0]
    padded = padded_smallpt9(n)
    out["pt_ring_jax"] = gather_colors(pipeline.render_pt_ring_scene(
        11, local, padded, ring, uniforms=inputs["u_ring"], **PT_RING))
    out["pt_ring"] = gather_colors(pipeline.render_pt_ring_scene(11, local, padded, ring, **PT_RING))
    out["errors"] = {
        "pipelined_bounces": _error(lambda: pipeline.render_reference_pipelined(
            local, cornell, ring, bounces=2 * n + 1)),
        "shard_rays": _error(lambda: shard_rays(rays[:rays.shape[0] - 1], ring)),
        "ring_spheres": _error(lambda: pipeline.render_reference_ring_scene(
            local, megakernel.scene_to_device(scenes.smallpt9(), dtype=F64), ring, bounces=4)),
    }
    return out


# ------------------------------------------------------------ tests ----
def test_mesh_shape_for_is_the_jax_rule():
    assert [mesh_shape_for(n) for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 2)]
    assert mesh_shape_for(8, 1) == (8, 1) and mesh_shape_for(8, 4) == (2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape_for(6, 4)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)


def test_sphere_pt_indexed_stream_is_split_stable():
    """tests/test_parallel.py:141 on the port: render_pt_impl with
    ``global_idx`` over any contiguous piece reproduces the full render's
    rows bit for bit, so a shard's draws do not depend on the split."""
    rays = rays64()
    sc = megakernel.scene_to_device(scenes.smallpt9(), dtype=F64)
    mats = tuple(int(m) for m in scenes.smallpt9().material)
    n, h = rays.shape[0], rays.shape[0] // 2
    idx = torch.arange(n)
    kw = dict(bounces=4, materials_static=mats, seed=5)
    full = megakernel.render_pt_impl(rays, sc, global_idx=idx, **kw)
    assert torch.equal(full, megakernel.render_pt_impl(rays, sc, **kw))
    lo = megakernel.render_pt_impl(rays[:h], sc, global_idx=idx[:h], **kw)
    hi = megakernel.render_pt_impl(rays[h:], sc, global_idx=idx[h:], **kw)
    assert torch.equal(full, torch.cat([lo, hi]))
    assert not torch.equal(hi, megakernel.render_pt_impl(rays[h:], sc, **kw))


def test_mesh_render_global_idx_keys_the_stream():
    """render_pt_mesh_impl's ``global_idx``: the halves' rows bit for bit."""
    rays = rays64(8)
    mdev = mesh_dev(use_bvh=False)
    h = rays.shape[0] // 2
    full = mm.render_pt_mesh(rays, mdev, bounces=3, seed=3)
    hi = mm.render_pt_mesh(rays[h:], mdev, bounces=3, seed=3, global_idx=torch.arange(h, 2 * h))
    assert torch.equal(full[h:], hi)
    with pytest.raises(ValueError, match="global_idx"):
        mm.render_pt_mesh(rays, mdev, bounces=1, global_idx=torch.arange(3))


def ring_rank(shift):
    """ppermute of a rank's id and a float row, ``shift`` ahead."""
    r = dist.get_rank()
    got = pmesh.ppermute((torch.tensor([r]), torch.full((2,), r / 2, dtype=F64),
                          torch.tensor([r % 2 == 0])), None, shift)
    return [t.tolist() for t in got]


def failing_rank(bad_rank):
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} was told to fail")
    dist.barrier()  # the others wait in a collective that never completes


def test_ppermute_and_the_launcher():
    """ppermute over a 3-rank ring backwards (the rings run it forwards);
    a rank that raises fails the whole call with its log, and the ranks
    left waiting in a collective are stopped."""
    res = run_local_world(ring_rank, 3, device="cpu", args=(-1,), timeout=120)
    for r, (ids, row, flag) in enumerate(res):
        src = (r + 1) % 3  # shift -1: each rank receives from the rank ahead
        assert ids == [src] and row == [src / 2] * 2 and flag == [src % 2 == 0]
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 \(cpu\) exited with 1.*"
                                           r"rank 1 was told to fail"):
        run_local_world(failing_rank, 2, device="cpu", args=(1,), timeout=120)


def hanging_rank():
    dist.barrier() if dist.get_rank() == 0 else __import__("time").sleep(600)


def test_launcher_fails_a_rank_past_its_timeout():
    with pytest.raises(RuntimeError, match="outlived its timeout"):
        run_local_world(hanging_rank, 2, device="cpu", timeout=5)
