"""Entry points of the port's compile-and-run checks, the counterpart of
the JAX package's ``__graft_entry__.py``.

- :func:`entry`: the path-tracing forward (``megakernel.render_pt_impl``
  on smallpt9) and example arguments on a device.
- :func:`dryrun_multichip`: a world of ``n`` local ranks
  (``parallel/distributed.run_local_world``) runs four checks, each held
  against the same code in a world of one rank: the DP x TP reference
  render, one training step, the bounce pipeline at 2n bounces and the
  DP mesh render (an 80-triangle icosphere through the per-ray BVH
  walk), all in float64, where no decision can flip.

    python -m ascendpathtracing_tpu_torch.graft_entry 4 [--backend cpu]
"""

from __future__ import annotations

import sys
from functools import partial

import numpy as np


def entry(device: str = "cuda"):
    """(fn, example_args): ``fn(rays, scene)`` is the path-tracing forward
    at 8 bounces, RR from 5, on smallpt9 and 32 x 32 camera rays (float32)
    on ``device``."""
    import torch

    from ascendpathtracing_tpu_torch import camera, scenes
    from ascendpathtracing_tpu_torch.device import resolve_device
    from ascendpathtracing_tpu_torch.models import megakernel

    dev = resolve_device(device)
    scene = megakernel.scene_to_device(scenes.smallpt9(), device=dev)
    rays = torch.tensor(camera.generate_rays_numpy(32, 32, 1, seed=0).astype(np.float32),
                        device=dev)
    return partial(megakernel.render_pt_impl, bounces=8, rr_depth=5), (rays, scene)


def dryrun_rank(n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip` -> the gathered results of the
    four checks, and this rank's loss and parameters."""
    import torch

    from ascendpathtracing_tpu_torch import camera, scenes
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.models import mesh as mesh_mod
    from ascendpathtracing_tpu_torch.parallel import (
        gather_colors, make_mesh, make_train_step, render_pt_mesh_sharded,
        render_reference_sharded, shard_rays, split_scene_params)
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device
    from ascendpathtracing_tpu_torch.parallel.mesh import mesh_shape
    from ascendpathtracing_tpu_torch.parallel.pipeline import render_reference_pipelined

    dev, f64 = rank_device(), torch.float64
    w = max(4, n_devices)  # rays divisible by every world size up to n_devices
    rays = torch.tensor(camera.generate_rays_numpy(w, w, 1, seed=0), dtype=f64)
    scene = megakernel.scene_to_device(scenes.cornell8(), device=dev, dtype=f64)
    mesh = make_mesh()
    local = shard_rays(rays, mesh).to(dev)
    out = {"mesh": mesh_shape(mesh), "rays": rays.shape[0]}

    # 1) DP rays x TP spheres (the model axis's all_gather hit combine)
    out["render"] = gather_colors(render_reference_sharded(local, scene, mesh, bounces=3))

    # 2) the training step: forward with winners, replay backward, one
    #    all-reduce of the loss and gradient, SGD on replicated parameters
    params, aux = split_scene_params(scene)
    target = torch.zeros((local.shape[0], 3), dtype=f64, device=dev)
    loss, new = make_train_step(mesh, bounces=3, learning_rate=1e-3)(params, aux, local, target)
    out["loss"] = float(loss)
    out["params"] = {k: v.cpu().numpy() for k, v in new.items()}

    # 3) the bounce pipeline over a ("stage",) ring, 2 bounces a stage
    stages = make_mesh(axis_names=("stage",))
    out["pipeline"] = gather_colors(render_reference_pipelined(
        shard_rays(rays, stages).to(dev), scene, stages, bounces=2 * n_devices))

    # 4) the mesh scene DP over rays, through the per-ray BVH walk
    v, f = meshes.icosphere(center=(50, 30, 60), radius=14.0, subdivisions=1)
    ms = mesh_mod.MeshScene.cornell_with_mesh(v, f, albedo=(0.8, 0.5, 0.2))
    mdev = mesh_mod.mesh_scene_to_device(ms, device=dev, dtype=f64, use_bvh=True)
    out["mesh_render"] = gather_colors(render_pt_mesh_sharded(0, local, mdev, mesh, bounces=3))
    out["tris"] = int(f.shape[0])
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run :func:`dryrun_rank` in a world of ``n_devices`` local ranks and
    in a world of one, and hold each check against the one-rank result:
    the pipeline and the mesh render bitwise, the DP x TP render to 1e-12
    (bitwise on the CPU), the loss to rtol 1e-12 and the parameters to
    rtol 1e-9 (float64; only the order of the sums differs).  Raises
    AssertionError where one differs; returns the n-rank results."""
    from ascendpathtracing_tpu_torch.parallel.distributed import run_local_world

    many = run_local_world(dryrun_rank, n_devices, device=device, args=(n_devices,))
    one = run_local_world(dryrun_rank, 1, device=device, args=(n_devices,))[0]
    got = many[0]
    for key in ("render", "pipeline", "mesh_render"):
        # With a model axis the render runs the plain bounce loop, and one
        # rank runs the reference kernel: on a card those two agree to
        # 1e-12 in float64 (as the kernel and the float64 oracle do).
        same = (np.allclose(got[key], one[key], rtol=1e-12, atol=1e-12) if key == "render"
                else np.array_equal(got[key], one[key]))
        if not np.isfinite(got[key]).all() or not same:
            err = float(np.abs(got[key] - one[key]).max())
            raise AssertionError(f"dryrun {key}: {n_devices} ranks differ from one by {err}")
    if not np.isclose(got["loss"], one["loss"], rtol=1e-12, atol=0):
        raise AssertionError(f"dryrun loss {got['loss']} vs one rank's {one['loss']}")
    for rank, res in enumerate(many):
        for k, v in res["params"].items():
            if not np.allclose(v, one["params"][k], rtol=1e-9, atol=1e-12):
                raise AssertionError(f"dryrun params[{k}] of rank {rank} differ from one rank's")
    print(f"dryrun_multichip OK: mesh={tuple(got['mesh'].values())} pp_stages={n_devices} "
          f"rays={got['rays']} mesh_tris={got['tris']} mesh_traversal=jnp-bvh "
          f"loss={got['loss']:.6f} device={device}")
    return got


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="The port's multi-rank dry run.")
    ap.add_argument("n", type=int, help="ranks (processes) in the world")
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, device=a.backend)
    sys.exit(0)
