"""Benchmark of the port on a CUDA device.

Reference mode (the default) measures the step that the JAX package's
``bench.py`` measures by default: the Cornell8 scene in reference
semantics, 4,194,304 camera rays (1024 x 1024 x 4,
``camera.generate_rays_numpy(seed=0)``), 8 bounces, forward plus the
backward to the [10, S] scene planes.  Prints ONE JSON line whose metric
names the backend and renderer; ``detail`` holds the toolchain, the
card's name and power limit, and every step time.

    python -m ascendpathtracing_tpu_torch.bench                 # fwd+bwd, kernels
    python -m ascendpathtracing_tpu_torch.bench --fwd-only
    python -m ascendpathtracing_tpu_torch.bench --renderer plain
    python -m ascendpathtracing_tpu_torch.bench --profile     # + device busy/idle
    python -m ascendpathtracing_tpu_torch.bench --mode pt     # fused path tracer
    python -m ascendpathtracing_tpu_torch.bench --mode pt --renderer plain
    python -m ascendpathtracing_tpu_torch.bench --mode mesh   # fused mesh, fwd+bwd
    python -m ascendpathtracing_tpu_torch.bench --mode mesh --fwd-only
    python -m ascendpathtracing_tpu_torch.bench --mode mesh --renderer xla  # bounce loop
    python -m ascendpathtracing_tpu_torch.bench --mode mesh --renderer xla --fwd-only \
        --traversal lockstep
    python -m ascendpathtracing_tpu_torch.bench --mode pt --renderer wavefront
    python -m ascendpathtracing_tpu_torch.bench --mode mesh --renderer wavefront

``--renderer kernel`` is the custom-VJP render on the hand-written CUDA
kernels (replay backward); ``--renderer plain`` is the plain-torch
``models/megakernel`` path with torch autograd to the float scene leaves
(albedo, emission, center, r2), as the JAX bench's jit path.

``--mode pt --renderer kernel`` is the JAX bench's ``pallas-pt`` cell:
the fused path-tracing kernel (``ops/pt_kernels.render_pt``) on cornell8
at 1024 x 1024 pixels x ``--spp`` (64) samples, 8 bounces, RR from 5,
seed 0, forward only; its value counts samples (camera paths) per
second.
``--mode pt --renderer plain`` is the JAX bench's ``--mode pt`` jit cell:
the plain estimator (``megakernel.render_pt_impl``) on smallpt9 at
4,194,304 rays, 8 bounces, RR from 5, fwd+bwd by autograd to albedo,
emission, center and r2 (``--fwd-only`` for the forward).

``--mode mesh`` is the JAX bench's ``--renderer pallas-mesh`` cell: the
fused sphere+mesh path tracer (``ops/mesh_pt_kernels.render_pt_mesh``)
at 1024 x 1024 pixels (from ``--rays``) x ``--spp`` (64) samples of an
icosphere of ``--subdiv`` (4: 5,120 triangles) at (50, 40, 60), radius
14, albedo (0.85, 0.55, 0.2) in smallpt9, cut into chunks of
``--chunk-tris`` (16) triangles (320 chunks under 20 supers), 8 bounces,
RR from 5, seed 0.  By default one step is the training step of
``diff/mesh_fused.make_render_pt_mesh_diff``: the forward with replay
residuals, then ``image.sum()``'s gradient to the scene planes, the slot
albedos and the slot emissions by the replay backward (one rows launch,
``csrc/mesh_replay.cu``, and one segment-sum launch per chunk of sample
layers); ``--fwd-only`` is the forward alone.  ``--renderer plain`` runs
the plain twins (the forward with residuals, then the replay with the
plain rows and segment-sum; minutes at full size: pass a smaller
``--spp``).  The value counts samples per second.

``--mode mesh --renderer xla`` is the JAX bench's ``xla-mesh`` cell: the
same scene through the bounce-loop renderer (``models/mesh``), 1024 x
1024 pixels at spp4 = ``min(--spp, 4)`` (4,194,304 camera rays, every ray
held in device memory), 8 bounces, RR from 5, a new seed every step, one
traversal launch per bounce: the chunk-grid kernel (``--traversal
chunks``, the default) or the BVH kernel (``--traversal lockstep``,
forward only: ``diff/mesh`` refuses the BVH's leaf order).
``--fwd-only`` times ``models/mesh.render_pt_mesh``; otherwise the step is
``sum(diff/mesh.render_pt_mesh_params(...))`` and its gradients to the
vertices, face albedo and face emission by autograd (whose plane gathers
sum their cotangents with the segment-sum kernel: 4 launches per bounce,
less 2 at the last, whose hit distance no output reads).

``--renderer wavefront`` is the JAX bench's ``wavefront`` cell with
``--mode pt`` (``models/wavefront.render_wavefront``: cornell8 at 1024 x
1024 pixels x ``--spp`` (64) samples, 8 bounces, RR from 5, a pool of
``--pool`` (2**19) rays) and its ``wavefront-mesh`` cell with ``--mode
mesh`` (``render_wavefront_mesh``: the mesh cell's scene and size on the
chunk-grid tables, ``csrc/wbvh.cu`` once per iteration, the coherence
sort and a compaction every iteration).  A new seed every step; forward
only.  The value counts samples per second under the JAX bench's
``Mrays/s`` key; ``detail.iterations_per_step`` is the pool's iterations
(``models/wavefront.STATS``; one image scatter, ``csrc/segsum.cu``, each)
and ``detail.ms_per_iteration`` the step's median over them.

Each step is timed with CUDA events after a warm-up; the value is the
median.  In every mode ``detail.launches_per_step`` maps each kernel that
launched to its launches per step (empty for the plain renderers), and
``detail.max_memory_allocated`` is the peak of the timed steps.  It needs
a CUDA device and exits 2 without one.

``--profile`` then runs the same number of steps under ``torch.profiler``
and adds ``detail.profile``: the device's busy time per step (the union
of its kernel and memset intervals), the wall time per step on the host's
clock, the idle share (1 - busy / wall) and the device events that took
the most time.  The profiler adds host time, so the idle share it reads
is an upper bound for the unprofiled step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

SCENE = "cornell8"
PT_SCENES = {"kernel": "cornell8", "plain": "smallpt9"}  # the JAX bench's cells
PT_RR_DEPTH = 5


def make_step(renderer, fwd_only, rays_planes, scene, *, bounces):
    """One step of the main path on ``rays_planes`` [6, N] (float32, on
    the device) -> a callable returning (value, grads).

    kernel: colors through ``RenderReferenceFn``; with backward, the
      gradient of colors.sum() w.r.t. the [10, S] scene planes.
    plain:  colors through ``megakernel.render_reference_impl``; with
      backward, torch autograd to albedo, emission, center and r2 (the
      last two are exact zeros).
    """
    import torch

    from ascendpathtracing_tpu_torch import convert
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk

    device = rays_planes.device
    if renderer == "kernel":
        planes = convert.scene_planes_from_numpy(scene.soa10(), device=device)
        if fwd_only:
            def step():
                return rk.render_reference_planes(
                    rays_planes, planes, light_index=scene.light_index,
                    bounces=bounces,
                ), ()
            return step
        p = planes.requires_grad_(True)
        render = rk.make_render_reference_diff(
            light_index=scene.light_index, bounces=bounces, replay=True
        )

        def step():
            loss = render(rays_planes, p).sum()
            return loss, torch.autograd.grad(loss, (p,))
        return step

    if renderer != "plain":
        raise ValueError(f"unknown renderer {renderer!r}")
    dev = megakernel.scene_to_device(scene, device=device)
    rays = rays_planes.T  # [N, 6] view whose columns are the contiguous planes
    if fwd_only:
        def step():
            with torch.no_grad():
                return megakernel.render_reference_impl(rays, dev, bounces=bounces), ()
        return step
    keys = ("albedo", "emission", "center", "r2")
    params = {k: dev[k].clone().requires_grad_(True) for k in keys}

    def step():
        loss = megakernel.render_reference_impl(
            rays, {**dev, **params}, bounces=bounces
        ).sum()
        # center and r2 reach the colors only through discrete winners, so
        # they are not in the backward graph; their gradient is exactly 0.
        return loss, torch.autograd.grad(
            loss, tuple(params.values()), materialize_grads=True
        )
    return step


def make_pt_step(renderer, fwd_only, scene, *, device, bounces, width=1024,
                 height=1024, spp4=64, rays=None):
    """One step of the path-tracing cells -> a callable returning (value,
    grads).

    kernel: the fused kernel at width x height x spp4 samples, seed 0 ->
      per-pixel means [3, W*H]; forward only.
    plain:  ``megakernel.render_pt_impl`` on ``rays`` [N, 6] with a new
      seed every step (the JAX bench folds the step into its key); with
      backward, torch autograd of the sum to albedo, emission, center and
      r2.
    """
    import torch

    from ascendpathtracing_tpu_torch import convert
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.ops import pt_kernels

    if renderer == "kernel":
        planes = convert.scene_planes_from_numpy(scene.soa10(), device=device)
        materials = torch.tensor(scene.material, dtype=torch.int32, device=device)

        def step():
            return pt_kernels.render_pt(
                planes, materials, width=width, height=height, spp4=spp4,
                bounces=bounces, rr_depth=PT_RR_DEPTH, seed=0,
            ), ()
        return step

    if renderer != "plain":
        raise ValueError(f"unknown renderer {renderer!r}")
    dev = megakernel.scene_to_device(scene, device=device)
    mats = tuple(int(m) for m in scene.material)
    keys = ("albedo", "emission", "center", "r2")
    params = {k: dev[k].clone().requires_grad_(not fwd_only) for k in keys}
    seeds = iter(range(1 << 30))

    def step():
        with torch.set_grad_enabled(not fwd_only):
            loss = megakernel.render_pt_impl(
                rays, {**dev, **params}, bounces=bounces, rr_depth=PT_RR_DEPTH,
                materials_static=mats, seed=next(seeds),
            ).sum()
            if fwd_only:
                return loss, ()
            return loss, torch.autograd.grad(loss, tuple(params.values()))
    return step


def mesh_scene(subdiv: int):
    """The mesh cells' scene: an icosphere of ``subdiv`` subdivisions at
    (50, 40, 60), radius 14, albedo (0.85, 0.55, 0.2), in smallpt9."""
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.models.mesh import MeshScene

    v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=subdiv)
    return MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2), base_scene="smallpt9")


def make_mesh_step(renderer, ms, *, device, bounces, width=1024, height=1024,
                   spp4=64, tris_per_chunk=16, fwd_only=True):
    """One step of the mesh cell -> (a callable returning (value, grads),
    the NumPy chunk grid).

    fwd_only: the per-pixel means [3, W*H] and no grads.  kernel: the
      fused sphere+mesh kernel; plain: its plain twin.
    otherwise: image.sum() and its gradients to (scene planes [10, S],
      slot albedo [CT, 3], slot emission [CT, 3]).  kernel:
      ``make_render_pt_mesh_diff`` (the kernel forward with residuals,
      the replay through the rows and segment-sum kernels); plain: the
      twin forward with residuals and the replay with the plain rows and
      segment-sum.
    """
    import torch

    from ascendpathtracing_tpu_torch.diff import mesh_fused
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt

    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(
        ms, tris_per_chunk=tris_per_chunk, device=device
    )
    if renderer not in ("kernel", "plain"):
        raise ValueError(f"unknown renderer {renderer!r}")
    grid_kw = mpt.pt_tables_kwargs(grid, device)
    kw = dict(materials=mats, width=width, height=height, spp4=spp4,
              bounces=bounces, rr_depth=PT_RR_DEPTH, seed=0, **grid_kw)
    if fwd_only:
        render = mpt.render_pt_mesh if renderer == "kernel" else mpt.render_pt_mesh_plain

        def step():
            return render(planes, cb, sb, t24, **kw), ()
        return step, grid

    n_slots = t24.shape[0]
    if renderer == "kernel":
        render = mesh_fused.make_render_pt_mesh_diff(
            cb, sb, t24[:, :16], t24[:, 22:24], width=width, height=height,
            spp4=spp4, materials=mats, bounces=bounces, rr_depth=PT_RR_DEPTH,
            seed=0, **grid_kw)
        leaves = (planes.clone().requires_grad_(True),
                  t24[:, 16:19].clone().requires_grad_(True),
                  t24[:, 19:22].clone().requires_grad_(True))

        def step():
            loss = render(*leaves).sum()
            return loss, torch.autograd.grad(loss, leaves)
        return step, grid

    def step():
        img, wid, resv = mpt.render_pt_mesh_plain(planes, cb, sb, t24,
                                                  with_residuals=True, **kw)
        grads = mesh_fused.replay_backward(
            wid, resv, torch.ones_like(img), n_spheres=planes.shape[1],
            n_slots=n_slots, spp4=spp4, plain=True)
        return img.sum(), grads
    return step, grid


def make_xla_mesh_step(ms, *, device, traversal, bounces, width=1024, height=1024,
                       spp4=4, tris_per_chunk=16, fwd_only=True):
    """One step of the bounce-loop mesh cell -> (a callable returning
    (value, grads), the device tables).  Rays: ``generate_rays_numpy(
    width, height, spp4 // 4, seed=0)``; each step draws with the next
    seed.  fwd_only: the colors [N, 3] and no grads; otherwise the sum of
    the colors and its gradients to (vertices, face albedo, face
    emission)."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import camera
    from ascendpathtracing_tpu_torch.diff import mesh as dmesh
    from ascendpathtracing_tpu_torch.models import mesh as mesh_mod

    mdev = mesh_mod.mesh_scene_to_device(ms, device=device, pallas_bvh_kernel=True,
                                         pallas_kernel=traversal,
                                         tris_per_chunk=tris_per_chunk)
    rays = torch.tensor(camera.generate_rays_numpy(width, height, spp4 // 4, seed=0)
                        .astype(np.float32), device=device)
    seeds = iter(range(1 << 30))
    kw = dict(bounces=bounces, rr_depth=PT_RR_DEPTH)
    if fwd_only:
        def step():
            return mesh_mod.render_pt_mesh(rays, mdev, seed=next(seeds), **kw), ()
        return step, mdev
    if traversal != "chunks":
        raise ValueError(f"the {traversal} traversal has no differentiable step "
                         "(diff/mesh.build_traced_dev refuses the BVH's leaf order)")
    params = {k: v.requires_grad_(True)
              for k, v in dmesh.mesh_params(ms, device=device).items()}
    faces = torch.tensor(ms.faces, device=device)

    def step():
        loss = dmesh.render_pt_mesh_params(rays, params, mdev, faces, seed=next(seeds),
                                           **kw).sum()
        return loss, torch.autograd.grad(loss, tuple(params.values()))
    return step, mdev


def make_wavefront_step(mode, *, device, bounces, width=1024, height=1024, spp4=64,
                        pool=1 << 19, subdiv=4, tris_per_chunk=16):
    """One frame of a wavefront cell -> a callable returning (per-pixel
    means [W*H, 3], ()), a new seed every call.  pt: cornell8; mesh: the
    mesh cell's scene (:func:`mesh_scene`) on chunk-grid tables."""
    from ascendpathtracing_tpu_torch import scenes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.models import mesh as mesh_mod
    from ascendpathtracing_tpu_torch.models import wavefront

    kw = dict(width=width, height=height, spp4=spp4, pool=pool, bounces=bounces,
              rr_depth=PT_RR_DEPTH)
    seeds = iter(range(1 << 30))
    if mode == "pt":
        sc = megakernel.scene_to_device(scenes.get_scene(PT_SCENES["kernel"]), device=device)
        return lambda: (wavefront.render_wavefront(next(seeds), sc, **kw), ())
    if mode != "mesh":
        raise ValueError(f"no wavefront cell for mode {mode!r}")
    mdev = mesh_mod.mesh_scene_to_device(mesh_scene(subdiv), device=device,
                                         pallas_bvh_kernel=True,
                                         tris_per_chunk=tris_per_chunk)
    return lambda: (wavefront.render_wavefront_mesh(next(seeds), mdev, **kw), ())


def time_steps(step, *, iters, warmup):
    """Runs ``warmup`` untimed steps, then ``iters`` steps each between two
    CUDA events -> (step times in ms, the last step's result)."""
    import torch

    for _ in range(warmup):
        out = step()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times, out


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_steps(step, *, iters, top=8):
    """Runs ``iters`` steps under torch.profiler -> busy/idle summary of
    the device (times in ms, per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "steps": iters,
        "wall_ms_per_step": wall_us / iters / 1e3,
        "device_busy_ms_per_step": busy / iters / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "device_events_per_step": len(dev) / iters,
        "top_device_ms_per_step": [[name[:80], us / iters / 1e3] for name, us in ranked],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ascendpathtracing_tpu_torch.bench")
    p.add_argument("--rays", type=int, default=1 << 22, help="primary rays per step")
    p.add_argument("--iters", type=int, default=10, help="timed steps (>= 10)")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--renderer", choices=["kernel", "plain", "xla", "wavefront"],
                   default="kernel",
                   help="xla: the bounce-loop mesh renderer (--mode mesh only); "
                   "wavefront: the pool streaming renderers (--mode pt or mesh)")
    p.add_argument("--traversal", choices=["chunks", "lockstep"], default="chunks",
                   help="--renderer xla: the traversal kernel")
    p.add_argument("--mode", choices=["reference", "pt", "mesh"], default="reference")
    p.add_argument("--spp", type=int, default=64,
                   help="pt kernel and mesh: samples per pixel (spp4, a multiple of 4)")
    p.add_argument("--subdiv", type=int, default=4,
                   help="mesh: icosphere subdivisions (tris = 20*4^s: 4 -> 5,120)")
    p.add_argument("--chunk-tris", type=int, default=16,
                   help="mesh: triangles per chunk")
    p.add_argument("--pool", type=int, default=1 << 19, help="wavefront: rays in the pool")
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="also run the steps under torch.profiler (detail.profile)")
    args = p.parse_args(argv)
    if args.iters < 10:
        p.error("--iters must be >= 10 for a median")
    if args.renderer == "xla" and args.mode != "mesh":
        p.error("--renderer xla needs --mode mesh")
    if args.renderer == "wavefront" and args.mode == "reference":
        p.error("--renderer wavefront needs --mode pt or mesh")
    if args.renderer == "xla" and args.traversal == "lockstep" and not args.fwd_only:
        print("error: --traversal lockstep is forward only: diff/mesh refuses the BVH's "
              "leaf order (pass --fwd-only)", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import convert
    from ascendpathtracing_tpu_torch.device import (
        gpu_name_and_power_limit,
        resolve_device,
    )
    from ascendpathtracing_tpu_torch import camera, scenes

    try:
        device = resolve_device("cuda")
    except RuntimeError as e:
        print(f"error: {e}; the benchmark measures only on a CUDA device",
              file=sys.stderr)
        return 2

    # Square image covering the ray count (n = w*h*4 at 1 sample).
    w = h = int(np.sqrt(args.rays / 4))
    n = w * h * 4
    rays = camera.generate_rays_numpy(w, h, 1, seed=0).astype(np.float32)
    extra = {}
    if args.renderer == "wavefront":
        from ascendpathtracing_tpu_torch.ops import histogram_kernels, wbvh_kernels

        fwd_only = True
        step = make_wavefront_step(args.mode, device=device, bounces=args.bounces, width=w,
                                   height=h, spp4=args.spp, pool=args.pool,
                                   subdiv=args.subdiv, tris_per_chunk=args.chunk_tris)
        n = w * h * args.spp
        scene_name = (f"mesh-icosphere s{args.subdiv}" if args.mode == "mesh"
                      else PT_SCENES["kernel"])
        extra = {"mode": args.mode, "width": w, "height": h, "spp4": args.spp,
                 "rr_depth": PT_RR_DEPTH, "pool": args.pool}
        if args.mode == "mesh":
            extra.update(traversal="chunks", tris_per_chunk=args.chunk_tris)
        counted = [wbvh_kernels, histogram_kernels]
    elif args.mode == "mesh" and args.renderer == "xla":
        from ascendpathtracing_tpu_torch.ops import bvh_kernels, histogram_kernels, wbvh_kernels

        fwd_only = args.fwd_only
        spp4 = min(args.spp, 4)
        ms = mesh_scene(args.subdiv)
        step, mdev = make_xla_mesh_step(
            ms, device=device, traversal=args.traversal, bounces=args.bounces, width=w,
            height=h, spp4=spp4, tris_per_chunk=args.chunk_tris, fwd_only=fwd_only)
        scene_name = f"mesh-icosphere s{args.subdiv}"
        n = w * h * spp4
        conf = mdev["static"]
        extra = {"mode": "mesh", "traversal": conf.traversal, "width": w, "height": h,
                 "spp4": spp4, "rr_depth": PT_RR_DEPTH, "tris": int(ms.faces.shape[0]),
                 "tris_per_chunk": conf.tris_per_chunk, "max_leaf": conf.max_leaf}
        counted = [wbvh_kernels, bvh_kernels, histogram_kernels]
    elif args.mode == "mesh":
        from ascendpathtracing_tpu_torch.ops import histogram_kernels, mesh_pt_kernels
        from ascendpathtracing_tpu_torch.ops import replay_kernels

        scene_name = f"mesh-icosphere s{args.subdiv}"
        fwd_only = args.fwd_only
        step, grid = make_mesh_step(
            args.renderer, mesh_scene(args.subdiv), device=device,
            bounces=args.bounces, width=w, height=h, spp4=args.spp,
            tris_per_chunk=args.chunk_tris, fwd_only=fwd_only,
        )
        n = w * h * args.spp
        extra = {"mode": "mesh", "width": w, "height": h, "spp4": args.spp,
                 "rr_depth": PT_RR_DEPTH, "tris": int((grid.face_of_slot >= 0).sum()),
                 "tris_per_chunk": args.chunk_tris, "chunks": grid.n_chunks,
                 "supers": grid.n_supers, "supers2": grid.n_supers2}
        counted = [mesh_pt_kernels, histogram_kernels, replay_kernels]
    elif args.mode == "pt":
        from ascendpathtracing_tpu_torch.ops import pt_kernels

        scene_name = PT_SCENES[args.renderer]
        fwd_only = args.fwd_only or args.renderer == "kernel"
        step = make_pt_step(
            args.renderer, fwd_only, scenes.get_scene(scene_name), device=device,
            bounces=args.bounces, width=w, height=h, spp4=args.spp,
            rays=torch.tensor(rays, device=device),
        )
        if args.renderer == "kernel":
            n = w * h * args.spp
            extra = {"width": w, "height": h, "spp4": args.spp}
        extra.update(mode="pt", rr_depth=PT_RR_DEPTH)
        counted = [pt_kernels]
    else:
        from ascendpathtracing_tpu_torch.ops import render_kernels

        counted = [render_kernels]
        scene_name = SCENE
        fwd_only = args.fwd_only
        step = make_step(args.renderer, fwd_only,
                         convert.rays_planes_from_numpy(rays, device=device),
                         scenes.get_scene(SCENE), bounces=args.bounces)
    for mod in counted:
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, _ = time_steps(step, iters=args.iters, warmup=args.warmup)
    steps = args.iters + args.warmup
    extra["launches_per_step"] = {key: count / steps for mod in counted
                                  for key, count in mod.LAUNCHES.items() if count}
    extra["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    if args.renderer == "wavefront":
        from ascendpathtracing_tpu_torch.models import wavefront

        iters = wavefront.STATS["iterations"]  # the last step's; every step's alike
        extra.update(iterations_per_step=iters, ms_per_iteration=med / max(iters, 1))
    profile = profile_steps(step, iters=args.iters) if args.profile else None
    tag = "fwd" if fwd_only else "fwd+bwd"
    samples = (args.mode == "mesh" or args.renderer == "wavefront"
               or (args.mode == "pt" and args.renderer == "kernel"))
    what = "samples" if samples else "rays"
    # The mesh cell's unit is named for what it counts; the pt and
    # wavefront cells keep the JAX bench's Mrays/s key for their samples.
    unit = "Msamples/s" if args.mode == "mesh" and args.renderer != "wavefront" else "Mrays/s"
    cell = f"{scene_name}, pt" if args.mode != "reference" else scene_name
    if args.renderer == "xla":
        cell += f", {args.traversal}"
    print(json.dumps({
        "metric": f"{unit} {tag} @ {args.bounces} bounces "
                  f"({cell}, cuda {args.renderer})",
        "value": n / (med * 1e-3) / 1e6,
        "unit": unit,
        "detail": {
            "backend": "cuda",
            "gpu": gpu_name_and_power_limit(),
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "renderer": args.renderer,
            f"{what}_per_step": n,
            "bounces": args.bounces,
            **extra,
            "step_ms_median": med,
            "step_ms": times,
            "warmup": args.warmup,
            **({"profile": profile} if profile else {}),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
