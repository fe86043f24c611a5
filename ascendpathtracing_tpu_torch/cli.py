"""Command-line interface of the port.

Usage:
    python -m ascendpathtracing_tpu_torch.cli render \
        --width 256 --height 256 --bounces 8 --backend cuda --out output/
    python -m ascendpathtracing_tpu_torch.cli selftest --backend cuda

    python -m ascendpathtracing_tpu_torch.cli render --mode pt \
        --renderer plain --backend cuda --samples 4 --out output/
    python -m ascendpathtracing_tpu_torch.cli render --mode pt \
        --scene mesh-icosphere --renderer kernel --backend cuda --out output/

``--backend cuda`` requires a CUDA device and exits 2 without one;
``--backend cpu`` runs on the CPU.  Nothing reroutes to another device.
``--renderer kernel`` (default) goes through the kernel wrappers in
``ops/`` (the CUDA kernels on a card, their plain twins on the CPU);
``--renderer plain`` runs the plain-torch ``models/megakernel`` path.
``--mode pt`` (default scene smallpt9) is the plain path-tracing
estimator, with ``--nee`` for next-event estimation; like the JAX CLI's
``--renderer pallas``, ``--renderer kernel`` takes reference mode only,
except on mesh scenes (``--scene mesh-cube``, ``mesh-icosphere``,
``mesh-obj:<path>``; ``--mode pt`` only), which it renders with the fused
sphere+mesh path tracer (``ops/mesh_pt_kernels``).  Random numbers come
from the port's Philox stream keyed by ``--seed``, so path-traced images
match the JAX package's only statistically.

Artifacts, in the JAX package's formats (shared ``utils/io``):
  <out>/rays.bin  <out>/spheres.bin  <out>/color.bin  <out>/color.ppm
  with --aov: <out>/depth.ppm  <out>/normal.ppm  <out>/albedo.ppm
A fused mesh render's and a wavefront render's color.bin hold each
pixel's mean repeated over its 4 * samples slots, as the JAX CLI writes
them; the bounce-loop renderers' hold one color per ray.

Mesh scenes with ``--renderer plain`` go through the bounce-loop mesh
renderer (``models/mesh.render_pt_mesh_impl``): the chunk-grid traversal
kernel on a card, the per-ray BVH walk (``jnp`` mode) with ``--backend
cpu``, as the JAX CLI's jit renderer picks its traversal.

``--renderer wavefront`` (``--mode pt`` only, sphere and mesh scenes) is
the pool streaming renderer (``models/wavefront``): a pool of
min(2**18, total samples rounded up to 2,048) rays, the image scatter
through the segment-sum kernel; on a card, mesh scenes take the
chunk-grid traversal kernel, on the CPU the per-ray BVH walk.

Post-processing, as the JAX CLI's (``post``, on the render's device):
``--clamp L`` bounds each sample's luminance, the image is decoded to
HDR, ``--denoise N`` runs N a-trous levels (guided by the first-hit
G-buffer on sphere scenes), ``--tonemap reinhard|aces`` maps it with
``--exposure``; the result is <out>/final.ppm.  ``--check-finite`` fails
the render (exit 1) where a color is NaN or inf (``utils.debug``).

    python -m ascendpathtracing_tpu_torch.cli train --backend cuda \
        --width 1024 --height 1024 --bounces 8 --steps 40 --ckpt out/ckpt.npz
    python -m ascendpathtracing_tpu_torch.cli oracle --out output/

``train`` is the JAX CLI's inverse-rendering demo: cornell8, albedo
perturbed by +0.08, plain SGD on the scene parameters through the
reference kernels' forward with winners and replay backward
(``parallel/sharded.make_train_step``), a checkpoint every
``--ckpt-every`` steps and at the end, ``--resume`` from it.  ``oracle``
runs only the NumPy oracle (oracle_color.bin, oracle_color.ppm).

``render --shard N`` (reference mode, the kernel renderer) renders the
rays DP x TP over a mesh of N ranks (``parallel.make_mesh(N)``: (2, 2)
for 4) and gathers the colors (``parallel.gather_colors``); the
artifacts and the JSON line come from rank 0 alone.  Under torchrun with
``WORLD_SIZE`` = N the command's processes are the ranks; run alone, it
spawns N local ranks on ``--backend``'s device
(``parallel/distributed.run_local_world``: several ranks on one card
share it over gloo).  N must divide the ray count (4 a pixel and
sample), or the command exits 2.

    python -m ascendpathtracing_tpu_torch.cli render --shard 2 --backend cuda
    torchrun --nproc-per-node 4 -m ascendpathtracing_tpu_torch.cli render --shard 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="ascendpathtracing_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene end-to-end")
    r.add_argument("--width", type=int, default=16)
    r.add_argument("--height", type=int, default=16)
    r.add_argument("--samples", type=int, default=1)
    r.add_argument("--bounces", type=int, default=5)
    r.add_argument("--mode", choices=["reference", "pt"], default="reference")
    r.add_argument("--scene", default=None, help="default: cornell8")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    r.add_argument("--renderer", choices=["kernel", "plain", "wavefront"],
                   default="kernel")
    r.add_argument("--out", default="output")
    r.add_argument("--nee", action="store_true")
    r.add_argument("--aov", choices=["none", "depth", "normal", "albedo", "gbuffer"],
                   default="none")
    r.add_argument("--denoise", type=int, default=0, metavar="ITERS")
    r.add_argument("--tonemap", choices=["none", "reinhard", "aces"], default="none")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--clamp", type=float, default=0.0, metavar="L")
    r.add_argument("--check-finite", action="store_true",
                   help="fail if the render produced NaN/Inf")
    r.add_argument("--shard", type=int, default=0, metavar="N")
    r.add_argument("--oracle", action="store_true",
                   help="also run the NumPy oracle and report parity")

    t = sub.add_parser(
        "train",
        help="inverse-rendering demo: recover perturbed scene albedo from "
        "a target render (exercises the differentiable pass + checkpoint)",
    )
    t.add_argument("--width", type=int, default=32)
    t.add_argument("--height", type=int, default=32)
    t.add_argument("--bounces", type=int, default=3)
    t.add_argument("--steps", type=int, default=50)
    t.add_argument("--lr", type=float, default=0.05)
    t.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    t.add_argument("--ckpt", default="output/ckpt.npz")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--ckpt-every", type=int, default=20)

    st = sub.add_parser("selftest", help="quick correctness checks of the "
                        "ported compute paths on the chosen backend")
    st.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")

    o = sub.add_parser("oracle", help="run only the NumPy oracle")
    o.add_argument("--width", type=int, default=16)
    o.add_argument("--height", type=int, default=16)
    o.add_argument("--samples", type=int, default=1)
    o.add_argument("--bounces", type=int, default=5)
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--scene", default="cornell8")
    o.add_argument("--out", default="output")
    return p.parse_args(argv)


def _device(name: str):
    """The requested torch device, or None after printing why not."""
    from ascendpathtracing_tpu_torch.device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def cmd_render(args) -> int:
    from ascendpathtracing_tpu_torch import config

    try:
        config.RenderConfig(
            width=args.width, height=args.height, samples=args.samples,
            bounces=args.bounces, mode=args.mode,
        ).validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    mesh = args.scene is not None and args.scene.startswith("mesh-")
    if mesh and args.mode != "pt":
        print("error: mesh scenes require --mode pt", file=sys.stderr)
        return 2
    if args.renderer == "wavefront" and args.mode != "pt":
        # The JAX CLI's refusal (cli.py:183-186).
        print("error: --renderer wavefront is a path-tracing renderer "
              "(use --mode pt)", file=sys.stderr)
        return 2
    if not mesh and args.renderer == "kernel" and args.mode != "reference":
        # The JAX CLI's refusal for its kernel renderer (cli.py:253-256).
        print("error: --renderer kernel supports --mode reference only",
              file=sys.stderr)
        return 2
    if args.shard > 0:
        refusal = _shard_refusal(args, mesh)
        if refusal:
            print(f"error: {refusal}", file=sys.stderr)
            return 2
    mesh_scene = None
    if mesh:
        try:
            mesh_scene = _mesh_scene(args.scene[len("mesh-"):])
        # RuntimeError: the native OBJ loader's IO failure (a missing file)
        except (OSError, ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if mesh_scene is None:
            print(f"error: unknown mesh scene {args.scene!r} "
                  "(mesh-cube, mesh-icosphere, mesh-obj:<path>)", file=sys.stderr)
            return 2
    torchrun_rank = None  # this process's rank when torchrun started the --shard world
    if args.shard > 0 and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ascendpathtracing_tpu_torch.parallel import distributed

        try:
            device = distributed.initialize(args.backend)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        torchrun_rank = int(os.environ["RANK"])
    else:
        device = _device(args.backend)
    if device is None:
        return 2

    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import convert
    from ascendpathtracing_tpu_torch import camera, oracle, scenes
    from ascendpathtracing_tpu_torch.utils import io
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.ops import render_kernels

    scene_name = args.scene or ("cornell8" if args.mode == "reference" else "smallpt9")
    if mesh_scene is not None:
        scene = mesh_scene.spheres
    else:
        try:
            scene = scenes.get_scene(scene_name)
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2
    w, h, s = args.width, args.height, args.samples

    t0 = time.time()
    rays = camera.generate_rays_numpy(w, h, s, seed=args.seed).astype(np.float32)
    if torchrun_rank not in (None, 0):  # the other ranks render their shards; rank 0 writes
        shard_render_rank(rays, scene, args.bounces)
        return 0
    io.write_rays_bin(rays, f"{args.out}/rays.bin")
    io.write_spheres_bin(scene, f"{args.out}/spheres.bin")
    t_gen = time.time() - t0

    t0 = time.time()
    rays_t = torch.tensor(rays, device=device)
    dev = megakernel.scene_to_device(scene, device=device)
    if args.renderer == "wavefront":
        from ascendpathtracing_tpu_torch.models import mesh as mesh_mod
        from ascendpathtracing_tpu_torch.models import wavefront as wf_mod

        # the JAX CLI's pool (cli.py:227-251)
        pool = min(1 << 18, -(-w * h * 4 * s // 2048) * 2048)
        kw = dict(width=w, height=h, spp4=4 * s, pool=pool, bounces=args.bounces)
        if mesh_scene is not None:
            mdev = mesh_mod.mesh_scene_to_device(
                mesh_scene, device=device, pallas_bvh_kernel=device.type == "cuda")
            img3 = wf_mod.render_wavefront_mesh(args.seed, mdev, **kw)
        else:
            img3 = wf_mod.render_wavefront(args.seed, dev, **kw)
        # per-pixel means [W*H, 3] -> repeated over each pixel's 4*s slots
        colors = img3.repeat_interleave(4 * s, dim=0)
    elif mesh_scene is not None and args.renderer == "plain":
        from ascendpathtracing_tpu_torch.models import mesh as mesh_mod

        # the chunk-grid kernel on a card; the per-ray BVH walk on the CPU
        # (cli.py:287-296 of the JAX package)
        mdev = mesh_mod.mesh_scene_to_device(
            mesh_scene, device=device, pallas_bvh_kernel=device.type == "cuda")
        colors = mesh_mod.render_pt_mesh(rays_t, mdev, bounces=args.bounces, seed=args.seed)
    elif mesh_scene is not None:
        from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt

        planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(mesh_scene, device=device)
        img3 = mpt.render_pt_mesh(
            planes, cb, sb, t24, materials=mats, width=w, height=h, spp4=4 * s,
            bounces=args.bounces, seed=args.seed, **mpt.pt_tables_kwargs(grid, device),
        )
        # per-pixel means -> repeated over each pixel's 4*s slots, so
        # color.bin keeps its layout (decode averages them back)
        colors = img3.T.repeat_interleave(4 * s, dim=0)
    elif args.shard > 0:
        if torchrun_rank is None:
            from ascendpathtracing_tpu_torch.parallel.distributed import run_local_world

            sharded = run_local_world(shard_render_rank, args.shard, device=args.backend,
                                      args=(rays, scene, args.bounces))[0]
        else:
            sharded = shard_render_rank(rays, scene, args.bounces)
        colors = torch.as_tensor(sharded["colors"], device=device)
    elif args.mode == "pt":
        fn = megakernel.render_pt_nee_impl if args.nee else megakernel.render_pt_impl
        colors = fn(rays_t, dev, bounces=args.bounces, seed=args.seed)
    elif args.renderer == "kernel":
        colors = render_kernels.render_reference(
            rays_t,
            convert.scene_planes_from_numpy(scene.soa10(), device=device),
            light_index=scene.light_index,
            bounces=args.bounces,
        )
    else:
        colors = megakernel.render_reference_impl(rays_t, dev, bounces=args.bounces)
    colors_dev = colors
    colors = colors.cpu().numpy()
    t_render = time.time() - t0

    if args.check_finite:
        from ascendpathtracing_tpu_torch.utils.debug import NonFiniteRenderError, assert_finite

        try:
            assert_finite(colors, "render")
        except NonFiniteRenderError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    io.write_color_bin(colors, f"{args.out}/color.bin")
    # the native (C++) decode + encode where it builds, as the JAX CLI; in
    # float32, which the native codec reads, so the file and img agree
    img = io.write_render_ppm(colors.astype(np.float32, copy=False), w, h, s,
                              f"{args.out}/color.ppm")
    # the first-hit G-buffer of sphere scenes: AOVs and denoiser guides
    want_gbuf = (args.aov in ("normal", "albedo", "gbuffer")
                 or args.denoise > 0) and mesh_scene is None
    gbuf = megakernel.render_gbuffer_impl(rays_t, dev) if want_gbuf else None
    if args.aov != "none":
        _write_aovs(args.aov, gbuf, rays_t, dev, w, h, s, args.out)
    post_active = args.denoise > 0 or args.tonemap != "none" or args.clamp > 0
    if post_active:
        final = post_pipeline(colors_dev, gbuf, w, h, s, clamp=args.clamp,
                              denoise=args.denoise, tonemap=args.tonemap,
                              exposure=args.exposure)
        io.write_ppm(final, f"{args.out}/final.ppm")

    n_rays = rays.shape[0]
    stats = {
        "backend": device.type,
        "scene": scene_name,
        "mode": args.mode,
        "renderer": args.renderer,
        "rays": n_rays,
        "bounces": args.bounces,
        "gen_s": round(t_gen, 4),
        "render_s": round(t_render, 4),
        # Primary rays per second, end to end on the host clock (includes
        # the first call's kernel build and the copy back); bench.py
        # measures the device step.
        "mrays_per_s": round(n_rays / max(t_render, 1e-9) / 1e6, 3),
        "mray_bounces_per_s": round(
            n_rays * args.bounces / max(t_render, 1e-9) / 1e6, 3
        ),
        "out": f"{args.out}/color.ppm",
    }
    if post_active:
        stats["final"] = f"{args.out}/final.ppm"
    if args.shard > 0:
        stats.update(shard=args.shard, mesh=sharded["mesh"], dist_backend=sharded["backend"])
    if args.oracle and args.mode == "reference":
        exp = oracle.render_reference_numpy(rays, scene, bounces=args.bounces)
        img_o = io.decode_color(exp, w, h, s)
        stats["oracle_rays_bitexact"] = float((np.abs(exp - colors).max(1) == 0).mean())
        stats["oracle_img_equal_pix"] = float((img_o == img).all(axis=-1).mean())
    print(json.dumps(stats))
    return 0


def _shard_refusal(args, mesh: bool) -> str | None:
    """Why ``render --shard N`` cannot run as asked, or None."""
    if args.mode != "reference" or mesh or args.renderer != "kernel":
        return "--shard renders --mode reference with --renderer kernel"
    n_rays = args.width * args.height * args.samples * 4
    if n_rays % args.shard:
        return f"--shard N must divide the ray count ({n_rays} rays, N = {args.shard})"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and world != args.shard:
        return f"--shard {args.shard} under a launcher needs WORLD_SIZE = {args.shard}, not {world}"
    return None


def shard_render_rank(rays, scene, bounces: int):
    """One rank of ``render --shard``: this rank's shard of the rays
    [N, 6] (NumPy) through ``parallel.render_reference_sharded`` on the
    default mesh, then the whole colors gathered to every rank -> on rank
    0, {"colors": [N, 3] NumPy, "mesh": {axis: size}, "backend": the
    process group's}; None on the others."""
    import torch
    import torch.distributed as dist

    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.parallel import (
        gather_colors, make_mesh, render_reference_sharded, shard_rays)
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device
    from ascendpathtracing_tpu_torch.parallel.mesh import mesh_shape

    dev = rank_device()
    mesh = make_mesh()
    colors = render_reference_sharded(
        shard_rays(torch.as_tensor(rays), mesh).to(dev),
        megakernel.scene_to_device(scene, device=dev), mesh, bounces=bounces)
    full = gather_colors(colors)
    if dist.get_rank() != 0:
        return None
    return {"colors": full, "mesh": mesh_shape(mesh), "backend": dist.get_backend()}


def _mesh_scene(kind: str):
    """The JAX CLI's mesh scenes (cli.py:147-166) -> MeshScene, or None
    for an unknown kind: a cube, an icosphere (1,280 triangles), or an
    OBJ file fitted into the Cornell box; albedo (0.85, 0.55, 0.2) in
    smallpt9."""
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.models.mesh import MeshScene

    if kind == "cube":
        v, f = meshes.cube(center=(50, 30, 60), size=25.0)
    elif kind == "icosphere":
        v, f = meshes.icosphere(center=(50, 40, 60), radius=14.0, subdivisions=3)
    elif kind.startswith("obj:"):
        v, f = meshes.load_obj(kind[len("obj:"):])
        lo, hi = v.min(axis=0), v.max(axis=0)
        scale = 28.0 / max(float((hi - lo).max()), 1e-9)
        v = meshes.transform(v - (lo + hi) / 2.0, scale=scale, translate=(50.0, 35.0, 60.0))
    else:
        return None
    return MeshScene.cornell_with_mesh(v, f, albedo=(0.85, 0.55, 0.2))


def _write_aovs(aov, gbuf, rays_t, dev, w, h, s, out) -> None:
    """First-hit AOV images, as the JAX CLI writes them (cli.py:313-338):
    depth.ppm (depth / its max; from the sphere first hit where there is
    no G-buffer), and from the G-buffer normal.ppm (normal * 0.5 + 0.5)
    and albedo.ppm; ``gbuffer`` writes all three."""
    import numpy as np

    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.utils import io

    if aov in ("depth", "gbuffer"):
        depth = (gbuf["depth"] if gbuf is not None
                 else megakernel.render_depth_impl(rays_t, dev)).cpu().numpy()
        dmax = max(float(depth.max()), 1e-9)
        io.write_ppm(
            io.decode_color(np.repeat((depth / dmax)[:, None], 3, axis=1), w, h, s),
            f"{out}/depth.ppm",
        )
    if gbuf is not None and aov in ("normal", "gbuffer"):
        io.write_ppm(
            io.decode_color(gbuf["normal"].cpu().numpy() * 0.5 + 0.5, w, h, s),
            f"{out}/normal.ppm",
        )
    if gbuf is not None and aov in ("albedo", "gbuffer"):
        io.write_ppm(
            io.decode_color(gbuf["albedo"].cpu().numpy(), w, h, s),
            f"{out}/albedo.ppm",
        )


def post_pipeline(colors, gbuf, w, h, s, *, clamp, denoise, tonemap, exposure):
    """The JAX CLI's post pipeline (cli.py:341-381) on the colors' device:
    firefly clamp of colors [N, 3] (``clamp`` > 0), decode to an HDR
    image, a-trous denoise (``denoise`` levels; guided by the G-buffer
    dict ``gbuf`` when given), tonemap ("none", "reinhard" or "aces") and
    gamma -> the uint8 [W, H, 3] image of final.ppm."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import post
    from ascendpathtracing_tpu_torch.utils import io

    device = colors.device

    def to_dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    if clamp > 0:
        colors = post.firefly_clamp(colors, max_radiance=clamp)
    hdr = to_dev(io.decode_color_hdr(colors.cpu().numpy(), w, h, s))
    if denoise > 0:
        guides = {}
        if gbuf is not None:
            nrm = io.decode_color_hdr(gbuf["normal"].cpu().numpy(), w, h, s)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
            zplanes = np.repeat(gbuf["depth"].cpu().numpy()[:, None], 3, axis=1)
            guides = {
                "normal": to_dev(nrm),
                "depth": to_dev(io.decode_color_hdr(zplanes, w, h, s)[..., 0]),
                "albedo": to_dev(io.decode_color_hdr(gbuf["albedo"].cpu().numpy(), w, h, s)),
            }
        hdr = post.atrous_denoise(hdr, iterations=denoise, **guides)
    if tonemap == "aces":
        return post.to_u8(post.gamma_encode(post.tonemap_aces(hdr, exposure)))
    if tonemap == "reinhard":
        return post.to_u8(post.gamma_encode(post.tonemap_reinhard(hdr, exposure)))
    return post.to_u8(torch.clamp(hdr, 0.0, 1.0))


def pt_energy_check(device) -> dict:
    """Selftest check 4 (the JAX CLI's cli.py:488-521): the fused path
    tracer (``ops/pt_kernels.render_pt``: the CUDA kernel on a card, its
    plain twin on the CPU) against the plain estimator, mean energy on
    cornell8 at 64x64, spp4 = 32, 4 bounces, RR from 3.  The two draw
    independent random streams; their means must agree within 2.5%
    relative."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import convert
    from ascendpathtracing_tpu_torch import camera, scenes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.ops import pt_kernels

    scene = scenes.cornell8()
    w = h = 64
    spp4 = 32
    img = pt_kernels.render_pt(
        convert.scene_planes_from_numpy(scene.soa10(), device=device),
        torch.tensor(scene.material, dtype=torch.int32, device=device),
        width=w, height=h, spp4=spp4, bounces=4, rr_depth=3,
    )
    rays = camera.generate_rays_numpy(w, h, spp4 // 4, seed=0).astype(np.float32)
    est = megakernel.render_pt_impl(
        torch.tensor(rays, device=device),
        megakernel.scene_to_device(scene, device=device), bounces=4, rr_depth=3,
        materials_static=tuple(int(m) for m in scene.material),
    )
    mp, mj = float(img.mean()), float(est.mean())
    rel = abs(mp - mj) / max(mj, 1e-9)
    return {"ok": rel < 0.025 and np.isfinite(mp), "fused_mean": mp,
            "plain_mean": mj, "rel_diff": rel}


def wbvh_check(device) -> dict:
    """Selftest check 5 (the JAX CLI's cli.py:523-560): the chunk-grid
    traversal (``ops/wbvh_kernels.intersect_chunks``: the CUDA kernel on a
    card, its plain twin on the CPU) against brute force, 1,024 random
    rays from radius 3 at the unit icosphere (320 triangles, 32 per
    chunk): the same hit set and t within 1e-3."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch.accel import tri
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.ops import chunk_grid, wbvh_kernels

    v32, fcs = meshes.icosphere(subdivisions=2)
    v32 = np.asarray(v32, np.float32)
    rng = np.random.RandomState(0)
    n = 1024
    o = rng.randn(3, n).astype(np.float32)
    o /= np.linalg.norm(o, axis=0)
    o *= 3.0
    d = rng.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    rp = torch.tensor(np.concatenate([o, d], 0), device=device)
    planes = [tuple(torch.tensor(c, device=device) for c in p)
              for p in tri.triangle_planes(v32, fcs, dtype=np.float32)]
    bt = tri.intersect_triangles_brute(tuple(rp[0:3]), tuple(rp[3:6]), *planes,
                                       1e-4).amin(dim=0).cpu().numpy()
    grid = chunk_grid.build_chunk_grid(v32, fcs, tris_per_chunk=32)
    cb, sb, t13, _ = chunk_grid.chunk_grid_to_device(grid, device)
    tmin, _ = wbvh_kernels.intersect_chunks(rp, cb, sb, t13, tris_per_chunk=32)
    tmin = tmin.cpu().numpy()
    hitm = bt < 1e19
    same_set = bool(((tmin >= 1e19) == ~hitm).all())
    terr = float(np.abs(tmin[hitm] - bt[hitm]).max()) if hitm.any() else 0.0
    return {"ok": same_set and terr < 1e-3, "hit_frac": float(hitm.mean()),
            "max_t_err": terr, "device": device.type}


def mesh_xla_energy_check(device) -> dict:
    """Selftest check 6 (the JAX CLI's cli.py:562-592): the fused mesh
    path tracer (``ops/mesh_pt_kernels.render_pt_mesh``) against the
    bounce-loop mesh renderer (``models/mesh.render_pt_mesh``, chunks
    mode), mean energy on an icosphere s2 in smallpt9 at 64x64, spp4 32,
    4 bounces, RR from 3 (the CUDA kernels on a card, the twins on the
    CPU; both draw from the port's Philox streams).  The means must agree
    within 3% relative, ~3x the Monte-Carlo floor at this sample count."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import bench, camera
    from ascendpathtracing_tpu_torch.models import mesh as mesh_mod
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt

    ms = bench.mesh_scene(2)
    w = h = 64
    spp4 = 32
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(ms, device=device)
    img_f = mpt.render_pt_mesh(planes, cb, sb, t24, width=w, height=h, spp4=spp4,
                               materials=mats, bounces=4, rr_depth=3,
                               **mpt.pt_tables_kwargs(grid, device))
    rays = camera.generate_rays_numpy(w, h, spp4 // 4, seed=0).astype(np.float32)
    mdev = mesh_mod.mesh_scene_to_device(ms, device=device, pallas_bvh_kernel=True)
    img_x = mesh_mod.render_pt_mesh(torch.tensor(rays, device=device), mdev, bounces=4,
                                    rr_depth=3)
    mf, mx = float(img_f.mean()), float(img_x.mean())
    rel = abs(mf - mx) / max(mx, 1e-9)
    return {"ok": rel < 0.03 and np.isfinite(mf), "fused_mean": mf, "xla_mean": mx,
            "rel_diff": rel}


def mesh_vjp_check(device) -> dict:
    """Selftest check ``mesh_fused_vjp_grads`` (the JAX CLI's
    cli.py:594-619): the fused mesh render's replay backward
    (``diff/mesh_fused``: the CUDA kernels on a card, the plain twins on
    the CPU) on an icosphere s2 in smallpt9 at 32x32, spp4 8, 4 bounces,
    RR from 3.  The gradients of image.sum() must be finite, the
    geometry rows 0-3 of the scene planes exactly zero, and rows 4-9, the
    slot albedo and the slot emission gradients nonzero."""
    import torch

    from ascendpathtracing_tpu_torch import bench
    from ascendpathtracing_tpu_torch.diff import mesh_fused
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt

    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(bench.mesh_scene(2), device=device)
    render = mesh_fused.make_render_pt_mesh_diff(
        cb, sb, t24[:, :16], t24[:, 22:24], width=32, height=32, spp4=8,
        materials=mats, bounces=4, rr_depth=3, **mpt.pt_tables_kwargs(grid, device))
    leaves = (planes.clone().requires_grad_(True), t24[:, 16:19].clone().requires_grad_(True),
              t24[:, 19:22].clone().requires_grad_(True))
    gp, ga, ge = torch.autograd.grad(render(*leaves).sum(), leaves)
    finite = all(bool(torch.isfinite(x).all()) for x in (gp, ga, ge))
    geom_zero = float(gp[0:4].abs().max()) == 0.0
    ok = (finite and geom_zero and float(gp[4:10].abs().max()) > 0
          and float(ga.abs().max()) > 0 and float(ge.abs().max()) > 0)
    return {"ok": ok, "plane_grad_max": float(gp.abs().max()),
            "slot_albedo_grad_max": float(ga.abs().max()), "geom_rows_zero": geom_zero}


def cmd_selftest(args) -> int:
    """The JAX package's ``selftest`` on the chosen backend: plain path vs
    the NumPy oracle, kernel forward vs plain path, the kernel custom-VJP
    gradients vs plain autograd, the fused path tracer's energy vs the
    plain estimator's, the chunk-grid traversal vs brute force, the fused
    mesh path tracer's energy vs the bounce-loop mesh renderer's, the
    fused mesh render's replay gradients, and the float guards of
    ``utils/debug.checkify_render``.  One JSON line per check; exit 0 iff
    all pass."""
    device = _device(args.backend)
    if device is None:
        return 2

    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import convert
    from ascendpathtracing_tpu_torch import camera, oracle, scenes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk

    checks = []

    def report(name, ok, **detail):
        checks.append(bool(ok))
        print(json.dumps({"check": name, "ok": bool(ok), **detail}))

    scene = scenes.cornell8()
    rays = camera.generate_rays_numpy(16, 16, 1, seed=0).astype(np.float32)
    rays_t = torch.tensor(rays, device=device)
    planes = convert.scene_planes_from_numpy(scene.soa10(), device=device)
    rp = convert.rays_planes_from_numpy(rays, device=device)
    dev = megakernel.scene_to_device(scene, device=device)

    # 1. plain path vs NumPy oracle, 1 bounce (f32 is bitwise at 1 bounce).
    img = megakernel.render_reference_impl(rays_t, dev, bounces=1)
    ora = oracle.render_reference_numpy(rays, scene, bounces=1)
    err = float(np.abs(img.cpu().numpy() - ora).max())
    report("plain_vs_oracle_1bounce", err == 0.0, max_abs_err=err)

    # 2. kernel forward vs plain path, 1 bounce, bitwise.
    ker = rk.render_reference_planes(rp, planes, light_index=scene.light_index, bounces=1)
    err = float((ker.T - img).abs().max())
    report("kernel_fwd_vs_plain_1bounce", err == 0.0, max_abs_err=err,
           device=device.type)

    # 3. custom-VJP gradients vs plain autograd, 1 bounce.
    p = planes.clone().requires_grad_(True)
    render = rk.make_render_reference_diff(
        light_index=scene.light_index, bounces=1, replay=True
    )
    render(rp, p).sum().backward()
    gp = p.grad
    alb = dev["albedo"].clone().requires_grad_(True)
    emi = dev["emission"].clone().requires_grad_(True)
    megakernel.render_reference_impl(
        rays_t, dict(dev, albedo=alb, emission=emi), bounces=1
    ).sum().backward()
    ea = float((gp[7:10].T - alb.grad).abs().max())
    ee = float((gp[4:7].T - emi.grad).abs().max())
    eg = float(gp[0:4].abs().max())
    gref = float(alb.grad.abs().max())
    ok = ea <= 1e-4 * max(gref, 1.0) and ee <= 1e-3 and eg == 0.0
    report("custom_vjp_grads_vs_autograd_1bounce", ok, albedo_err=ea,
           emission_err=ee, geom_grads=eg)

    # 4. fused path tracer vs the plain estimator, mean energy.
    res = pt_energy_check(device)
    report("pt_fused_energy_vs_plain", res.pop("ok"), **res)

    # 5. chunk-grid traversal vs brute force.
    res = wbvh_check(device)
    report("wbvh_chunks_vs_brute", res.pop("ok"), **res)

    # 6. fused mesh path tracer vs the bounce-loop mesh renderer.
    res = mesh_xla_energy_check(device)
    report("mesh_pt_fused_energy_vs_xla", res.pop("ok"), **res)

    # 6b. the fused mesh render's replay backward.
    res = mesh_vjp_check(device)
    report("mesh_fused_vjp_grads", res.pop("ok"), **res)

    # 7. float guards over the plain renderer: they must pass a healthy
    #    render and catch an injected NaN (the JAX CLI's checkify check).
    from ascendpathtracing_tpu_torch.utils import debug as dbg

    checked = dbg.checkify_render(
        lambda r: megakernel.render_reference_impl(r, dev, bounces=2)
    )
    try:
        clean_ok = bool(torch.isfinite(checked(rays_t)).all())
    except dbg.NonFiniteRenderError:
        clean_ok = False
    bad_rays = rays.copy()
    bad_rays[0, 3] = np.nan  # poison one direction component
    try:
        checked(torch.tensor(bad_rays, device=device))
        caught = False
    except dbg.NonFiniteRenderError:
        caught = True
    report("checkify_float_guards", clean_ok and caught,
           clean_pass=clean_ok, nan_caught=caught)

    n_ok = sum(checks)
    print(json.dumps({"selftest": "PASS" if n_ok == len(checks) else "FAIL",
                      "passed": n_ok, "ran": len(checks),
                      "backend": device.type}))
    return 0 if n_ok == len(checks) else 1


def cmd_oracle(args) -> int:
    """The NumPy oracle alone (the JAX CLI's cli.py:657-672)."""
    import numpy as np

    from ascendpathtracing_tpu_torch import camera, oracle, scenes
    from ascendpathtracing_tpu_torch.utils import io

    scene = scenes.get_scene(args.scene)
    rays = camera.generate_rays_numpy(args.width, args.height, args.samples, seed=args.seed)
    colors = oracle.render_reference_numpy(
        rays.astype(np.float32), scene, bounces=args.bounces
    )
    io.write_color_bin(colors, f"{args.out}/oracle_color.bin")
    img = io.decode_color(colors, args.width, args.height, args.samples)
    io.write_ppm(img, f"{args.out}/oracle_color.ppm")
    print(json.dumps({"rays": len(rays), "out": f"{args.out}/oracle_color.ppm"}))
    return 0


def train_problem(width, height, bounces, device):
    """The train command's problem (the JAX CLI's cli.py:682-688): camera
    rays [N, 6] of one tent quad a pixel, cornell8 on ``device``, and the
    target colors [N, 3] the reference kernel renders -> (rays, scene,
    target).  The rays and the target are transposed views of the
    kernels' [6, N] and [3, N] planes, so a step reads them in place."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import camera, convert, scenes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.ops import render_kernels
    from ascendpathtracing_tpu_torch.parallel.sharded import params_to_planes

    rays = convert.rays_planes_from_numpy(
        camera.generate_rays_numpy(width, height, 1, seed=0).astype(np.float32),
        device=device).T
    scene = megakernel.scene_to_device(scenes.get_scene("cornell8"), device=device)
    with torch.no_grad():
        target = render_kernels.render_reference(
            rays, params_to_planes(scene), light_index=scene["light_index"], bounces=bounces)
    return rays, scene, target


def cmd_train(args) -> int:
    """The JAX CLI's inverse-rendering demo (cli.py:675-715): recover
    cornell8's albedo, perturbed by +0.08, from a target rendered by the
    reference kernel (:func:`train_problem`); SGD through
    ``parallel/sharded.make_train_step`` with a checkpoint every
    ``--ckpt-every`` steps and at the end."""
    device = _device(args.backend)
    if device is None:
        return 2
    import torch

    from ascendpathtracing_tpu_torch.parallel.sharded import make_train_step, split_scene_params
    from ascendpathtracing_tpu_torch.utils import checkpoint as ckpt

    rays, scene, target = train_problem(args.width, args.height, args.bounces, device)
    params, aux = split_scene_params(scene)

    start_step = 0
    if args.resume and os.path.exists(args.ckpt):
        params, start_step, _ = ckpt.load_checkpoint(args.ckpt)
        params = {k: torch.tensor(v, device=device) for k, v in params.items()}
        print(f"resumed from {args.ckpt} at step {start_step}", file=sys.stderr)
    else:
        # perturb albedo; training should recover it
        params = dict(params, albedo=params["albedo"] + 0.08)

    step_fn = make_train_step(None, bounces=args.bounces, learning_rate=args.lr)
    loss = float("nan")
    for i in range(start_step, start_step + args.steps):
        loss, params = step_fn(params, aux, rays, target)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == start_step + args.steps:
            ckpt.save_checkpoint(args.ckpt, params, step=i + 1)
        if (i + 1) % 10 == 0:
            print(f"step {i+1} loss {float(loss):.6e}", file=sys.stderr)
    err = float((params["albedo"] - scene["albedo"]).abs().max())
    print(json.dumps({
        "steps": args.steps,
        "final_loss": float(loss),
        "albedo_max_err": err,
        "ckpt": args.ckpt,
    }))
    return 0


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "train":
        return cmd_train(args)
    if args.cmd == "oracle":
        return cmd_oracle(args)
    if args.cmd == "selftest":
        return cmd_selftest(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
