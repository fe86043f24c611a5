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
A mesh render's color.bin holds each pixel's mean repeated over its
4 * samples slots, as the JAX CLI's fused mesh render writes it.

Ported so far: ``render`` in reference and pt mode with the AOVs, mesh
scenes through the fused kernel, and ``selftest`` (all but the check
against the XLA-loop mesh renderer, which prints as skipped).  Mesh
scenes with ``--renderer plain``, the wavefront renderer, ``--shard``,
post-processing and the ``train`` and ``oracle`` commands exit 2 with
"not yet ported".
"""

from __future__ import annotations

import argparse
import json
import sys
import time

NOT_PORTED = 2


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

    st = sub.add_parser("selftest", help="quick correctness checks of the "
                        "ported compute paths on the chosen backend")
    st.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")

    for name in ("train", "oracle"):
        sub.add_parser(name, help="not yet ported")
    args, rest = p.parse_known_args(argv)
    if rest and args.cmd not in ("train", "oracle"):
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args


def _not_ported(what: str) -> int:
    print(f"error: {what} is not yet ported to ascendpathtracing_tpu_torch "
          "(use ascendpathtracing_tpu)", file=sys.stderr)
    return NOT_PORTED


def _device(name: str):
    """The requested torch device, or None after printing why not."""
    from ascendpathtracing_tpu_torch.device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return None


def _unported_render_option(args) -> str | None:
    checks = [
        (args.renderer == "wavefront", "--renderer wavefront"),
        (args.denoise > 0 or args.tonemap != "none" or args.clamp > 0,
         "post-processing (--denoise/--tonemap/--clamp)"),
        (args.shard > 0, "--shard"),
    ]
    return next((what for bad, what in checks if bad), None)


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
    what = _unported_render_option(args)
    if what is not None:
        return _not_ported(what)
    mesh = args.scene is not None and args.scene.startswith("mesh-")
    if mesh and args.mode != "pt":
        print("error: mesh scenes require --mode pt", file=sys.stderr)
        return 2
    if mesh and args.renderer == "plain":
        return _not_ported("the plain mesh renderer (models/mesh.render_pt_mesh_impl)")
    if not mesh and args.renderer == "kernel" and args.mode != "reference":
        # The JAX CLI's refusal for its kernel renderer (cli.py:253-256).
        print("error: --renderer kernel supports --mode reference only",
              file=sys.stderr)
        return 2
    mesh_scene = None
    if mesh:
        try:
            mesh_scene = _mesh_scene(args.scene[len("mesh-"):])
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if mesh_scene is None:
            print(f"error: unknown mesh scene {args.scene!r} "
                  "(mesh-cube, mesh-icosphere, mesh-obj:<path>)", file=sys.stderr)
            return 2
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
    io.write_rays_bin(rays, f"{args.out}/rays.bin")
    io.write_spheres_bin(scene, f"{args.out}/spheres.bin")
    t_gen = time.time() - t0

    t0 = time.time()
    rays_t = torch.tensor(rays, device=device)
    dev = megakernel.scene_to_device(scene, device=device)
    if mesh_scene is not None:
        from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt

        planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(mesh_scene, device=device)
        img3 = mpt.render_pt_mesh(
            planes, cb, sb, t24, materials=mats, width=w, height=h, spp4=4 * s,
            bounces=args.bounces, seed=args.seed, **mpt.pt_tables_kwargs(grid, device),
        )
        # per-pixel means -> repeated over each pixel's 4*s slots, so
        # color.bin keeps its layout (decode averages them back)
        colors = img3.T.repeat_interleave(4 * s, dim=0)
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
    colors = colors.cpu().numpy()
    t_render = time.time() - t0

    if args.check_finite and not np.isfinite(colors).all():
        print(f"error: render produced {(~np.isfinite(colors)).sum()} "
              "non-finite values", file=sys.stderr)
        return 1

    io.write_color_bin(colors, f"{args.out}/color.bin")
    img = io.decode_color(colors, w, h, s)
    io.write_ppm(img, f"{args.out}/color.ppm")
    if args.aov != "none":
        _write_aovs(args.aov, rays_t, dev, w, h, s, args.out)

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
    if args.oracle and args.mode == "reference":
        exp = oracle.render_reference_numpy(rays, scene, bounces=args.bounces)
        img_o = io.decode_color(exp, w, h, s)
        stats["oracle_rays_bitexact"] = float((np.abs(exp - colors).max(1) == 0).mean())
        stats["oracle_img_equal_pix"] = float((img_o == img).all(axis=-1).mean())
    print(json.dumps(stats))
    return 0


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


def _write_aovs(aov, rays_t, dev, w, h, s, out) -> None:
    """First-hit AOV images, as the JAX CLI writes them (cli.py:313-338):
    depth.ppm (depth / its max), normal.ppm (normal * 0.5 + 0.5) and
    albedo.ppm; ``gbuffer`` writes all three."""
    import numpy as np

    from ascendpathtracing_tpu_torch.utils import io
    from ascendpathtracing_tpu_torch.models import megakernel

    gbuf = megakernel.render_gbuffer_impl(rays_t, dev)
    if aov in ("depth", "gbuffer"):
        depth = gbuf["depth"].cpu().numpy()
        dmax = max(float(depth.max()), 1e-9)
        io.write_ppm(
            io.decode_color(np.repeat((depth / dmax)[:, None], 3, axis=1), w, h, s),
            f"{out}/depth.ppm",
        )
    if aov in ("normal", "gbuffer"):
        io.write_ppm(
            io.decode_color(gbuf["normal"].cpu().numpy() * 0.5 + 0.5, w, h, s),
            f"{out}/normal.ppm",
        )
    if aov in ("albedo", "gbuffer"):
        io.write_ppm(
            io.decode_color(gbuf["albedo"].cpu().numpy(), w, h, s),
            f"{out}/albedo.ppm",
        )


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
    plain estimator's, the chunk-grid traversal vs brute force, and the
    fused mesh render's replay gradients.  ``mesh_pt_fused_energy_vs_xla``
    (the fused mesh path tracer vs the XLA-loop mesh renderer) prints as
    skipped: that renderer is not yet ported.  One JSON line per check;
    exit 0 iff all that ran pass."""
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

    # 6. needs the XLA-loop mesh renderer.
    print(json.dumps({"check": "mesh_pt_fused_energy_vs_xla",
                      "skipped": "models/mesh.render_pt_mesh_impl not yet ported"}))

    # 6b. the fused mesh render's replay backward.
    res = mesh_vjp_check(device)
    report("mesh_fused_vjp_grads", res.pop("ok"), **res)

    n_ok = sum(checks)
    print(json.dumps({"selftest": "PASS" if n_ok == len(checks) else "FAIL",
                      "passed": n_ok, "ran": len(checks),
                      "backend": device.type}))
    return 0 if n_ok == len(checks) else 1


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "selftest":
        return cmd_selftest(args)
    return _not_ported(f"the {args.cmd} command")


if __name__ == "__main__":
    sys.exit(main())
