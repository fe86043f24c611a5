"""Render traffic: frames for one client, ``in_flight`` of them at a
time (the workload's parameter).  Each frame has a new seed drawn from
the run's; the program renders it (``ops/pt_kernels.render_pt`` for a
scene of spheres, ``ops/mesh_pt_kernels.render_pt_mesh`` with the
configuration's mesh) and its [3, W*H] image is copied to a pinned host
buffer of its own, on a stream of its own; the next frame is submitted
once the oldest in flight has arrived.  With two in flight the card
renders one frame while the last is copied and read, so neither the copy
nor a stall of the host shorter than a frame costs rendering time.

``render_msamples_per_s`` is the camera samples of every frame that
reached the host in the window over the window's wall time (when the time
is up nothing more is sent, every frame sent is waited for, and the clock
is read after that); ``frame_ms_p95`` the 95th percentile over all those
frames of the time from submission to the image on the host.

The check (once the window has closed): ``check_frames`` frames (the
last and others drawn from the seed) at ``check_pixels`` pixels drawn
from the seed, whose values were copied out of each frame's host image.
The reference traces those pixels' samples from the same Philox stream;
compared is the worst frame's relative L1 gap, sum |image - reference|
over sum |reference|.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from perfbench import harness, inputs
from perfbench.reference import pt as ref_pt


def program_mesh_tables(cfg: dict, dev, face_albedo=None):
    """The program's tables of the configuration's scene with its mesh
    (``ops/mesh_pt_kernels.mesh_pt_tables``, the program's own set-up) ->
    (planes, cboxes, sboxes, tris24, materials, grid, grid keywords);
    ``face_albedo`` [3] replaces the mesh's albedo."""
    from ascendpathtracing_tpu_torch.models.mesh import MeshScene
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels
    from ascendpathtracing_tpu_torch.scenes import SphereScene

    planes64, mats, light = inputs.sphere_planes(cfg)
    v, f, albedo, emission, material = inputs.mesh_of(cfg)
    albedo = albedo if face_albedo is None else face_albedo
    spheres = SphereScene(radius=np.sqrt(planes64[0]), center=planes64[1:4].T.copy(),
                          emission=planes64[4:7].T.copy(), color=planes64[7:10].T.copy(),
                          material=mats, light_index=light)
    ms = MeshScene(spheres=spheres, vertices=v, faces=f,
                   face_albedo=np.tile(np.asarray(albedo, np.float64), (len(f), 1)),
                   face_emission=np.tile(np.asarray(emission, np.float64), (len(f), 1)),
                   face_material=np.full((len(f),), material, np.int32))
    tables = mesh_pt_kernels.mesh_pt_tables(ms, tris_per_chunk=cfg["mesh"]["tris_per_chunk"],
                                            device=dev, dtype=getattr(torch, cfg["dtype"]))
    return (*tables, mesh_pt_kernels.pt_tables_kwargs(tables[5], dev))


def make_frame(cfg: dict, wl: dict, dev):
    """The program's frame -> ``frame(seed) -> image [3, W*H]`` on ``dev``."""
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels, pt_kernels

    kw = dict(width=wl["width"], height=wl["height"], spp4=wl["spp4"],
              bounces=cfg["bounces"], rr_depth=cfg["rr_depth"], eps=cfg["eps"])
    if inputs.mesh_of(cfg) is None:
        planes64, mats, _ = inputs.sphere_planes(cfg)
        planes = torch.tensor(planes64, dtype=getattr(torch, cfg["dtype"]), device=dev)
        materials = torch.tensor(mats, device=dev)
        return lambda seed: pt_kernels.render_pt(planes, materials, seed=seed, **kw)
    planes, cb, sb, t24, materials, _, grid_kw = program_mesh_tables(cfg, dev)
    return lambda seed: mesh_pt_kernels.render_pt_mesh(
        planes, cb, sb, t24, materials=materials, seed=seed, **kw, **grid_kw)


def reference_scene(cfg: dict, dev, dtype):
    """The reference's copy of the scene: (planes [10, S], materials,
    mesh tables or None) in ``dtype``."""
    planes64, mats, _ = inputs.sphere_planes(cfg)
    # The float32 values the program gets, in the reference's dtype.
    planes = torch.tensor(planes64, dtype=getattr(torch, cfg["dtype"]), device=dev).to(dtype)
    mesh = inputs.mesh_of(cfg)
    tables = None if mesh is None else ref_pt.mesh_tables(*mesh, dtype=dtype, device=dev)
    return planes, torch.tensor(mats, device=dev), tables


def reference_pixels(cfg, wl, scene, pixels, seed, dtype, counts=None):
    planes, mats, mesh = scene
    return ref_pt.render_pixels(
        planes, mats, pixels, cam=inputs.camera_constants(cfg, wl["width"], wl["height"]),
        width=wl["width"], height=wl["height"], spp4=wl["spp4"], bounces=cfg["bounces"],
        rr_depth=cfg["rr_depth"], eps=cfg["eps"], seed=int(seed), dtype=dtype, mesh=mesh,
        counts=counts)


def draws(seed: int, n_pix: int, n_check: int):
    """From the run's seed: the frames' seeds and the checked pixels."""
    rng = np.random.default_rng(seed & (2 ** 64 - 1))
    seeds = rng.integers(0, 2 ** 32, size=1 << 17, dtype=np.uint64)
    pixels = np.sort(rng.choice(n_pix, size=n_check, replace=False))
    return rng, [int(s) for s in seeds], pixels


def run(r: harness.Run) -> harness.Outcome:
    cfg, wl, dev = r.config, r.workload, r.device
    if dev.type == "cuda":
        harness.build(wl["libraries"])
    n_pix = wl["width"] * wl["height"]
    rng, seeds, pix_np = draws(r.seed, n_pix, int(wl["check_pixels"]))
    frame = make_frame(cfg, wl, dev)
    cuda = dev.type == "cuda"
    depth = int(wl.get("in_flight", 1))
    host = [torch.empty((3, n_pix), dtype=getattr(torch, cfg["dtype"]), pin_memory=cuda)
            for _ in range(depth)]
    host_np = [h.numpy() for h in host]

    copies = torch.cuda.Stream(dev) if cuda else None

    def submit(seed, slot):
        """Renders a frame and queues its copy to host buffer ``slot`` on a
        stream of its own, so that the copy overlaps the next frame's
        rendering -> (submitted, call returned, the copy's event or None)."""
        a = time.perf_counter()
        img = frame(seed)
        b = time.perf_counter()
        if not cuda:
            host[slot].copy_(img)
            return a, b, None
        copies.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(copies):
            host[slot].copy_(img, non_blocking=True)
            img.record_stream(copies)
            ev = torch.cuda.Event()
            ev.record(copies)
        return a, b, ev

    def arrived(ev):
        """Waits until the frame's image is on the host."""
        if ev is not None:
            ev.synchronize()

    warm = int(wl["warmup_frames"])
    for k, s in enumerate(seeds[-warm:]):
        arrived(submit(s, k % depth)[2])
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    r.setup_done()

    # ``depth`` frames in flight: frame i + depth is submitted once frame
    # i's image has arrived.  When the time is up nothing more is sent,
    # every frame sent is waited for, and the clock is read after that.
    tracer = r.tracer()
    frame_ms, host_s, kept = [], [], []
    failed = 0
    pending: collections.deque = collections.deque()
    i, closing = 0, False
    t0 = time.perf_counter()
    while True:
        while not closing and len(pending) < depth and not tracer.holds(i):
            tracer.before(i, t0)
            a, b, ev = submit(seeds[i], i % depth)
            if tracer.untraced(i):
                host_s.append(b - a)
            pending.append((i, a, ev))
            i += 1
        j, a, ev = pending.popleft()
        arrived(ev)
        c = time.perf_counter()
        frame_ms.append((c - a) * 1e3)
        kept.append(host_np[j % depth][:, pix_np].copy())
        if not np.isfinite(kept[-1]).all():
            failed += 1
        tracer.after(j)
        closing = closing or c - t0 >= r.seconds
        if closing and not pending:
            break
    window_s = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    med = float(np.median(frame_ms))
    print(f"window: {len(frame_ms)} frames in {window_s:.4f} s, {depth} in flight; frame ms "
          f"median {med:.4f} p95 {harness.p95(frame_ms):.4f} max {max(frame_ms):.4f}; "
          f"ms beyond 2x the median {sum(max(0.0, f - 2 * med) for f in frame_ms):.4f}",
          file=sys.stderr)

    # The check: the last frame and others drawn from the seed.
    n = len(kept)
    k = min(int(wl["check_frames"]), n)
    chosen = [n - 1] + sorted(rng.choice(n - 1, size=k - 1, replace=False).tolist()) if n > 1 \
        else [0]
    dtype = getattr(torch, cfg["dtype"])
    scene = reference_scene(cfg, dev, dtype)
    pixels = torch.tensor(pix_np, device=dev)
    counts: dict = {}
    gaps = []
    for f in chosen:
        ref = reference_pixels(cfg, wl, scene, pixels, seeds[f], dtype, counts).cpu().numpy()
        gaps.append(float(np.abs(kept[f] - ref).sum() / max(np.abs(ref).sum(), 1e-300)))
    gap = harness.worst(gaps)
    scale = n_pix / len(pix_np) / len(chosen)
    samples = n_pix * int(wl["spp4"])
    context = {
        "cell": r.cell.name, "config": cfg, "workload": wl,
        "memory_peak_bytes": max(setup_peak, peak),
        "trace": tracer.summary(),
        "host_ms": [s * 1e3 for s in host_s],
        "counts": {"samples": samples, "pixels": n_pix,
                   "live_bounces": counts.get("live_bounces", 0) * scale,
                   "triangle_hits": counts.get("triangle_hits", 0) * scale,
                   "spheres": int(scene[0].shape[1]),
                   "triangles": 0 if scene[2] is None else scene[2]["faces"]},
    }
    metrics = {"render_msamples_per_s": harness.millions_per_s(n * samples, window_s),
               "frame_ms_p95": harness.p95(frame_ms)}
    checks = {"frame_rel_l1": harness.Check(gap, wl["limits"]["frame_rel_l1"])}
    return harness.Outcome(metrics, n, failed, checks, context)
