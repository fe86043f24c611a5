"""Mesh fit traffic: SGD steps of inverse rendering through the program's
fused mesh path tracer and its replay backward
(``diff/mesh_fused.make_render_pt_mesh_diff``: ``mesh_pt.cu`` with
residuals, the replay's plain torch and ``segsum.cu``), fitting the scene
planes and the mesh slots' albedo and emission.

Set-up builds the program's tables of the configuration's scene with the
mesh's albedo raised by ``albedo_offset``, renders the target, the true
scene at ``target_spp4`` samples a pixel, with the reference, and takes
the program's first three steps (recorded for the check), then
``warmup_steps`` more.  A step renders W x H x ``spp4`` samples with a
new seed drawn from the run's, takes the mean squared error to the
target, its gradients and the SGD update.  The window runs step after
step, reads the loss every ``loss_every`` steps and synchronises at its
end: ``fit_mrays_per_s`` counts each step's camera samples.

The check (once the window has closed) is ``fit``'s, over the first
``check_steps`` steps (two: three full frames of the reference would
outlast the window): the reference takes them with the same seeds from
the same start; compared are each step's loss, the first step's gradient
as the program's state shows it and the change over those steps, by the
worst of three leaves: the scene planes (the spheres' albedo and emission), the mesh's
albedo, the mesh's emission.  Leaf norms do not depend on the order of
the mesh's slots, which the program's tables choose.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import harness, inputs
from perfbench.reference import meshfit, pt as ref_pt
from perfbench.traffic import render


def entry():
    """The program's differentiable mesh renderer factory."""
    from ascendpathtracing_tpu_torch.diff.mesh_fused import make_render_pt_mesh_diff

    return make_render_pt_mesh_diff


def make_step(cfg: dict, wl: dict, dev, tables, target):
    """The step: ``step(leaves, seed) -> (loss, new leaves)``, leaves
    (scene planes [10, S], slot albedo [CT, 3], slot emission [CT, 3]),
    plain SGD with ``learning_rates`` for each leaf (a mesh slot's
    gradient is a few thousandths of the planes')."""
    _, cb, sb, t24, materials, _, grid_kw = tables
    make = entry()
    kw = dict(width=wl["width"], height=wl["height"], spp4=wl["spp4"], materials=materials,
              bounces=cfg["bounces"], rr_depth=cfg["rr_depth"], eps=cfg["eps"], **grid_kw)
    geom16, mat2 = t24[:, :16].contiguous(), t24[:, 22:24].contiguous()
    lrs = [float(x) for x in wl["learning_rates"]]

    def step(leaves, seed):
        live = [x.detach().requires_grad_(True) for x in leaves]
        image = make(cb, sb, geom16, mat2, seed=seed, **kw)(*live)
        loss = torch.mean((image - target) ** 2)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), [x.detach() - lr * g for x, lr, g in zip(live, lrs, grads)]

    return step


def leaf_norms(scene, albedo, emission) -> dict:
    return harness.norms({"scene": scene, "albedo": albedo, "emission": emission})


def run(r: harness.Run) -> harness.Outcome:
    cfg, wl, dev = r.config, r.workload, r.device
    if dev.type == "cuda":
        harness.build(wl["libraries"])
    dtype = getattr(torch, cfg["dtype"])
    v, f, albedo, emission, material = inputs.mesh_of(cfg)
    start_albedo = tuple(float(a) + float(wl["albedo_offset"]) for a in albedo)
    tables = render.program_mesh_tables(cfg, dev, face_albedo=start_albedo)
    planes, t24 = tables[0], tables[3]
    rng = np.random.default_rng(r.seed & (2 ** 64 - 1))
    seeds = [int(s) for s in rng.integers(0, 2 ** 32, size=1 << 16, dtype=np.uint64)]

    # The reference's copy of the scene and the target it renders.
    ref_planes = planes.detach().clone()
    ref_mats = tables[4].clone()
    truth_mesh = ref_pt.mesh_tables(v, f, albedo, emission, material, dtype=dtype, device=dev)
    W, H = wl["width"], wl["height"]
    cam = inputs.camera_constants(cfg, W, H)
    common = dict(cam=cam, width=W, height=H, bounces=cfg["bounces"],
                  rr_depth=cfg["rr_depth"], eps=cfg["eps"])
    with torch.no_grad():
        target = ref_pt.render_pixels(
            ref_planes, ref_mats, torch.arange(W * H, device=dev), spp4=wl["target_spp4"],
            seed=seeds[-1], dtype=dtype, mesh=truth_mesh, **common).to(dtype).contiguous()

    step = make_step(cfg, wl, dev, tables, target)
    p0 = [planes.clone(), t24[:, 16:19].clone(), t24[:, 19:22].clone()]
    leaves, losses, states = p0, [], []
    for i in range(3):
        loss, leaves = step(leaves, seeds[i])
        losses.append(float(loss))
        states.append(leaves)
    for i in range(int(wl["warmup_steps"])):
        _, leaves = step(leaves, seeds[3 + i])
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    r.setup_done()

    tracer = r.tracer()
    every = int(wl["loss_every"])
    host_s = []
    attempted = failed = 0
    i = 0
    t0 = time.perf_counter()
    while True:
        tracer.before(i, t0)
        a = time.perf_counter()
        loss, leaves = step(leaves, seeds[100 + i])
        b = time.perf_counter()
        if tracer.untraced(i):
            host_s.append(b - a)
        attempted += 1
        tracer.after(i)
        i += 1
        if i % every == 0:
            if not math.isfinite(float(loss)):
                failed += every
            if time.perf_counter() - t0 >= r.seconds:
                break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del leaves, loss
    if cuda:
        torch.cuda.empty_cache()

    s_count = planes.shape[1]
    start_mesh = ref_pt.mesh_tables(v, f, start_albedo, emission, material, dtype=dtype,
                                    device=dev)
    ref0 = {"sphere_albedo": ref_planes[7:10].T.clone(),
            "sphere_emission": ref_planes[4:7].T.clone(),
            "face_albedo": start_mesh["albedo"].clone(),
            "face_emission": start_mesh["emission"].clone()}
    counts: dict = {}
    lrs = [float(x) for x in wl["learning_rates"]]
    n_check = int(wl["check_steps"])
    ref_losses, ref_grad, ref_states = meshfit.sgd_steps(
        ref0, ref_planes, ref_mats, truth_mesh, target, seeds[:n_check],
        lr=dict(zip(meshfit.KEYS, (lrs[0], lrs[0], lrs[1], lrs[2]))), spp4=wl["spp4"],
        counts=counts, **common)

    def ref_leaves(d):
        return leaf_norms(torch.cat([d["sphere_albedo"], d["sphere_emission"]]),
                          d["face_albedo"], d["face_emission"])

    ref_change = ref_leaves({k: ref_states[-1][k] - ref0[k] for k in meshfit.KEYS})
    prog_grad = leaf_norms(*[(a - b) / lr for a, b, lr in zip(p0, states[0], lrs)])
    prog_change = leaf_norms(*[b - a for a, b in zip(p0, states[n_check - 1])])
    keys = harness.kept_leaves(ref_leaves(ref_grad))
    limits = wl["limits"]
    checks = {
        "loss_gap": harness.Check(
            harness.worst(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            limits["loss_gap"]),
        "grad_gap": harness.Check(harness.norm_gap(prog_grad, ref_leaves(ref_grad), keys),
                                  limits["grad_gap"]),
        "change_gap": harness.Check(harness.norm_gap(prog_change, ref_change, keys),
                                    limits["change_gap"]),
    }
    samples = W * H * int(wl["spp4"])
    context = {
        "cell": r.cell.name, "config": cfg, "workload": wl,
        "memory_peak_bytes": max(setup_peak, peak),
        "trace": tracer.summary(),
        "host_ms": [s * 1e3 for s in host_s],
        "counts": {"samples": samples, "pixels": W * H, "bounces": cfg["bounces"],
                   "spheres": s_count, "triangles": int(f.shape[0]),
                   "slots": int(t24.shape[0]),
                   "live_bounces": counts.get("live_bounces", 0),
                   "triangle_hits": counts.get("triangle_hits", 0)},
    }
    metrics = {"fit_mrays_per_s": harness.millions_per_s(attempted * samples, window_s),
               "peak_mem_gib": peak / 2 ** 30}
    return harness.Outcome(metrics, attempted, failed, checks, context)
