"""Fit traffic: SGD steps of inverse rendering through the program's
``parallel/sharded.make_train_step(None)`` (``cli train``'s step: the
reference-mode forward with winners, the replay backward, the loss and
the update).

Set-up makes ``ray_sets`` sets of camera rays from the seed (one
tent-jittered ray per sub-pixel), renders each set's target with the
reference at the configuration's scene, perturbs the albedo by
``albedo_offset`` and takes the program's first three steps on sets 0,
1, 2 (recorded for the check), then ``warmup_steps`` more.  The window
runs step after step on the sets in turn, reads the loss every
``loss_every`` steps (the host may run that far ahead) and synchronises
at its end: ``fit_mrays_per_s`` is the rays of every step taken over the
window's wall time.

The check (once the window has closed): the reference takes the same
three steps from the same start on the same rays.  Compared: each step's
loss, the first step's gradient as the program's state shows it ((p0 -
p1) / lr), and the change of the parameters over the three steps, each
leaf's norm against the reference's, by the worst leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's (centre and
r^2: exactly zero) are left out.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import harness, inputs
from perfbench.reference import refmode


def entry():
    """The program's step factory (tests swap it for a faulty one)."""
    from ascendpathtracing_tpu_torch.parallel.sharded import make_train_step

    return make_train_step


def run(r: harness.Run) -> harness.Outcome:
    cfg, wl, dev = r.config, r.workload, r.device
    if dev.type == "cuda":
        harness.build(wl["libraries"])
    planes64, _, light = inputs.sphere_planes(cfg)
    bounces, eps, lr = int(cfg["bounces"]), float(cfg["eps"]), float(wl["learning_rate"])
    dtype = getattr(torch, cfg["dtype"])
    truth = refmode.params_of(torch.tensor(planes64, dtype=dtype, device=dev))
    p0 = dict(truth, albedo=truth["albedo"] + float(wl["albedo_offset"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    sets = []
    for _ in range(int(wl["ray_sets"])):
        rays = inputs.camera_rays(cfg, wl["width"], wl["height"], gen, dtype)
        with torch.no_grad():
            target = refmode.render(truth, rays, light=light, bounces=bounces, eps=eps)
        sets.append((rays, target.contiguous()))
    n_rays = sets[0][0].shape[1]
    # The kernels' layout: [N, 6] and [N, 3] views of [6, N] and [3, N].
    feed = [(rays.T, target.T) for rays, target in sets]
    step = entry()(None, bounces=bounces, eps=eps, learning_rate=lr)
    aux = {"light_index": light}

    params = {k: v.clone() for k, v in p0.items()}
    losses, states = [], []
    for i in range(3):
        loss, params = step(params, aux, *feed[i])
        losses.append(float(loss))
        states.append(params)
    for i in range(int(wl["warmup_steps"])):
        _, params = step(params, aux, *feed[(3 + i) % len(feed)])
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
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
        loss, params = step(params, aux, *feed[i % len(feed)])
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
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, loss

    ref_losses, ref_grad, ref_states = refmode.sgd_steps(
        {k: v.clone() for k, v in p0.items()}, sets[:3], lr=lr, light=light,
        bounces=bounces, eps=eps)
    keys = harness.kept_leaves(harness.norms(ref_grad))
    prog_grad = {k: (p0[k].double() - states[0][k].double()) / lr for k in ref_grad}
    change = {k: states[2][k].double() - p0[k].double() for k in ref_grad}
    ref_change = {k: ref_states[2][k].double() - p0[k].double() for k in ref_grad}
    limits = wl["limits"]
    checks = {
        "loss_gap": harness.Check(
            harness.worst(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            limits["loss_gap"]),
        "grad_gap": harness.Check(
            harness.norm_gap(harness.norms(prog_grad), harness.norms(ref_grad), keys),
            limits["grad_gap"]),
        "change_gap": harness.Check(
            harness.norm_gap(harness.norms(change), harness.norms(ref_change), keys),
            limits["change_gap"]),
    }
    context = {
        "cell": r.cell.name, "config": cfg, "workload": wl,
        "memory_peak_bytes": max(setup_peak, peak),
        "trace": tracer.summary(),
        "host_ms": [s * 1e3 for s in host_s],
        "counts": {"rays": n_rays, "bounces": bounces, "spheres": planes64.shape[1]},
    }
    metrics = {"fit_mrays_per_s": harness.millions_per_s(attempted * n_rays, window_s),
               "peak_mem_gib": peak / 2 ** 30}
    return harness.Outcome(metrics, attempted, failed, checks, context)
