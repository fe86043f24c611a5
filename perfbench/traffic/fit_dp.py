"""Data-parallel fit traffic: ``fit``'s SGD steps through the program's
``parallel/sharded.make_train_step(mesh)`` on a world of ranks, one a
card (``perfbench/world.py``: this process is rank 0, the others are
spawned; NCCL is the program's, the benchmark's exchanges go over a gloo
group of its own).

Every rank makes the same ``ray_sets`` batches from the seed (a
generator on its card, seeded alike), each ``passes`` camera passes of W
x H x 4 rays one after another, and keeps its contiguous share of each,
rank r rows [r m, (r + 1) m) as ``shard_rays`` orders them, m = N /
ranks; the reference renders that share's target on the rank's card.  The step is ``make_train_step(make_mesh(ranks,
model_parallel=1))``: each rank's forward and replay on its share, one
all-reduce of the loss and the [10, S] gradient, the same update on
every rank.  Set-up takes the program's first three steps on sets 0, 1,
2 (recorded for the check), then ``warmup_steps`` more; rank 0 times the
second half of them and sets the window's step count n so that the
window lasts about ``--seconds`` (at least the traced stretch), which
every rank gets before the window; ``setup_s`` ends after a barrier once
every rank is warm.  The window runs n steps on every rank, reads the
loss every ``loss_every`` steps and ends with a synchronise on rank 0,
whose last all-reduce ends only after every rank's last backward:
``fit_mrays_per_s`` is n x N over rank 0's window wall time;
``peak_mem_gib`` the largest window peak over the ranks.  Only rank 0 is
traced; its context carries the program's spans (``perfbench/spans.py``)
and its own share's counts.

The check (once the window has closed): ``fit``'s three numbers against
the reference on the whole batch: each rank runs ``refmode.loss_and_grads``
on its share on its card, the ranks' losses and gradients are averaged
in float64 over the gloo group (the mean of equal shares), and the update
is float32, as in ``refmode.sgd_steps``.  Also ``replica_gap``: the
largest |p_r - p_0| over ranks and leaves after the window, 0 where every
rank applied the same all-reduced update.

A workload key ``fault`` (``perfbench/faults_dp.py``), which no cell's
file sets, swaps the step for the check's control or a planted fault.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from perfbench import faults_dp, harness, inputs, world
from perfbench.reference import refmode


def entry():
    """The program's step factory and mesh."""
    from ascendpathtracing_tpu_torch.parallel.mesh import make_mesh
    from ascendpathtracing_tpu_torch.parallel.sharded import make_train_step

    return make_train_step, make_mesh


def run(r: harness.Run) -> harness.Outcome:
    """``perfbench.run``'s entry: this process is rank 0."""
    return run_jobs([r])[0]


def run_jobs(runs, stall_s: float = world.STALL_S) -> list:
    """Runs ``runs`` (rank 0's, one cell) one after another on one world
    whose ranks may pass no phase for ``stall_s`` seconds -> their
    outcomes."""
    wl, dev = runs[0].workload, runs[0].device
    if dev.type == "cuda":
        harness.build(wl["libraries"])
    args = {"cell": runs[0].cell.name,
            "jobs": [{"seed": r.seed, "seconds": r.seconds, "workload": r.workload}
                     for r in runs]}
    with world.World(int(wl["chips"]), dev.type, __name__, args, stall_s=stall_s) as w:
        return [job(r, w.rank) for r in runs]


def rank_main(args: dict, rank: world.Rank) -> None:
    """Ranks 1..n-1: the same jobs as rank 0."""
    cell = harness.load_cell(args["cell"])
    for j in args["jobs"]:
        r = harness.Run(cell, seed=j["seed"], seconds=j["seconds"], trace_on=False,
                        device=rank.device, t_start=time.perf_counter(), size=j["workload"])
        job(r, rank)


def _gather(values, rank: world.Rank) -> torch.Tensor:
    """Every rank's float64 ``values`` -> [ranks, len(values)] (gloo)."""
    mine = torch.as_tensor(values, dtype=torch.float64).reshape(-1)
    out = [torch.empty_like(mine) for _ in range(rank.size)]
    dist.all_gather(out, mine, group=rank.side)
    return torch.stack(out)


def _flat(params: dict) -> torch.Tensor:
    return torch.cat([params[k].detach().reshape(-1).double().cpu() for k in refmode.KEYS])


def job(r: harness.Run, rank: world.Rank):
    """One run on this rank -> rank 0's Outcome, None on the others."""
    cfg, wl, dev = r.config, r.workload, r.device
    fault = wl.get("fault")
    faults_dp.at_start(fault, rank)
    planes64, _, light = inputs.sphere_planes(cfg)
    bounces, eps, lr = int(cfg["bounces"]), float(cfg["eps"]), float(wl["learning_rate"])
    dtype = getattr(torch, cfg["dtype"])
    truth = refmode.params_of(torch.tensor(planes64, dtype=dtype, device=dev))
    p0 = dict(truth, albedo=truth["albedo"] + float(wl["albedo_offset"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(r.seed)
    sets = []
    for _ in range(int(wl["ray_sets"])):
        full = torch.cat([inputs.camera_rays(cfg, wl["width"], wl["height"], gen, dtype)
                          for _ in range(int(wl["passes"]))], dim=1)
        m = full.shape[1] // rank.size
        rays = full[:, rank.index * m:(rank.index + 1) * m].contiguous()
        del full
        with torch.no_grad():
            target = refmode.render(truth, rays, light=light, bounces=bounces, eps=eps)
        sets.append((rays, target.contiguous()))
    n_rays, n_global = m, m * rank.size
    rank.mark("inputs")
    # The kernels' layout: [m, 6] and [m, 3] views of [6, m] and [3, m].
    feed = [(rays.T, target.T) for rays, target in sets]
    make_step, make_mesh = entry()
    make_step = faults_dp.factory(fault, make_step, rank)
    step = make_step(make_mesh(rank.size, model_parallel=1), bounces=bounces, eps=eps,
                     learning_rate=lr)
    aux = {"light_index": light}
    dist.barrier(group=rank.side)

    params = {k: v.clone() for k, v in p0.items()}
    losses, states = [], []
    for i in range(3):
        loss, params = step(params, aux, *feed[i])
        losses.append(float(loss))
        states.append(params)
    warm = int(wl["warmup_steps"])
    timed_from = warm // 2
    for i in range(warm):
        if i == timed_from:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_warm = time.perf_counter()
        _, params = step(params, aux, *feed[(3 + i) % len(feed)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t_warm) / (warm - timed_from)
    every = int(wl["loss_every"])
    n = every * max(1, math.ceil(r.seconds / step_s / every))
    if r.trace_on:
        n = max(n, every * math.ceil((int(wl["trace_after"]) + int(wl["trace_iterations"]))
                                     / every))
    count = torch.tensor([n], dtype=torch.int64)
    dist.broadcast(count, 0, group=rank.side)
    n = int(count)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rank.mark("warm")
    dist.barrier(group=rank.side)
    r.setup_done()

    tracer = r.tracer()
    host_s = []
    attempted = failed = 0
    t0 = time.perf_counter()
    for i in range(n):
        tracer.before(i, t0)
        a = time.perf_counter()
        loss, params = step(params, aux, *feed[i % len(feed)])
        b = time.perf_counter()
        if tracer.untraced(i):
            host_s.append(b - a)
        attempted += 1
        tracer.after(i)
        if (i + 1) % every == 0 and not math.isfinite(float(loss)):
            failed += every
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rank.mark("window")
    replicas = _gather(_flat(params), rank)
    memory = _gather([setup_peak, peak], rank)
    del params, loss, step

    ref_losses, ref_states, ref_grad = _reference(p0, sets[:3], rank, lr=lr, light=light,
                                                  bounces=bounces, eps=eps)
    rank.mark("reference")
    if rank.index != 0:
        return None
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
        "replica_gap": harness.Check(
            harness.worst((replicas - replicas[0]).abs().reshape(-1).tolist()),
            limits["replica_gap"]),
    }
    summary = tracer.summary()
    if summary:
        from perfbench import spans

        summary["spans"] = spans.summary(tracer.prof)
    context = {
        "cell": r.cell.name, "config": cfg, "workload": wl,
        "memory_peak_bytes": int(memory.max()),
        "trace": summary,
        "host_ms": [s * 1e3 for s in host_s],
        "counts": {"rays": n_rays, "bounces": bounces, "spheres": planes64.shape[1],
                   "ranks": rank.size},
    }
    metrics = {"fit_mrays_per_s": harness.millions_per_s(attempted * n_global, window_s),
               "peak_mem_gib": float(memory[:, 1].max()) / 2 ** 30}
    return harness.Outcome(metrics, attempted, failed, checks, context)


def _reference(p0: dict, batches, rank: world.Rank, *, lr, light, bounces, eps):
    """The reference's SGD steps on the whole batch: each rank's share on
    its card, the shares' losses and gradients averaged in float64 over
    the gloo group, the update in the parameters' dtype -> (losses, the
    parameters after each step, the first step's gradients)."""
    params = {k: v.clone() for k, v in p0.items()}
    losses, states, first = [], [], None
    for rays, target in batches:
        loss, grads = refmode.loss_and_grads(params, rays, target, light=light,
                                             bounces=bounces, eps=eps)
        flat = torch.cat([loss.reshape(1).double().cpu()]
                         + [grads[k].reshape(-1).double().cpu() for k in refmode.KEYS])
        dist.all_reduce(flat, group=rank.side)
        flat /= rank.size
        losses.append(float(flat[0]))
        grads, at = {}, 1
        for k in refmode.KEYS:
            size = params[k].numel()
            grads[k] = flat[at:at + size].reshape(params[k].shape).to(params[k])
            at += size
        params = {k: params[k] - lr * grads[k] for k in refmode.KEYS}
        states.append(params)
        first = grads if first is None else first
    return losses, states, first
