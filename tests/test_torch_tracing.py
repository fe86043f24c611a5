"""The port's spans on the CPU: ``utils/profiling.span`` (free without a
profiler, a host event under one), their nesting in the train step, the
mesh replay and every kernel wrapper's twin path, and the benchmark's
reading of them (``perfbench/spans``: the attribution of device
operations to spans across threads, the host waits, the four readers) on
synthetic events."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ascendpathtracing_tpu_torch import camera, scenes
from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
from ascendpathtracing_tpu_torch.accel import meshes, tri
from ascendpathtracing_tpu_torch.diff import mesh_fused as mf
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
from ascendpathtracing_tpu_torch.ops import render_kernels as rk
from ascendpathtracing_tpu_torch.ops import replay_kernels as rpk
from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
from ascendpathtracing_tpu_torch.parallel import sharded
from ascendpathtracing_tpu_torch.utils import profiling
from perfbench import spans
from tests.test_torch_cuda import LIGHT, _mixed_scene, _pt_scene, _reference_inputs, _sphere_rays
from tests.test_torch_slice import one_cpu_thread  # noqa: F401  (autouse)

CPU = [ProfilerActivity.CPU]


def _apt_events(fn):
    """Runs ``fn`` under a CPU torch.profiler -> its ``apt.`` events in
    order of start."""
    with profile(activities=CPU) as prof:
        fn()
    return sorted((e for e in prof.events() if e.name.startswith("apt.")),
                  key=lambda e: e.time_range.start)


def _apt_parent(e):
    """The nearest ``apt.`` event above ``e`` on its thread (None at the
    top)."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("apt."):
        p = p.cpu_parent
    return p


def _train_problem(w=4, bounces=2):
    """(params, aux, rays [N, 6], target [N, 3]) of cornell8 at w x w."""
    rays = torch.tensor(camera.generate_rays_numpy(w, w, 1, seed=0), dtype=torch.float32)
    scene = megakernel.scene_to_device(scenes.cornell8(), dtype=torch.float32)
    target = rk.render_reference(rays, sharded.params_to_planes(scene),
                                 light_index=scene["light_index"], bounces=bounces)
    params, aux = sharded.split_scene_params(scene)
    return params, aux, rays, target


# ------------------------------------------------------------ span ----
def test_span_records_only_while_a_profiler_records():
    off = profiling.span("apt.a")
    assert off is profiling.span("apt.b") and isinstance(off, contextlib.nullcontext)
    with profile(activities=CPU) as prof:
        on = profiling.span("apt.on")
        with on:
            torch.ones(4).sum()
        with profiling.span("apt.on.inner"):
            pass
    assert not isinstance(on, contextlib.nullcontext)
    assert profiling.span("apt.c") is off
    assert [e.name for e in prof.events() if e.name.startswith("apt.")] == [
        "apt.on", "apt.on.inner"]
    assert not any(getattr(e, "is_user_annotation", False) for e in prof.events())


def test_train_step_spans_its_parts_in_order():
    params, aux, rays, target = _train_problem()
    step = sharded.make_train_step(None, bounces=2, learning_rate=0.05)
    step(params, aux, rays, target)  # warm
    ev = _apt_events(lambda: step(params, aux, rays, target))
    (top,) = [e for e in ev if e.name == "apt.train_step"]
    assert _apt_parent(top) is None
    assert [e.name for e in ev if _apt_parent(e) is top] == [
        "apt.train_step.forward", "apt.train_step.loss", "apt.train_step.backward",
        "apt.train_step.update"]
    kernels = {e.name: _apt_parent(e).name for e in ev if e.name.startswith("apt.kernel.")}
    assert kernels == {"apt.kernel.fwd_idx": "apt.train_step.forward",
                       "apt.kernel.bwd_replay": "apt.train_step.backward"}


@pytest.mark.parametrize("plain,segsums", [(False, 1), (True, 0)])
def test_replay_backward_spans_each_chunk(plain, segsums):
    """spp4 16 in chunks of 8: two chunks; the default path's rows and
    segment-sum (the wrappers' CPU twins) inside each, one of each; the
    plain twins with no span."""
    gen = torch.Generator().manual_seed(0)
    bounces, spp4, pix, spheres, slots = 2, 16, 8, 9, 5
    wid = torch.randint(-1, spheres + slots, (bounces, spp4, pix), generator=gen,
                        dtype=torch.int32)
    resv = torch.rand((bounces, 7, spp4, pix), generator=gen)
    g = torch.rand((3, pix), generator=gen)
    ev = _apt_events(lambda: mf.replay_backward(wid, resv, g, n_spheres=spheres, n_slots=slots,
                                                spp4=spp4, layer_chunk=8, plain=plain))
    chunks = [e for e in ev if e.name == "apt.replay.chunk"]
    assert len(chunks) == 2 and all(_apt_parent(c) is None for c in chunks)
    for name in ("apt.kernel.segsum", "apt.kernel.replay_rows"):
        inner = [e for e in ev if e.name == name]
        assert len(inner) == 2 * segsums
        for c in chunks:
            assert sum(_apt_parent(e) is c for e in inner) == segsums


def _mesh_inputs():
    ms = _mixed_scene(subdivisions=0)
    planes, cb, sb, t24, mats, grid = mpt.mesh_pt_tables(ms, device="cpu", dtype=torch.float32,
                                                         tris_per_chunk=8, supers_per=4)
    kw = dict(materials=mats, width=4, height=4, spp4=4, bounces=2, rr_depth=2,
              **mpt.pt_tables_kwargs(grid, "cpu"))
    return (planes, cb, sb, t24), kw


def _wbvh_call():
    v, f = meshes.icosphere(subdivisions=1)
    g = cg.build_chunk_grid(np.asarray(v, np.float32), f, tris_per_chunk=8, supers_per=4)
    rows = torch.tensor(cg.attr_triangle_rows(g, np.ones((f.shape[0], 3)),
                                              np.zeros((f.shape[0], 3)),
                                              np.arange(f.shape[0]) % 3))
    cb, sb, _, _ = cg.chunk_grid_to_device(g, "cpu")
    rays = torch.tensor(_sphere_rays(32))
    return lambda: wk.intersect_chunks(rays, cb, sb, rows, torch.tensor(g.ssboxes),
                                       tris_per_chunk=8, supers_per=4, attrs=True)


def _bvh_call():
    v, f = meshes.icosphere(subdivisions=1)
    bvh = bvh_mod.build_bvh_numpy(v, f, max_leaf=4)
    planes = tuple(tuple(c[bvh.tri_order] for c in t)
                   for t in tri.triangle_planes(v, f, dtype=np.float32))
    tables = bk.pack_bvh(bvh, planes, "cpu")
    rays = torch.tensor(_sphere_rays(32))
    return lambda: bk.intersect_bvh(rays, *tables, max_leaf=4)


def _wrapper_call(key):
    """A call of the wrapper behind ``LAUNCHES[key]`` on tiny CPU inputs."""
    kw = dict(light_index=LIGHT, bounces=2)
    if key in ("fwd", "fwd_idx", "bwd_replay", "bwd_recompute"):
        rp, sp = _reference_inputs(2, np.float32, "cpu")
        g = torch.ones((3, rp.shape[1]))
        idx = rk.render_reference_planes_with_idx(rp, sp, **kw)[1]
        return {"fwd": lambda: rk.render_reference_planes(rp, sp, **kw),
                "fwd_idx": lambda: rk.render_reference_planes_with_idx(rp, sp, **kw),
                "bwd_replay": lambda: rk.render_ref_bwd_replay(idx, sp, g, **kw),
                "bwd_recompute": lambda: rk.render_ref_bwd(rp, sp, g, **kw)}[key]
    if key in ("segsum_paged", "segsum_matmul"):
        seg = torch.tensor([0, 2, -1, 2, 7], dtype=torch.int32)
        vals = torch.ones((3, 5))
        fn = hk.segment_rows_paged if key == "segsum_paged" else hk.segment_rows_matmul
        return lambda: fn(seg, vals, n_slots=4)
    if key == "pt":
        planes, mats = _pt_scene("cornell8", torch.float32, "cpu")
        return lambda: ptk.render_pt(planes, mats, width=4, height=4, spp4=4, bounces=2,
                                     rr_depth=2)
    if key == "mesh_pt":
        tables, mkw = _mesh_inputs()
        return lambda: mpt.render_pt_mesh(*tables, **mkw)
    if key == "replay_rows":
        wid = torch.tensor([[[0, -1], [3, 1]]], dtype=torch.int32)  # [B 1, spp4 2, P 2]
        resv, g = torch.ones((1, 7, 2, 2)), torch.ones((3, 2))
        return lambda: rpk.replay_rows(wid, resv, g, layer0=1, layers=1)
    return {"wbvh": _wbvh_call, "bvh": _bvh_call}[key]()


@pytest.mark.parametrize("key,span", [
    ("fwd", "fwd"), ("fwd_idx", "fwd_idx"), ("bwd_replay", "bwd_replay"),
    ("bwd_recompute", "bwd_recompute"), ("segsum_paged", "segsum"), ("segsum_matmul", "segsum"),
    ("pt", "pt"), ("mesh_pt", "mesh_pt"), ("wbvh", "wbvh"), ("bvh", "bvh"),
    ("replay_rows", "replay_rows"),
])
def test_each_kernel_wrapper_spans_its_twin_path(key, span):
    call = _wrapper_call(key)
    launches = [dict(m.LAUNCHES) for m in (rk, hk, ptk, mpt, wk, bk, rpk)]
    ev = _apt_events(call)
    assert [e.name for e in ev] == [f"apt.kernel.{span}"]
    # The twin path launches nothing, so no count moves.
    assert [dict(m.LAUNCHES) for m in (rk, hk, ptk, mpt, wk, bk, rpk)] == launches


# ------------------------------------------------- the attribution ----
# Thread 1 holds the step; thread 2 is the autograd engine's device thread
# running the backward while thread 1 waits in apt.train_step.backward.
STEP = [("apt.train_step", 1, 0.0, 10.0), ("apt.train_step.backward", 1, 4.0, 8.0),
        ("apt.kernel.bwd_replay", 2, 5.0, 6.0), ("apt.train_step.update", 1, 8.5, 9.5)]
BACKWARD = ("apt.train_step", "apt.train_step.backward")


@pytest.mark.parametrize("spans_,launch,chain", [
    (STEP, (1, 1.0), ("apt.train_step",)),
    (STEP, (1, 4.5), BACKWARD),
    (STEP, (2, 5.5), ("apt.kernel.bwd_replay",)),
    (STEP, (2, 7.0), BACKWARD),
    (STEP, (2, 4.0), BACKWARD),  # at a span's start: inside it
    (STEP, (1, 9.0), ("apt.train_step", "apt.train_step.update")),
    (STEP, (1, 12.0), ()),
    (STEP, (3, 12.0), ()),
    # Two other threads hold spans: the innermost that began last waits.
    (STEP + [("apt.other", 3, 1.0, 20.0)], (2, 7.0), BACKWARD),
    (STEP + [("apt.other", 3, 6.5, 20.0)], (2, 7.0), ("apt.other",)),
])
def test_attribute_finds_the_launching_or_the_waiting_thread_s_span(spans_, launch, chain):
    assert spans.attribute(spans_, [launch]) == [chain]


def test_attribute_takes_launches_in_any_order():
    launches = [(2, 7.0), (1, 1.0), (2, 5.5), (1, 12.0)]
    assert spans.attribute(STEP, launches) == [
        BACKWARD, ("apt.train_step",), ("apt.kernel.bwd_replay",), ()]


@pytest.mark.parametrize("intervals,to,want", [
    ([(1.0, 3.0), (2.0, 4.0)], [(0.0, 10.0)], [(1.0, 4.0)]),
    ([(1.0, 3.0), (5.0, 9.0)], [(2.0, 6.0), (8.0, 8.5)], [(2.0, 3.0), (5.0, 6.0), (8.0, 8.5)]),
    ([(1.0, 2.0)], [(3.0, 4.0)], []),
])
def test_waits_are_clipped_to_the_spans(intervals, to, want):
    assert spans.clip(intervals, to) == want


def _event(name, id_, thread, a, b, device=False, annotation=False):
    return SimpleNamespace(
        name=name, id=id_, thread=thread, time_range=SimpleNamespace(start=a, end=b),
        device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU,
        is_user_annotation=annotation)


def test_records_link_by_id_and_leave_device_annotations_out():
    ev = [_event("apt.train_step", 5, 1, 0.0, 10.0),
          _event("cudaLaunchKernel", 77, 1, 1.0, 1.1),
          _event("k", 77, 0, 2.0, 3.0, device=True),
          _event("apt.train_step", 5, 0, 2.0, 3.0, device=True, annotation=True),
          _event("cudaStreamSynchronize", 78, 1, 4.0, 5.0),
          _event("Command Buffer Full", 0, 9, 6.0, 7.0)]
    sp, ops, launches, waits = spans.records(ev)
    assert sp == [("apt.train_step", 1, 0.0, 10.0)]
    assert ops == [("k", 77, 2.0, 3.0)]
    assert launches[77] == (1, 1.0)
    assert waits == [(4.0, 5.0), (6.0, 7.0)]
    got = spans.summary(SimpleNamespace(events=lambda: ev))
    assert got["ops"] == [["k", pytest.approx(2e-6), pytest.approx(3e-6), ["apt.train_step"]]]
    assert [w for pair in got["waits"] for w in pair] == pytest.approx([4e-6, 5e-6, 6e-6, 7e-6])


# ------------------------------------------------------- readers ----
CTX = {"trace": {"iterations": 2, "spans": {
    "spans": [["apt.train_step", 1, 0.0, 0.5], ["apt.mesh_diff.backward", 2, 0.6, 0.9]],
    "ops": [["fwd", 0.1, 0.3, ["apt.train_step", "apt.train_step.forward",
                               "apt.kernel.fwd_idx"]],
            ["pow", 0.3, 0.32, ["apt.train_step", "apt.train_step.loss"]],
            ["mul", 0.4, 0.5, ["apt.train_step", "apt.train_step.backward"]],
            ["sum", 0.6, 0.7, ["apt.mesh_diff.backward", "apt.replay.chunk",
                               "apt.kernel.segsum"]],
            ["where", 0.7, 0.76, ["apt.mesh_diff.backward", "apt.replay.chunk"]],
            ["item", 0.95, 0.96, []]],
    "waits": [[0.2, 0.25], [0.6, 0.61]]}}}


@pytest.mark.parametrize("metric,want", [
    ("launches_per_step.fit", 2.5),
    ("host_wait_ms.fit", 30.0),
    ("trainer_span_ms", 60.0),
    ("replay_span_ms", 30.0),
])
def test_readers_on_a_synthetic_context(metric, want):
    assert spans.READERS[metric](CTX) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(spans.READERS))
@pytest.mark.parametrize("ctx", [
    {},
    {"trace": {}},
    {"trace": {"iterations": 2, "device_events": [["k", 0.0, 1.0]]}},  # a program without spans
    {"trace": {"iterations": 2, "spans": {"spans": [], "ops": [], "waits": []}}},
])
def test_readers_give_none_without_spans(metric, ctx):
    assert spans.READERS[metric](ctx) is None


def test_summary_of_a_cpu_train_step():
    """On the CPU the step's spans are there and no device operation."""
    params, aux, rays, target = _train_problem()
    step = sharded.make_train_step(None, bounces=2, learning_rate=0.05)
    with profile(activities=CPU) as prof:
        step(params, aux, rays, target)
    got = spans.summary(prof)
    names = [s[0] for s in got["spans"]]
    assert names.count("apt.train_step") == 1 and "apt.kernel.bwd_replay" in names
    assert got["ops"] == [] and got["waits"] == []
    ctx = {"trace": {"iterations": 1, "spans": got}}
    assert spans.launches_per_step(ctx) == 0 and spans.span_ms(ctx, spans.TRAINER) is None
