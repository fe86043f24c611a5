"""Smoke test of the PyTorch/CUDA port (``ascendpathtracing_tpu_torch``) on
one CUDA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from the sources in this checkout (all seven
libraries at once), checks each against its plain PyTorch twin (and the
NumPy oracle) on the card, drives the main path once through the user
entry points (the differentiable render at 4,194,304 rays x 8 bounces of
cornell8, its forward, and the CLI, selftest and bench), then the fused
path tracer (cornell8, 1024 x 1024 pixels x 64 samples, 8 bounces, RR
from 5) through the bench's step, with the twin's record of its paths
(bounces per path, per warp and layer, and at zero throughput; phase
``pt_path_stats``), then the mesh path: the chunk-grid
traversal (4,194,304 camera rays against a 5,120-triangle icosphere, and a
3-level grid) through the first-hit query and selftest check 5, and the
fused sphere+mesh path tracer (1024 x 1024 x 64 samples of that
icosphere in smallpt9) through the bench's mesh step and the CLI, then
the mesh path's training step: the fused kernel's replay residuals, the
segment-sum kernel (csrc/segsum.cu) on the test shapes, a 1,310,720-slot
stream and the real replay stream, the full-size step through
``diff/mesh_fused.make_render_pt_mesh_diff`` and the bench, and a float64
finite-difference gate (twice: the sums and gradients repeat bit for
bit), then the fused kernel's camera and stats outputs against the twin,
the camera gradients at the s4 cell through
``diff/camera_fused.render_with_camera`` (depth against a float64 brute
force, a float64 finite-difference gate) and the s4 frame's per-tile walk
record, then the bounce-loop mesh renderer: the BVH
traversal kernel (csrc/bvh.cu) against its twin, the chunk kernel and
brute force on the camera rays and the bounced rays of the s4 cell, the
render at 1024 x 1024 x 4 samples x 8 bounces with either traversal
kernel, its fwd+bwd step through ``diff/mesh`` with a float64
finite-difference gate, and its CLI and bench entry points.  After the
main path's entry points come the trainer (``cli train`` at the main
path's 4,194,304 rays: 40 steps, then ``--resume`` for 20, bitwise equal
to a straight 60, every step counted through the forward with winners
and the replay backward, and timed), the CLI's post pipeline at 1024 x
1024 and ``cli oracle``, then the wavefront renderers (``models/wavefront``,
phases ``wavefront_*``: float64 parity with the bounce loops, the
mesh wavefront through wbvh.cu and bvh.cu bitwise against their twins
and its scatter through segsum.cu against the plain one, the JAX
bench's two wavefront cells at 1024 x 1024, cut to 8 samples a pixel,
beside the fused kernels' frames, and the CLI and bench routes); before
the A/B,
the sharded port (``parallel/``, phases ``sharded_*``, ``ring_pipelines_f64``,
``cli_shard``: worlds of 1, 2 and 4 ranks spawned on this card by
``run_local_world``, sharing it over gloo; the data-parallel training
step at the main path's 4,194,304 rays, the DP and DP x TP renders, the
s4 mesh render through wbvh.cu, the three rings in float64, ``cli render
--shard 2`` and the dry run), the ``debug`` dumps of
render_pt.cu, wbvh.cu and mesh_pt.cu (device printf read back from fd 1,
each equal to its twin's lines, every output bitwise the debug-off
launch's).  After the fused path tracer's phases come ``profiling``
(13c: ``utils/profiling.benchmark_fit`` of the main path's step beside
its CUDA-event median, and a ``trace`` that must name the render_ref.cu
kernels) and ``roofline_counts`` (13d: ``utils/roofline.count_ops`` of
the twins of fwd_idx, the replay and render_pt.cu at the kernels'
inputs, their bounds beside the hand model's and the kernels' ms, and
``utils/roofline.bound`` of each count at the measured ceilings).  The
native host library (``accel/native``,
g++) builds beside the CUDA libraries and is required; phase
``native_host`` (1c) checks that ``build_bvh``'s default takes it and
times it against the NumPy builder, and the PPM codec and OBJ loader
against the Python ones; phase 23 times bvh.cu on the NumPy builder's
tables too.  Phase ``ceilings`` (1d, right after ``native_host``) holds
the roofline probes of csrc/ceiling.cu (the op chains, the 256 MB copy
and read that replace benchmarks/roofline.py's Pallas probes) against
their twins on the JAX probes' inputs and on seeded random inputs at
the shapes it times (every chain at the elements that fill the card, the
256 MB copy bit for bit, the read within float32 summation error), runs
``utils/roofline.measure_ceilings`` (every row's ``fit_ok``), counts the
SASS of one chain step per op and reads the SM clock; ``ceilings_late``,
before the last lines, times the fma chain and the copy again beside
that phase's reading of them.
Right after
the build it runs the card-only tests (tests/test_torch_cuda.py) in a
pytest subprocess without the repository's conftest.  It proves
through the launch counters, reset
before each run, that each path went through its kernels, and times
kernels, plain versions and, where one PyTorch call computes the same
function, that call (``library_ms``) with CUDA events.  One line per
phase; the first failed check raises and the script exits non-zero.
With ``--parent DIR`` (the root of another checkout, e.g. the parent
commit's port unpacked with ``git archive``) it also times, for each
kernel whose sources differ between the two trees and which AB_SCRIPT
can time, that kernel's frames in each tree: AB_SCRIPT runs from each
tree's root with that tree's package, in turns (parent, new, new,
parent), on inputs this run saved to one file (the replay and gather
streams of the segment-sum, the bounce-1 rays of the chunk and BVH
kernels); the last phase,
``ab_vs_parent``, reports them, and requires the reference kernels'
outputs (colors, idx, gradients) and the render_pt, mesh_pt and wbvh
frames' outputs bitwise equal to the parent's.  The build phase requires
the registers of render_pt.cu's, wbvh.cu's and mesh_pt.cu's debug-off
instantiations equal to the parent's build, records the reference
kernels' registers and, from
``cuobjdump -sass``, the instructions of one bounce of each one's loop,
the issue floor they set and the first sqrt's slow-path check (with
``--parent``, the parent's too).
Before the last line it prints the card's name and power limit
(nvidia-smi) and one JSON object with a row per kernel (its ``launches``
are counted in the run its ``run`` field names; ``bound_ms`` is the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s,
reckoned from this run's inputs; ``bound_measured_ms`` the same bytes
and operations over the copy bandwidth and ``r_issue`` that phase
``ceilings`` measured: neither is a plain peak, since ``r_issue`` counts
JAX's nominal slots, above the card's instruction rate (the model's
``r_insn_ginsns``), and the copy row's measured bound is its own fit time
by construction); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or run alone (a directory that holds this script
and not the package beside it), it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from xml.etree import ElementTree

REPO = Path(__file__).resolve().parent
FULL_W = 1024  # 1024 x 1024 x 4 = 4,194,304 rays, the main path's size
BOUNCES = 8
PT_SPP4, PT_RR = 64, 5  # the fused path tracer's cell: 1024 x 1024 x 64
MESH_SUBDIV = 4  # the mesh cell: icosphere s4, 5,120 triangles, 16 per chunk
MESH_TWIN_SPP4 = 4  # the mesh twin's samples at full resolution (1/16 of the cell)
MESH_CHUNKS = 8  # replay chunks of diff/mesh_fused.LAYER_CHUNK (8) layers of 64
SEG_TOL = 1e-5  # segment-sum: |kernel - twin| <= SEG_TOL * sum of |rows| per segment
SEG_ATOMIC_MS = 2.185  # the earlier, atomic segment-sum on the real replay stream (PERF.md)
STATS_TILE = 2048  # with_stats: pixels per cell, the Pallas kernel's default tile
# The A/B against another checkout (``--parent``): run from a tree's root
# with a file of saved inputs and the frames to time as arguments, this
# code builds the kernels from that tree's sources, times each frame with
# that tree's package and prints {frame: median ms}.  The frames:
# render_pt.cu, the bench's PT cell (cornell8) and the same frame of
# smallpt9 (the s4 mesh cell's spheres alone); mesh_pt.cu, the bench's s4
# mesh frame; wbvh.cu and bvh.cu, the s4 mesh against the 4,194,304
# camera rays (phase 14) and against the 4,194,304 rays that leave bounce
# 1 of the bounce-loop render (phase 23, saved); segsum.cu, chunk 0
# of the s4 training step's replay stream (phase 20, saved) through
# segment_rows_paged and the bounce-1 gather stream (phase 25, saved)
# through segment_rows_matmul; render_ref.cu, the reference kernels at the
# main path's 4,194,304 cornell8 rays x 8 bounces in float32 (fwd, fwd_idx,
# the two backwards on phase 5's cotangent, and the bench's fwd+bwd step),
# each with a digest of its outputs (colors, idx, the [10, S] gradient), the
# same digests at phase 3's 256 x 256 rays in float64, and fwd_idx's share
# of rays whose trail differs from the plain twin's (phase 4); and a digest
# of every render_pt, mesh_pt and wbvh frame's outputs (image; tmin, slot,
# attrs).  Both trees load the same saved bytes.  It prints {"ms": {frame: median ms},
# "digests": {name: hex}, "facts": {name: value}}.
AB_SCRIPT = r"""
import hashlib, json, statistics, sys
import numpy as np, torch
from ascendpathtracing_tpu_torch import bench, camera, convert, scenes
from ascendpathtracing_tpu_torch.models import mesh as mm
from ascendpathtracing_tpu_torch.ops import build, bvh_kernels as bk
from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt, wbvh_kernels as wk
from ascendpathtracing_tpu_torch.ops import render_kernels as rk

dev = torch.device("cuda")
saved = torch.load(sys.argv[1], map_location=dev)
digests, facts = {}, {}

def digest(name, *ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    digests[name] = h.hexdigest()

def ref_inputs(w, np_dt):
    sc = scenes.cornell8()
    t = torch.float64 if np_dt == np.float64 else torch.float32
    r = camera.generate_rays_numpy(w, w, 1, seed=0).astype(np_dt)
    rp = convert.rays_planes_from_numpy(r, device=dev, dtype=t)
    g = torch.arange(3 * rp.shape[1], device=dev, dtype=t).reshape(3, -1)
    return rp, convert.scene_planes_from_numpy(sc.soa10(np_dt), device=dev, dtype=t), g, sc

def ref(frame):
    kw = dict(light_index=scenes.cornell8().light_index, bounces=8)
    for w, np_dt, tag in ((256, np.float64, "_f64_256"), (1024, np.float32, "")):
        rp, sp, g, sc = ref_inputs(w, np_dt)
        c, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
        if frame == "ref_fwd":
            digest(frame + tag, rk.render_reference_planes(rp, sp, **kw))
        elif frame == "ref_fwd_idx":
            digest(frame + tag, c, idx)
            if not tag:
                _, idx_p = rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
                facts["trail_differs_share"] = 1.0 - float((idx == idx_p).all(dim=0).float().mean())
        elif frame == "ref_bwd_replay":
            digest(frame + tag, rk.render_ref_bwd_replay(idx, sp, g, **kw))
        elif frame == "ref_bwd_recompute":
            digest(frame + tag, rk.render_ref_bwd(rp, sp, g, **kw))
    return {"ref_fwd": lambda: rk.render_reference_planes(rp, sp, **kw),
            "ref_fwd_idx": lambda: rk.render_reference_planes_with_idx(rp, sp, **kw),
            "ref_bwd_replay": lambda: rk.render_ref_bwd_replay(idx, sp, g, **kw),
            "ref_bwd_recompute": lambda: rk.render_ref_bwd(rp, sp, g, **kw)}[frame]

def ref_step():
    rp, _, _, sc = ref_inputs(1024, np.float32)
    step = bench.make_step("kernel", False, rp, sc, bounces=8)
    digest("ref_step", step()[1][0])
    return step

def cam_rays():
    return convert.rays_planes_from_numpy(
        camera.generate_rays_numpy(1024, 1024, 1, seed=0).astype(np.float32), device=dev)

def wbvh(rays):
    _, cb, sb, t24, _, grid = mpt.mesh_pt_tables(bench.mesh_scene(4), device=dev)
    kw = mpt.pt_tables_kwargs(grid, dev)
    return lambda: wk.intersect_chunks(rays, cb, sb, t24, attrs=True, **kw)

def bvh(rays):
    d = mm.mesh_scene_to_device(bench.mesh_scene(4), device=dev, pallas_bvh_kernel=True,
                                pallas_kernel="lockstep")
    return lambda: bk.intersect_bvh(rays, *d["pallas_bvh"], max_leaf=d["static"].max_leaf)

def segsum(fn, name):
    seg, vals, n_slots = saved[name]
    return lambda: fn(seg, vals, n_slots=n_slots)

frames = {  # kernel -> {frame: its step's maker}
    "render_pt": {"render_pt": lambda: bench.make_pt_step("kernel", True, scenes.cornell8(),
                                                          device=dev, bounces=8),
                  "render_pt_smallpt9": lambda: bench.make_pt_step(
                      "kernel", True, scenes.smallpt9(), device=dev, bounces=8)},
    "mesh_pt": {"mesh_pt": lambda: bench.make_mesh_step("kernel", bench.mesh_scene(4),
                                                        device=dev, bounces=8)[0]},
    "wbvh": {"wbvh": lambda: wbvh(cam_rays()),
             "wbvh_bounce1": lambda: wbvh(saved["bounce1_rays"])},
    "bvh": {"bvh": lambda: bvh(cam_rays()),
            "bvh_bounce1": lambda: bvh(saved["bounce1_rays"])},
    "segsum": {"segsum_replay": lambda: segsum(hk.segment_rows_paged, "replay"),
               "segsum_gather": lambda: segsum(hk.segment_rows_matmul, "gather")},
    "render_ref": {**{f: (lambda f=f: ref(f)) for f in
                      ("ref_fwd", "ref_fwd_idx", "ref_bwd_replay", "ref_bwd_recompute")},
                   "ref_step": ref_step},
}

def outputs(x):  # the tensors of a frame's result, in order
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in (x if isinstance(x, (tuple, list)) else ()) for t in outputs(y)]

build.build_all(sys.argv[2:])
out = {}
for kernel in sys.argv[2:]:
    for name, make in frames[kernel].items():
        step = make()
        if kernel in ("render_pt", "mesh_pt", "wbvh"):  # their debug-off outputs
            digest(name, *outputs(step()))
        out[name] = statistics.median(bench.time_steps(step, iters=10, warmup=2)[0])
        torch.cuda.empty_cache()
print(json.dumps({"ms": out, "digests": digests, "facts": facts}))
"""
AB_KERNELS = ("render_pt", "mesh_pt", "wbvh", "bvh", "segsum", "render_ref")  # AB_SCRIPT's
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s and float32 outside the tensor cores.
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# Operation counts of the bound: a ray-sphere test (3 sub, two dots, the
# discriminant, sqrt, two roots, the compares and selects), a live
# path-tracing bounce's shading (normal, BSDF sample, throughput, RR,
# offset), the reference bounce's shading, a camera ray, a triangle test
# and a box test.
SPHERE_OPS, PT_SHADE_OPS, REF_SHADE_OPS, CAM_OPS, TRI_OPS, BOX_OPS = 20, 60, 30, 40, 30, 20
CSRC = "ascendpathtracing_tpu_torch/csrc"
PALLAS = "ascendpathtracing_tpu/ops/pallas_kernels.py"
SOURCE = {  # launch counter -> its CUDA source
    "fwd": f"{CSRC}/render_ref.cu",
    "fwd_idx": f"{CSRC}/render_ref.cu",
    "bwd_replay": f"{CSRC}/render_ref.cu",
    "bwd_recompute": f"{CSRC}/render_ref.cu",
    "pt": f"{CSRC}/render_pt.cu",
    "wbvh": f"{CSRC}/wbvh.cu",
    "mesh_pt": f"{CSRC}/mesh_pt.cu",
    "segsum": f"{CSRC}/segsum.cu",
    "bvh": f"{CSRC}/bvh.cu",
    "chain": f"{CSRC}/ceiling.cu",
    "copy": f"{CSRC}/ceiling.cu",
    "read": f"{CSRC}/ceiling.cu",
}
REPLACES = {  # launch counter -> the TPU kernel it replaces
    "fwd": f"{PALLAS}:41",
    "fwd_idx": f"{PALLAS}:638",
    "bwd_replay": f"{PALLAS}:787",
    "bwd_recompute": f"{PALLAS}:923",
    "pt": f"{PALLAS}:226",
    "wbvh": "ascendpathtracing_tpu/ops/pallas_wbvh.py:528",
    "mesh_pt": "ascendpathtracing_tpu/ops/pallas_mesh_pt.py:111",
    # _paged_kernel (segment_rows_paged) and _hist_kernel (segment_rows_matmul)
    "segsum": "ascendpathtracing_tpu/ops/pallas_histogram.py:127, "
              "ascendpathtracing_tpu/ops/pallas_histogram.py:46",
    "bvh": "ascendpathtracing_tpu/ops/pallas_bvh.py:39",
    "chain": "benchmarks/roofline.py:76",
    "copy": "benchmarks/roofline.py:185",
    "read": "benchmarks/roofline.py:201",
}
# The user-facing runs, each counted from zero, and the launches each
# must make.  ``train_step`` is the main path (fwd + replay bwd); the
# inference render runs the forward without residual, and the
# replay=False training step the recompute backward (phase 6).
# ``pt_step`` is one step of the bench's fused path-tracing cell (phase
# 12); ``first_hit_mesh`` the mesh first-hit query in chunks mode and
# ``mesh_step`` one forward step of the bench's mesh cell (phase 17);
# ``mesh_train_step`` one training step of that cell: the forward with
# residuals and one segment-sum per replay chunk (phase 21).
# ``xla_mesh_*`` are the bounce-loop mesh renderer at the bench's xla-mesh
# cell: one traversal launch per bounce (phases 24-25).  ``camera_step``
# is the camera-gradient step at the mesh cell (phase 22b): one fused
# launch with residuals and screen coordinates; with the tables requiring
# grad too, their two gathers' backward adds one segment-sum each.
_NONE = dict.fromkeys(SOURCE, 0)
RUNS = {
    "train_step": {**_NONE, "fwd_idx": 1, "bwd_replay": 1},
    "inference_render": {**_NONE, "fwd": 1},
    "train_step_recompute": {**_NONE, "fwd": 1, "bwd_recompute": 1},
    "pt_step": {**_NONE, "pt": 1},
    "first_hit_mesh": {**_NONE, "wbvh": 1},
    "mesh_step": {**_NONE, "mesh_pt": 1},
    "mesh_train_step": {**_NONE, "mesh_pt": 1, "segsum": MESH_CHUNKS},
    "xla_mesh_fwd_chunks": {**_NONE, "wbvh": BOUNCES},
    "xla_mesh_fwd_lockstep": {**_NONE, "bvh": BOUNCES},
    # + 2 segment-sums per 9-plane gather's backward, 2 gathers a bounce;
    # the last bounce's hit distance moves only the next origin, which no
    # output reads, so its recompute gather has no backward
    "xla_mesh_train_step": {**_NONE, "wbvh": BOUNCES, "segsum": 4 * BOUNCES - 2},
    "camera_step": {**_NONE, "mesh_pt": 1},
    "camera_step_tables": {**_NONE, "mesh_pt": 1, "segsum": 2},
}
RUN_OF = {  # kernel -> the run whose count its row reports
    "fwd": "inference_render",
    "fwd_idx": "train_step",
    "bwd_replay": "train_step",
    "bwd_recompute": "train_step_recompute",
    "pt": "pt_step",
    "wbvh": "first_hit_mesh",
    "mesh_pt": "mesh_step",
    "segsum": "mesh_train_step",
    "bvh": "xla_mesh_fwd_lockstep",
}
BVH_SLICE = 262144  # rays of the BVH twin's check and timing (the twin is slow)


class SmokeFailure(RuntimeError):
    pass


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


T0 = time.time()


def phase(name, **fields):
    """One phase's JSON line; ``t`` is the seconds since the script began."""
    print(json.dumps({"phase": name, **fields, "t": time.time() - T0}), flush=True)


def spills_by_kernel(log: str) -> dict:
    """nvcc --resource-usage log -> {function: (spill store bytes, spill
    load bytes)}."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), int(m.group(2)))
    return out


def registers_by_kernel(log: str) -> dict:
    """nvcc --resource-usage log -> {entry function: registers}."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            out[cur] = int(m.group(1))
    return out


def kernel_key(lib: str, name: str):
    """The instantiation a mangled kernel name of ``lib`` stands for, in
    words that do not depend on the tree (None for other functions):
    render_pt "<f32|f64>[_debug]"; wbvh "<f32|f64>_<Rows24|RowsStrided>
    [_stats][_debug]" (the mangled bools are kStats, then, where the tree
    has it, kDump); mesh_pt "<f32|f64>_<forward|residuals|camera>[_debug]
    [_stats]"."""
    if lib == "render_pt" and "render_pt_kernel" in name:
        return ("f32" if "render_pt_kernelIf" in name else "f64") + (
            "_debug" if "AliveDump" in name else "")
    if lib == "wbvh":
        m = re.search(r"wbvh_kernelI([fd])NS_\d+(Rows24|RowsStrided)E((?:Lb[01]E)+)", name)
        if m:
            flags = re.findall(r"Lb([01])E", m.group(3)) + ["0"]
            return (f"f{'32' if m.group(1) == 'f' else '64'}_{m.group(2)}"
                    + ("_stats" if flags[0] == "1" else "") + ("_debug" if flags[1] == "1" else ""))
    if lib == "mesh_pt" and "render_pt_mesh_kernel" in name:
        sink = ("camera" if "CameraResiduals" in name else
                "forward" if "NoResiduals" in name else "residuals")
        return (f"{'f32' if 'render_pt_mesh_kernelIf' in name else 'f64'}_{sink}"
                + ("_debug" if "DumpStats" in name else "")
                + ("_stats" if "CellStats" in name else ""))
    return None


def keyed(lib: str, by_name: dict) -> dict:
    """{mangled name: value} -> {kernel_key: value} for ``lib``'s kernels."""
    return {kernel_key(lib, n): v for n, v in by_name.items() if kernel_key(lib, n)}


def sass_listing(insns) -> list:
    """A function's SASS instructions without what depends on the rest of
    the module: labels numbered in the function's own order; symbols (the
    callee subroutines, named after the kernel and numbered across the
    module) by their last part with its digits dropped; and the slot of a
    module global's address in constant bank 4 (a new kernel's printf
    format strings move the others' slots)."""
    labels = {}

    def label(m):
        return f"L{labels.setdefault(m.group(0), len(labels))}"

    def symbol(m):
        return "$" + re.sub(r"\d+", "#", m.group(0).split("$")[-1])

    return [re.sub(r"c\[0x4\]\[0x[0-9a-f]+\]", "c[0x4][#]",
                   re.sub(r"\$[^)`\s]+", symbol, re.sub(r"\.L_x_\d+", label, t)))
            for _, t in insns]


def sass_listings(lib: Path) -> dict:
    """{mangled function: sass_listing} of ``lib`` (``cuobjdump -sass``);
    {} without the tool."""
    from ascendpathtracing_tpu_torch.ops import build

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    funcs = sass_functions(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                                          text=True, check=True, timeout=300).stdout)
    return {f: sass_listing(insns) for f, (insns, _) in funcs.items()}


def same_sass(old_lib: Path, new_lib: Path, lib: str) -> dict:
    """For each instantiation of the parent's ``old_lib``: whether the new
    build's has the same instructions, or the count of lines that differ
    and the first pair."""
    old, new = (keyed(lib, sass_listings(p)) for p in (old_lib, new_lib))
    out = {}
    for key, a in old.items():
        b = new.get(key, [])
        if a == b:
            out[key] = True
            continue
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        out[key] = {"lines": [len(a), len(b)], "differ": len(diff) + abs(len(a) - len(b)),
                    "first": diff[:1]}
    return out


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
SASS_BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
# The reference kernels of render_ref.cu whose SASS the build phase
# counts: (name in the report, mangled-name stem, the mangled template
# argument the instantiation must carry).  Float32 at cornell8's S = 8
# (``Li8E``; a tree whose kernel takes S at run time carries none, and
# ref_sass_report then takes its one instantiation).
REF_SASS = (("fwd", "render_ref_fwd_kernelIfLb0E", "Li8E"),
            ("fwd_idx", "render_ref_fwd_kernelIfLb1E", "Li8E"),
            ("bwd_recompute", "render_ref_bwd_recompute_kernelIf", "Li8E"),
            ("bwd_replay", "render_ref_bwd_replay_kernelIf", "Li8E"))


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {mangled function: (instructions as
    [(address, text)], {label: address of the instruction after it})}."""
    out, cur, pending = {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur, pending = ([], {}), []
            out[m.group(1)] = cur
            continue
        if cur is None:
            continue
        m = SASS_LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = SASS_INSN.search(ln)
        if m:
            pc = int(m.group(1), 16)
            for label in pending:
                cur[1][label] = pc
            pending = []
            cur[0].append((pc, m.group(2).strip()))
    return out


def sass_opcode(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]


def sass_target(text: str, labels: dict):
    """The address a branch goes to, or None."""
    m = SASS_BRA.search(text)
    if not m:
        return None
    return int(m.group(1), 16) if m.group(1).startswith("0x") else labels.get(m.group(1))


def sass_skipped_calls(insns, labels) -> set:
    """Indices of the instructions that sqrt's and division's fast path
    jumps over: for each CALL of a slow path, from the nearest conditional
    branch before it whose target lies after it (the branch not
    included) to that target (not included)."""
    index = {pc: i for i, (pc, _) in enumerate(insns)}
    out = set()
    for i, (pc, t) in enumerate(insns):
        if not sass_opcode(t).startswith("CALL"):
            continue
        for j in range(i - 1, -1, -1):
            tj = insns[j][1]
            to = sass_target(tj, labels) if tj.startswith("@") else None
            if sass_opcode(tj) == "BRA" and to is not None and to > pc and to in index:
                out.update(range(j + 1, index[to]))
                break
    return out


def sass_bounce_loop(insns, labels, spheres: int) -> dict:
    """The bounce loop of a reference kernel's SASS: the outermost loop (a
    backward branch) holding a ``MUFU.RSQ`` (each sqrt and 1/sqrt has
    one).  ``per_bounce`` counts the instructions of one trip at
    ``spheres`` spheres: the loop's own, plus each loop nested in it times
    its trips, a nested loop with k ``MUFU.RSQ`` (k spheres unrolled)
    running as many trips of the ``spheres`` as it can (largest k first).
    The calls of the slow paths of sqrt and division and the
    instructions around them (``sass_skipped_calls``) are not counted, nor
    the called code, which lies outside the loop."""
    loops = sorted({(to, pc) for pc, t in insns
                    if (to := sass_target(t, labels)) is not None and to <= pc})
    stubs = sass_skipped_calls(insns, labels)
    ops = [(pc, sass_opcode(t)) for i, (pc, t) in enumerate(insns) if i not in stubs]

    def body(lo, hi):
        return [o for pc, o in ops if lo <= pc <= hi]

    def rsq(lo, hi):
        return sum(o.startswith("MUFU.RSQ") for o in body(lo, hi))

    def outermost(lps):
        return [lp for lp in lps
                if not any(o != lp and o[0] <= lp[0] and lp[1] <= o[1] for o in lps)]

    def ldg(lo, hi):
        return sum(o.startswith("LDG") for o in body(lo, hi))

    outer = outermost([lp for lp in loops if rsq(*lp)])
    if not outer:
        # No intersection (the replay): the largest loop that loads (a
        # winner per bounce, unrolled); per bounce = its instructions over
        # its loads.
        with_ldg = [lp for lp in loops if ldg(*lp)]
        if not with_ldg:
            return {"loops": len(loops), "per_bounce": None}
        big = max(with_ldg, key=lambda lp: len(body(*lp)))
        loop = body(*big)
        return {"per_bounce": round(len(loop) / ldg(*big)), "loop_instructions": len(loop),
                "bounces_per_trip": ldg(*big),
                "LDL": sum(o.startswith("LDL") for o in loop),
                "STL": sum(o.startswith("STL") for o in loop)}
    lo, hi = outer[0]
    children = outermost([lp for lp in loops if lp != (lo, hi) and lo <= lp[0] and lp[1] <= hi])
    own = [o for pc, o in ops if lo <= pc <= hi and not any(c[0] <= pc <= c[1] for c in children)]
    count, left, trips = len(own), spheres, []
    for c in sorted(children, key=lambda c: -rsq(*c)):
        k = rsq(*c)
        n = left // k if k else 1
        left -= n * k
        count += n * len(body(*c))
        trips.append({"instructions": len(body(*c)), "spheres_per_trip": k, "trips": n})
    if trips:
        # A runtime sphere loop unrolled k times leaves the last S mod k
        # spheres to tests outside it, in the bounce loop's own code: one
        # MUFU.RSQ each (the bounce's 1/sqrt is the one followed by a
        # MUFU.RCP).  Those past the ``left`` spheres do not run; take
        # them out at the unrolled loop's instructions per sphere.
        tests = sum(o.startswith("MUFU.RSQ") and "MUFU.RCP" not in own[i:i + 24]
                    for i, o in enumerate(own))
        per_sphere = trips[0]["instructions"] / trips[0]["spheres_per_trip"]
        count -= round((tests - left) * per_sphere)
        trips.append({"remainder_tests": tests, "run": left, "instructions_per_sphere": per_sphere})
    loop = body(lo, hi)

    def n_op(prefix):
        return sum(o.startswith(prefix) for o in loop)

    return {"per_bounce": count, "loop_instructions": len(loop), "nested_loops": trips,
            "LDS": n_op("LDS"), "LDC": n_op("LDC") + n_op("ULDC"), "LDL": n_op("LDL"),
            "STL": n_op("STL"), "MUFU.RSQ": n_op("MUFU.RSQ"),
            "slow_path_calls": sum(sass_opcode(t).startswith("CALL") for pc, t in insns
                                   if lo <= pc <= hi)}


def sqrt_slow_path(insns) -> dict:
    """Which inputs the first float sqrt's range check sends to its slow
    path: the ``IADD3 Rt, Rx, -K`` and ``ISETP.GT.U32 P, PT, Rt, L`` that
    guard it (slow when the bits of x minus K exceed L, unsigned; the
    compiler may write the subtraction as a ``VIADD`` of 2^32 - K), judged
    at 0, 1 and a negative number; the guarding lines themselves."""
    texts = [t for _, t in insns]
    for i, t in enumerate(texts):
        if sass_opcode(t) != "MUFU.RSQ":
            continue
        near = texts[max(0, i - 8):i + 8]
        # t = x - K as "IADD3 Rt, Rx, -K, RZ" or "VIADD Rt, Rx, 2^32 - K"
        add = next((m for s in near if (m := re.search(
            r"(?:IADD3|VIADD) (R\d+), (R\d+), (-?)(0x[0-9a-f]+)", s))), None)
        cmp_ = next((m for s in near if add and (m := re.search(
            rf"ISETP\.GT\.U32\.AND P\d, PT, {add.group(1)}, (0x[0-9a-f]+)", s))), None)
        if add and cmp_:
            k = int(add.group(4), 16) * (-1 if add.group(3) else 1)
            lim = int(cmp_.group(1), 16)
            slow = {name: ((bits + k) & 0xFFFFFFFF) > lim for name, bits in
                    (("0", 0x0), ("1", 0x3F800000), ("-1", 0xBF800000))}
            return {"slow_path_at": slow, "lines": near}
        return {"slow_path_at": "range check not found", "lines": near}
    return {"slow_path_at": "no MUFU.RSQ"}


def ref_sass_report(lib: Path, n_rays: int, bounces: int, spheres: int, clock_mhz: float) -> dict:
    """Per reference kernel of ``lib`` (REF_SASS): the bounce loop's SASS
    counts and the issue floor, the least time 132 SMs x 4 schedulers at
    ``clock_mhz`` take to issue one instruction per warp per cycle for
    ``n_rays`` rays x ``bounces`` bounces; the first float sqrt's slow-path
    check.  {"cuobjdump": "not found"} without the tool."""
    from ascendpathtracing_tpu_torch.ops import build

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"cuobjdump": "not found"}
    funcs = sass_functions(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                                          text=True, check=True, timeout=300).stdout)
    out = {}
    for name, stem, arg in REF_SASS:
        fn = next((f for f in funcs if stem in f and (arg in f
                                                     or "Li" not in f.split(stem)[1][:4])), None)
        if fn is None:
            out[name] = {"function": None}
            continue
        insns, labels = funcs[fn]
        loop = sass_bounce_loop(insns, labels, spheres)
        loop["sass_sha256"] = hashlib.sha256("\n".join(t for _, t in insns).encode()).hexdigest()
        if loop["per_bounce"] is not None:
            warp_insns = -(-n_rays // 32) * bounces * loop["per_bounce"]
            loop["issue_floor_ms"] = warp_insns / (132 * 4 * clock_mhz * 1e6) * 1e3
        out[name] = {"function": fn, **loop}
    fwd = out["fwd"]["function"]
    out["sqrt"] = sqrt_slow_path(funcs[fwd][0]) if fwd else {}
    return out


def kernel_sources(root: Path, name: str) -> dict:
    """{file name: bytes} of csrc/<name>.cu in the tree at ``root`` and
    of every csrc header it includes, directly or not."""
    csrc = root / CSRC
    out, todo = {}, [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in out or not (csrc / f).exists():
            continue
        out[f] = (csrc / f).read_bytes()
        todo += re.findall(r'#include "([^"]+)"', out[f].decode())
    return out


def ab_kernels(root: Path) -> tuple:
    """(the kernels whose sources differ between this tree and ``root``'s
    that AB_SCRIPT times, those it cannot)."""
    changed = [n.stem for n in sorted((REPO / CSRC).glob("*.cu"))
               if kernel_sources(REPO, n.stem) != kernel_sources(root, n.stem)]
    return ([n for n in changed if n in AB_KERNELS],
            [n for n in changed if n not in AB_KERNELS])


def run_in_tree(root: Path, code: str, args, timeout: int) -> str:
    """Runs ``code`` with ``args`` in a Python process of its own from the
    tree at ``root`` (its package first on the path); its stdout."""
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=root,
                          env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
                          text=True, timeout=timeout, check=False)
    require(proc.returncode == 0, f"{root}: {proc.stderr[-3000:]}")
    return proc.stdout


def bound(nbytes, ops) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM_BPS and the operations over FP32_OPS, each also given, and the
    bytes and operations themselves."""
    b_ms, o_ms = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return ({"bound_ms": b_ms, "bound_by": "bytes"} if b_ms >= o_ms
            else {"bound_ms": o_ms, "bound_by": "operations"}) | {
        "bound_bytes_ms": b_ms, "bound_ops_ms": o_ms, "bound_bytes": nbytes, "bound_ops": ops}


def walk_ops(counts, n_rays, grid, roots=None) -> int:
    """Operations of a chunk-grid walk: each ray tests the top level's
    boxes, each box it hits its children's boxes, each chunk it enters
    that chunk's triangles.  ``counts`` = (chunks tested, supers hit,
    super-supers hit) summed over the rays.  With ``roots`` (the rays
    entering the root box, the warp walk's), each ray tests the root
    and only those rays the top level."""
    chunks, supers, supers2 = counts
    top = grid.n_supers2 or grid.n_supers or grid.n_chunks
    boxes = (n_rays * top if roots is None else n_rays + roots * top)
    if grid.n_supers2:
        boxes += supers2 * grid.supers2_per + supers * grid.supers_per
    elif grid.n_supers:
        boxes += supers * grid.supers_per
    return boxes * BOX_OPS + chunks * grid.tris_per_chunk * TRI_OPS


def image_from_residuals(wid, resv, spp4, chunk):
    """The per-pixel mean image [3, W*H] rebuilt in float64 from the replay
    residuals alone, ``chunk`` sample layers at a time:
    L = sum_b live_b tput_{b-1} e_b with tput_b = tput_{b-1} a_b s_b.
    Checks on the way that a dead bounce is followed by dead bounces only
    and holds zeros."""
    import torch

    img = torch.zeros((3, wid.shape[2]), dtype=torch.float64, device=wid.device)
    for a0 in range(0, spp4, chunk):
        tput, rad, prev = None, 0.0, None
        for b in range(wid.shape[0]):
            live = wid[b, a0:a0 + chunk] >= 0  # [L, P]
            r = resv[b, :, a0:a0 + chunk].double()  # [7, L, P]
            require(prev is None or not bool((live & ~prev).any()),
                    f"residuals: a live bounce {b} after a dead one")
            require(not bool(r[:, ~live].any()), f"residuals: bounce {b} dead but not zero")
            if tput is None:
                tput = torch.ones((3,) + tuple(live.shape), dtype=torch.float64,
                                  device=wid.device)
            rad = rad + torch.where(live, tput * r[3:6], 0.0)
            tput = tput * torch.where(live, r[0:3] * r[6], 1.0)
            prev = live
        img += rad.sum(dim=1)
    return img / spp4


WF_POOL = 1 << 19  # the JAX bench's wavefront pool (bench.py:82)
WF_W, WF_SPP4 = 64, 16  # the wavefront's parity checks: 64 x 64 x 16 samples
WF_PROFILE_SPP4 = 8  # the wavefront frame traced by torch.profiler: 1024 x 1024 x 8
# The wavefront cells' samples a pixel: the JAX bench's cells at full
# width, their depth cut from the bench's 64 samples to 8 to keep the
# script inside its time limit.
WF_CELL_SPP4 = 8


def wavefront_phases(dev, gpu, kernel_mods) -> dict:
    """The wavefront renderers (models/wavefront) on the card, phases
    ``wavefront_*``.  Each run is counted from zero -> {run: launches},
    and the segment-sum's numbers at the wavefront's scatter for the
    kernels line under ``"segsum"``.

    - ``wavefront_f64_64x64_spp16``: float64, 64 x 64 x 16 samples, 8
      bounces, RR from 5: ``render_wavefront`` (cornell8, smallpt9; a pool
      of 8,192 and one of every sample without compaction) and
      ``render_wavefront_mesh`` (the mesh-cube scene, brute force;
      coherence sort on and off, sort_every 1 and 2) against the per-pixel
      means of ``render_pt_impl`` / ``render_pt_mesh_impl`` on the
      wavefront's own camera rays, rtol 1e-12.
    - ``wavefront_kernels_vs_twins``: the mesh cell's scene (icosphere s4
      in smallpt9) at 64 x 64 x 16, pool 16,384: the render through
      ``wbvh.cu`` (chunks) and ``bvh.cu`` (lockstep) bitwise against the
      same render with the kernel's twin swapped in, one traversal launch
      and one ``segsum.cu`` launch an iteration, two runs bitwise; the
      ``segsum.cu`` scatter against the plain scatter in float64, rtol
      1e-12.
    - ``wavefront_pt_1024x1024_spp8`` and ``wavefront_mesh_1024x1024_spp8``:
      the JAX bench's two wavefront cells at full width and 8 samples a
      pixel (WF_CELL_SPP4; the bench's 64 cut), pool 2**19: frame ms by CUDA
      events (median of 2 after the counted frame), iterations, ms per iteration,
      the segment-sum's launches and ms, the idle share under
      torch.profiler, two runs bitwise, pool 2**18 against 2**19 (and
      sort_every 2 against 1) within rtol 1e-6, and the mean within 4
      standard errors of the fused kernel's frame (render_pt.cu,
      mesh_pt.cu) at the same size, timed beside it.  The pt cell's
      100th scatter (2**19 rows into 1,048,576 slots) is held against the
      plain scatter, each into float64 zeros, at rtol 1e-12, and timed
      beside it and ``index_add_``; its bound counts an add into an
      existing accumulator (seg, the dying rows' values, and the slots
      they touch read and written).  Iterations are
      ``models/wavefront.STATS``'s, each with one ``segsum.cu`` launch.
    - ``wavefront_entry_points``: ``cli render --renderer wavefront`` on a
      sphere and a mesh scene (256 x 256 x 4 samples) and ``bench
      --renderer wavefront`` in both modes (256 x 256 x 16, 12 frames),
      counted.
    """
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import bench, cli, convert, scenes
    from ascendpathtracing_tpu_torch.camera import Camera
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.models import mesh as mm
    from ascendpathtracing_tpu_torch.models import wavefront as wf
    from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
    from ascendpathtracing_tpu_torch.ops import histogram_kernels as segk
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
    from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
    from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk

    t_begin = time.time()
    launches = {}

    def counted(run):
        torch.cuda.synchronize()
        for mod in kernel_mods:
            mod.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items() if v}

    def max_rel(a, b):
        nz = b != 0
        return float(((a - b)[nz].abs() / b[nz].abs()).max()) if nz.any() else 0.0

    def med_ms(step, iters=3, warmup=1):
        return statistics.median(bench.time_steps(step, iters=iters, warmup=warmup)[0])

    def z_score(a, b):
        """Mean of the per-pixel difference [3, W*H] over its standard
        error (of the pixel count, as phase 24's)."""
        diff = (a - b).double()
        return float(diff.mean()) / (float(diff.std()) / diff[0].numel() ** 0.5)

    @contextlib.contextmanager
    def swapped(mod, name, fn):
        """mod.name replaced by fn inside the block (the twins, here only)."""
        saved = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, saved)

    # ---- wavefront_f64_64x64_spp16 -------------------------------------
    w, spp4 = WF_W, WF_SPP4
    total = w * w * spp4
    kw = dict(width=w, height=w, spp4=spp4, bounces=BOUNCES, rr_depth=PT_RR)
    o3, d3, _, _ = wf._sample_camera_rays(torch.arange(total, device=dev), w, w, spp4, 0,
                                          Camera(), torch.float64)
    rays64 = torch.stack([*o3, *d3], dim=1)

    def pixel_means(colors):
        return colors.reshape(w * w, spp4, 3).mean(dim=1)

    f64 = {}
    for name in ("cornell8", "smallpt9"):
        sc = megakernel.scene_to_device(scenes.get_scene(name), device=dev, dtype=torch.float64)
        ref = pixel_means(megakernel.render_pt_impl(rays64, sc, bounces=BOUNCES,
                                                    rr_depth=PT_RR))
        for pool, compact in ((8192, True), (total, False)):
            img = wf.render_wavefront(0, sc, pool=pool, compact=compact, dtype=torch.float64,
                                      **kw)
            require(bool(torch.allclose(img, ref, rtol=1e-12, atol=0.0)),
                    f"wavefront f64 {name} pool {pool}: vs render_pt_impl {max_rel(img, ref)}")
            f64[f"{name}_pool{pool}"] = {"max_rel_err": max_rel(img, ref),
                                         "bitwise": bool(torch.equal(img, ref))}
    bdev = mm.mesh_scene_to_device(cli._mesh_scene("cube"), device=dev, dtype=torch.float64,
                                   use_bvh=False)
    ref = pixel_means(mm.render_pt_mesh(rays64, bdev, bounces=BOUNCES, rr_depth=PT_RR))
    for coherence, every in ((True, 1), (False, 2)):
        img = wf.render_wavefront_mesh(0, bdev, pool=8192, coherence_sort=coherence,
                                       sort_every=every, dtype=torch.float64, **kw)
        require(bool(torch.allclose(img, ref, rtol=1e-12, atol=0.0)),
                f"wavefront mesh f64 sort {coherence}/{every}: {max_rel(img, ref)}")
        f64[f"mesh_cube_brute_sort{int(coherence)}_every{every}"] = {
            "max_rel_err": max_rel(img, ref), "bitwise": bool(torch.equal(img, ref))}
    del rays64, bdev, ref, img
    phase("wavefront_f64_64x64_spp16", tolerance="allclose rtol 1e-12 vs the bounce loop's "
          "per-pixel means on the wavefront's camera rays", **f64)

    # ---- wavefront_kernels_vs_twins ------------------------------------
    ms4 = bench.mesh_scene(MESH_SUBDIV)
    kw_t = dict(kw, pool=16384)
    vs_twins = {}
    for trav, mod, name, twin, kernel in (
            ("chunks", wk, "intersect_chunks", wk.intersect_chunks_plain, "wbvh"),
            ("lockstep", bk, "intersect_bvh", bk.intersect_bvh_plain, "bvh")):
        mdev = mm.mesh_scene_to_device(ms4, device=dev, pallas_bvh_kernel=True,
                                       pallas_kernel=trav, tris_per_chunk=16)
        run = f"wavefront_mesh_{trav}_64x64"
        img_k, launches[run] = counted(lambda: wf.render_wavefront_mesh(0, mdev, **kw_t))
        it = wf.STATS["iterations"]
        require(it > 0 and launches[run] == {kernel: it, "segsum": it},
                f"{run}: launches {launches[run]}")
        require(torch.equal(img_k, wf.render_wavefront_mesh(0, mdev, **kw_t)),
                f"{run}: two runs differ")
        with swapped(mod, name, twin):
            img_t, l_t = counted(lambda: wf.render_wavefront_mesh(0, mdev, **kw_t))
        require(l_t == {"segsum": it}, f"{run} with the {kernel} twin: launches {l_t}")
        require(torch.equal(img_k, img_t), f"{run}: {kernel}.cu and its twin differ")
        vs_twins[trav] = {"kernel": kernel, "launches": launches[run], "bitwise_vs_twin": True,
                          "two_runs_bitwise": True, "mean": float(img_k.mean())}
    # the scatter: segsum.cu against the plain segment-sum, float64 pool
    mdev = mm.mesh_scene_to_device(ms4, device=dev, pallas_bvh_kernel=True, tris_per_chunk=16)

    def plain_scatter(seg, vals, *, n_slots, out, **_):
        return segk.segment_rows_plain(seg, vals, n_slots=n_slots, out=out)

    img_k = wf.render_wavefront_mesh(0, mdev, dtype=torch.float64, **kw_t)
    with swapped(segk, "segment_rows_matmul", plain_scatter):
        img_p, l_p = counted(lambda: wf.render_wavefront_mesh(0, mdev, dtype=torch.float64,
                                                               **kw_t))
    require(set(l_p) == {"wbvh"}, f"plain scatter run: launches {l_p}")
    require(bool(torch.allclose(img_k, img_p, rtol=1e-12, atol=0.0)),
            f"wavefront scatter: segsum.cu vs plain {max_rel(img_k, img_p)}")
    vs_twins["segsum_f64"] = {"max_rel_err": max_rel(img_k, img_p),
                              "bitwise": bool(torch.equal(img_k, img_p))}
    phase("wavefront_kernels_vs_twins", gpu=gpu, size=f"{w}x{w}x{spp4}", pool=16384,
          tolerance="traversal bitwise vs twin; scatter rtol 1e-12 in float64", **vs_twins)
    del mdev, img_k, img_t, img_p

    # ---- the two cells at full size ------------------------------------
    full = dict(width=FULL_W, height=FULL_W, spp4=WF_CELL_SPP4, bounces=BOUNCES,
                rr_depth=PT_RR)
    n_samples = FULL_W * FULL_W * WF_CELL_SPP4
    grabbed = {}
    scatter = segk.segment_rows_matmul

    def grab(seg, vals, **kwargs):  # keeps the 100th scatter's inputs (or the last)
        grabbed["calls"] = grabbed.get("calls", 0) + 1
        if grabbed["calls"] <= 100:
            grabbed["args"] = (seg.clone(), vals.clone(), kwargs["n_slots"])
        return scatter(seg, vals, **kwargs)

    def cell(run, frame, fused_frame, fused_ms):
        """Counts, times and checks one full-size cell -> its numbers."""
        img, launches[run] = counted(frame)
        it = wf.STATS["iterations"]
        require(it > 0 and launches[run].get("segsum") == it and bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0,
                f"{run}: launches {launches[run]}, finite {bool(torch.isfinite(img).all())}")
        times, img2 = bench.time_steps(frame, iters=2, warmup=0)  # warmed by the count
        require(torch.equal(img, img2), f"{run}: two runs differ")
        frame_ms = statistics.median(times)
        z = z_score(img.T, fused_frame)
        require(abs(z) < 4.0, f"{run}: mean vs the fused kernel's at {z} SE")
        return img, {"launches": launches[run], "iterations": it, "frame_ms": frame_ms,
                     "frame_ms_runs": times, "ms_per_iteration": frame_ms / it,
                     "msamples_per_s": n_samples / (frame_ms * 1e-3) / 1e6,
                     "two_runs_bitwise": True, "mean": float(img.mean()),
                     "fused_frame_ms": fused_ms, "fused_mean": float(fused_frame.mean()),
                     "z_vs_fused": z, "x_fused_ms": frame_ms / fused_ms}

    def idle_share(frame):
        """The profiler's summary of one frame of WF_PROFILE_SPP4 samples a
        pixel (the cell's pool and iterations, fewer of them: the trace of
        a full frame holds millions of events)."""
        prof = bench.profile_steps(frame, iters=1, top=6)
        return {"iterations": wf.STATS["iterations"], **{
            k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step", "idle_share",
                                 "device_events_per_step", "top_device_ms_per_step")}}

    planes, mats = (convert.scene_planes_from_numpy(scenes.cornell8().soa10(), device=dev),
                    torch.tensor(scenes.cornell8().material, dtype=torch.int32, device=dev))
    pt_frame = ptk.render_pt(planes, mats, **full)
    pt_ms = med_ms(lambda: ptk.render_pt(planes, mats, **full), iters=10, warmup=2)
    sc = megakernel.scene_to_device(scenes.cornell8(), device=dev)
    with swapped(segk, "segment_rows_matmul", grab):
        img, pt_cell = cell("wavefront_pt", lambda: wf.render_wavefront(
            0, sc, pool=WF_POOL, **full), pt_frame, pt_ms)
    img18 = wf.render_wavefront(0, sc, pool=WF_POOL >> 1, **full)
    require(bool(torch.allclose(img18, img, rtol=1e-6, atol=0.0)),
            f"wavefront pt: pool 2**18 vs 2**19 {max_rel(img18, img)}")
    pt_cell.update(pool=WF_POOL, pool_2e18={"max_rel_err": max_rel(img18, img),
                                            "bitwise": bool(torch.equal(img18, img))},
                   profile=idle_share(lambda: wf.render_wavefront(
                       0, sc, pool=WF_POOL, **dict(full, spp4=WF_PROFILE_SPP4))))
    # the scatter at the cell's shapes: the 100th iteration's rows, held
    # against the plain scatter (each into float64 zeros), then timed
    seg, vals, n_slots = grabbed["args"]
    got = segk.segment_rows_matmul(seg, vals, n_slots=n_slots, out=torch.zeros(
        (n_slots, 3), dtype=torch.float64, device=dev))
    want = segk.segment_rows_plain(seg, vals, n_slots=n_slots, out=torch.zeros(
        (n_slots, 3), dtype=torch.float64, device=dev))
    require(bool(torch.allclose(got, want, rtol=1e-12, atol=0.0)),
            f"wavefront scatter at {seg.shape[0]} rows x {n_slots} slots: segsum.cu vs plain "
            f"{max_rel(got, want)}")
    seg_vs_plain = {"max_abs_err": float((got - want).abs().max()),
                    "max_rel_err": max_rel(got, want), "bitwise": bool(torch.equal(got, want)),
                    "tolerance": "allclose rtol 1e-12, float64 accumulators"}
    touched = int((want != 0).any(dim=1).sum())
    del got, want
    acc = torch.zeros((n_slots, 3), dtype=torch.float64, device=dev)
    seg_ms = med_ms(lambda: segk.segment_rows_matmul(seg, vals, n_slots=n_slots, out=acc),
                    iters=10, warmup=2)
    seg_plain_ms = med_ms(lambda: segk.segment_rows_plain(seg, vals, n_slots=n_slots, out=acc),
                          iters=10, warmup=2)
    keep = (seg >= 0).nonzero()[:, 0]
    seg_lib_ms = med_ms(lambda: acc.index_add_(0, seg[keep].long(), vals[:, keep].T.double()),
                        iters=10, warmup=2)
    n_rows, dying = seg.shape[0], int(keep.shape[0])
    # the bound of an add into an existing accumulator: seg read, the
    # dying rows' values read, and the slots they touch read and written
    segsum = {"rows": n_rows, "dying_rows": dying, "slots": n_slots, "touched_slots": touched,
              "ms": seg_ms, "plain_ms": seg_plain_ms, "library_ms": seg_lib_ms,
              "vs_plain": seg_vs_plain,
              **bound(n_rows * 4 + dying * 3 * 4 + touched * 3 * 8 * 2, 3 * dying)}
    pt_cell["segsum"] = segsum
    pt_cell["segsum_share_of_frame"] = seg_ms * pt_cell["iterations"] / pt_cell["frame_ms"]
    phase(f"wavefront_pt_1024x1024_spp{WF_CELL_SPP4}", gpu=gpu, scene="cornell8", **pt_cell,
          render_pt_ms=pt_ms, tolerance="two runs bitwise; pool 2**18 vs 2**19 rtol 1e-6; "
          "mean within 4 SE of render_pt.cu's frame")
    del img, img18, pt_frame, seg, vals, acc, sc, grabbed
    torch.cuda.empty_cache()

    m_planes, m_cb, m_sb, m_t24, m_mats, m_grid = mpt.mesh_pt_tables(ms4, device=dev)
    m_kw = dict(materials=m_mats, **full, **mpt.pt_tables_kwargs(m_grid, dev))
    mesh_frame = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, **m_kw)
    mesh_ms = med_ms(lambda: mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, **m_kw))
    mdev = mm.mesh_scene_to_device(ms4, device=dev, pallas_bvh_kernel=True, tris_per_chunk=16)
    mesh_cells, imgs = {}, {}
    for every in (1, 2):
        run = f"wavefront_mesh_every{every}"

        def frame(spp4=WF_CELL_SPP4):
            return wf.render_wavefront_mesh(0, mdev, pool=WF_POOL, sort_every=every,
                                            **dict(full, spp4=spp4))

        imgs[every], mesh_cells[f"sort_every_{every}"] = cell(run, frame, mesh_frame, mesh_ms)
        it = mesh_cells[f"sort_every_{every}"]["iterations"]
        require(launches[run] == {"wbvh": it, "segsum": it}, f"{run}: {launches[run]}")
        if every == 1:
            mesh_cells["sort_every_1"]["profile"] = idle_share(lambda: frame(WF_PROFILE_SPP4))
    require(bool(torch.allclose(imgs[2], imgs[1], rtol=1e-6, atol=0.0)),
            f"wavefront mesh: sort_every 2 vs 1 {max_rel(imgs[2], imgs[1])}")
    phase(f"wavefront_mesh_1024x1024_spp{WF_CELL_SPP4}", gpu=gpu, scene=f"icosphere s{MESH_SUBDIV} in "
          "smallpt9, chunks", pool=WF_POOL, mesh_pt_ms=mesh_ms, **mesh_cells,
          sort_every_2_vs_1={"max_rel_err": max_rel(imgs[2], imgs[1]),
                             "bitwise": bool(torch.equal(imgs[2], imgs[1]))},
          tolerance="two runs bitwise; sort_every 2 vs 1 rtol 1e-6; mean within 4 SE of "
          "mesh_pt.cu's frame")
    del imgs, mesh_frame, mdev, m_planes, m_cb, m_sb, m_t24
    torch.cuda.empty_cache()

    # ---- wavefront_entry_points ----------------------------------------
    entry = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, scene_args, want in (("cli_sphere", [], {"segsum"}),
                                        ("cli_mesh", ["--scene", "mesh-icosphere"],
                                         {"wbvh", "segsum"})):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc, lc = counted(lambda: cli.main(
                    ["render", "--renderer", "wavefront", "--mode", "pt", *scene_args,
                     "--backend", "cuda", "--width", "256", "--height", "256", "--samples", "4",
                     "--bounces", str(BOUNCES), "--clamp", "8", "--tonemap", "aces",
                     "--check-finite", "--out", tmp]))
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            require(rc == 0 and set(lc) == want and len(set(lc.values())) == 1
                    and (Path(tmp) / "final.ppm").exists(),
                    f"cli render --renderer wavefront {scene_args}: {line}, launches {lc}")
            entry[label] = {"json": line, "launches": lc}
    for mode, want in (("pt", {"segsum"}), ("mesh", {"wbvh", "segsum"})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--mode", mode, "--renderer", "wavefront", "--rays", "262144",
                             "--spp", "16"])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        per = line["detail"]["launches_per_step"]
        require(rc == 0 and line["value"] > 0 and set(per) == want
                and line["detail"]["iterations_per_step"] > 0,
                f"bench --mode {mode} --renderer wavefront: {line}")
        entry[f"bench_{mode}"] = line
    phase("wavefront_entry_points", gpu=gpu, **entry, seconds_all_wavefront_phases=time.time()
          - t_begin)
    return {"launches": launches, "segsum": segsum}


# ---- host utilities: the native library, profiling, op counts --------
NATIVE_SUBDIVS = (4, 6)  # native BVH builds timed at s4 and s6 (NumPy at s4 only)


def host_s(fn, runs=3):
    """Median host seconds of fn() over ``runs`` runs, and its result."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def native_host_phase(gpu) -> None:
    """Phase ``native_host``: the port's native library (accel/native.py,
    built from native/*.cpp by this machine's g++) is required, and
    ``build_bvh``'s default route must take it.  Host seconds of the BVH
    builders (icosphere s4 and s6 at max_leaf 4 and 64, the NumPy builder
    at s4 only), of ``write_render_ppm`` at 1024 x 1024 (native against
    Python, files byte-equal) and of an OBJ round trip on both loaders
    (equal arrays)."""
    import numpy as np

    from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
    from ascendpathtracing_tpu_torch.accel import meshes, native
    from ascendpathtracing_tpu_torch.utils import io as io_mod

    t0 = time.time()
    fields = ("bmin", "bmax", "first", "count", "miss", "tri_order")
    lib = native.build()  # raises NativeUnavailable: no silent NumPy
    builds = {}
    for sub in NATIVE_SUBDIVS:
        v, f = meshes.icosphere(subdivisions=sub)
        v = np.asarray(v, np.float32)
        for max_leaf in (4, 64):
            key = f"s{sub}_max_leaf{max_leaf}"
            auto = bvh_mod.build_bvh(v, f, max_leaf=max_leaf)
            nat_s, nat = host_s(lambda: native.build_bvh_native(v, f, max_leaf=max_leaf))
            # the NumPy builder's tables differ (tri_order_differs below)
            require(all(np.array_equal(getattr(auto, k), getattr(nat, k)) for k in fields),
                    f"build_bvh(backend='auto') did not take the native builder at {key}")
            row = {"triangles": int(f.shape[0]), "nodes": int(nat.n_nodes), "native_s": nat_s}
            if sub == NATIVE_SUBDIVS[0]:
                np_s, ref = host_s(lambda: bvh_mod.build_bvh_numpy(v, f, max_leaf=max_leaf),
                                   runs=1)
                row.update(numpy_s=np_s, numpy_nodes=int(ref.n_nodes),
                           tri_order_differs=int((ref.tri_order != nat.tri_order).sum()))
            builds[key] = row
    rng = np.random.RandomState(0)
    colors = (rng.rand(FULL_W * FULL_W * 4, 3) * 1.4 - 0.2).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {m: str(Path(tmp) / f"{m}.ppm") for m in ("always", "never")}
        ppm = {}
        for mode, path in paths.items():
            ppm[f"{'native' if mode == 'always' else 'python'}_s"], img = host_s(
                lambda: io_mod.write_render_ppm(colors, FULL_W, FULL_W, 1, path, native=mode),
                runs=1 if mode == "never" else 3)
            ppm[mode] = img
        same = Path(paths["always"]).read_bytes() == Path(paths["never"]).read_bytes()
        require(same and np.array_equal(ppm.pop("always"), ppm.pop("never")),
                "write_render_ppm 1024x1024: the native and Python files differ")
        v, f = meshes.icosphere(subdivisions=NATIVE_SUBDIVS[0])
        obj = Path(tmp) / "s4.obj"
        meshes.save_obj(obj, v, f)
        obj_s = {}
        loaded = {}
        for mode in ("always", "never"):
            obj_s[f"{'native' if mode == 'always' else 'python'}_s"], loaded[mode] = host_s(
                lambda: meshes.load_obj(obj, native=mode))
        require(all(np.array_equal(a, b) for a, b in zip(loaded["always"], loaded["never"]))
                and np.array_equal(loaded["always"][1], f),
                "OBJ round trip: the native and Python loaders differ")
    phase("native_host", gpu=gpu, library=str(lib.relative_to(REPO)),
          build_bvh_auto_took_native=True, bvh_builds=builds,
          write_render_ppm_1024x1024={**ppm, "byte_equal": True},
          obj_round_trip_s4={**obj_s, "equal": True, "vertices": int(v.shape[0])},
          seconds=time.time() - t0)


# ---- the roofline ceiling probes (csrc/ceiling.cu, utils/roofline) ---
CEIL_RETIME_LAUNCHES = 40  # fma chains queued while nvidia-smi reads the clock (~0.5 s)
CEIL_SEED = 0  # the probes' random inputs: CEIL_SEED + the op's index, the copy/read's 7
CEIL_SHAPE = (128, 8, 65536)  # the copy's and the read's input, 256 MB (roofline.py:182)


def sm_clocks() -> dict:
    """The first card's SM clock now and its highest (nvidia-smi), in
    MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].split(",")
    return {"clocks_sm_mhz": float(out[0]), "clocks_max_sm_mhz": float(out[1])}


def chain_sass_report(lib: Path) -> dict:
    """Per chain kernel of ceiling.cu (``cuobjdump -sass``): the SASS of
    one chain step, i.e. the instructions of the rolled trip loop (the
    back edge to the lowest address) over its STREAMS x UNROLL steps, with
    and without the calls of sqrt's and division's slow paths and the
    instructions around them (``sass_skipped_calls``, not issued on the
    fast path), and the opcodes per step.  {"cuobjdump": "not found"}
    without the tool."""
    from ascendpathtracing_tpu_torch.ops import build
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"cuobjdump": "not found"}
    funcs = sass_functions(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                                          text=True, check=True, timeout=300).stdout)
    steps = ck.STREAMS * ck.UNROLL
    out = {}
    for code, op in enumerate(ck.OPS):
        fn = next((f for f in funcs if f"chain_kernelILi{code}E" in f), None)
        if fn is None:
            out[op] = {"function": None}
            continue
        insns, labels = funcs[fn]
        back = [(to, pc) for pc, t in insns if (to := sass_target(t, labels)) is not None
                and to <= pc]
        if not back:
            out[op] = {"function": fn, "loop": None}
            continue
        lo, hi = min(back, key=lambda lp: (lp[0], -lp[1]))
        stubs = sass_skipped_calls(insns, labels)
        loop = [(i, sass_opcode(t)) for i, (pc, t) in enumerate(insns) if lo <= pc <= hi]
        fast = [o for i, o in loop if i not in stubs]
        by_op = {}
        for o in fast:
            by_op[o] = by_op.get(o, 0) + 1
        out[op] = {"function": fn, "loop_instructions": len(loop),
                   "per_step": len(loop) / steps, "fast_path_per_step": len(fast) / steps,
                   "opcodes_per_step": {o: n / steps for o, n in sorted(by_op.items())
                                        if n >= steps / 4}}
    return out


def chain_random_input(op: str, n: int, dev, seed: int):
    """The chain's input [34, n] (``chain_inputs``: row 32 c, row 33 d)
    with its 32 streams drawn uniform in [1, 2) from ``seed`` on the card,
    where sqrt's, div's and fma's fixed points are in reach."""
    import torch

    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = ck.chain_inputs(op, (n,), dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x[:ck.STREAMS] = 1.0 + torch.rand((ck.STREAMS, n), generator=g, device=dev)
    return x


def ceiling_big_input(dev):
    """The copy's and the read's input: CEIL_SHAPE float32, standard
    normal from seed CEIL_SEED + 7 on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(CEIL_SEED + 7)
    return torch.randn(CEIL_SHAPE, generator=g, device=dev)


def events_ms(fn, iters=10) -> float:
    """The median of ``iters`` launches of ``fn``, each between two CUDA
    events, after two untimed ones."""
    from ascendpathtracing_tpu_torch import bench

    return statistics.median(bench.time_steps(fn, iters=iters, warmup=2)[0])


def ceiling_point(fma_ms: float, copy_ms: float, x) -> dict:
    """One reading of the clock-sensitive probes: the fma chain of ``x``
    ([34, n], LOOP trips) and the copy of CEIL_SHAPE, with their rates and
    the SM clock read while CEIL_RETIME_LAUNCHES fma chains of ``x`` run."""
    import torch

    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    for _ in range(CEIL_RETIME_LAUNCHES):
        ck.chain("fma", x)
    clocks = sm_clocks()  # read while the queued chains run
    torch.cuda.synchronize()
    n = x.shape[1]
    return {"fma_chain_ms": fma_ms, "copy_ms": copy_ms,
            "copy_gb_per_s": 2 * math.prod(CEIL_SHAPE) * 4 / (copy_ms * 1e-3) / 1e9,
            "fma_chain_gflops": 2 * ck.STREAMS * ck.LOOP * ck.UNROLL * n / (fma_ms * 1e-3)
            / 1e9, **clocks}


def ceiling_retime(dev, n_fma: int) -> dict:
    """The fma chain (phase ``ceilings``' input: ``n_fma`` elements,
    LOOP trips) and the 256 MB copy timed again as that phase times them
    (``events_ms``, medians of 5 and 10 launches): ``ceiling_point``."""
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck

    x = chain_random_input("fma", n_fma, dev, CEIL_SEED + ck.OPS.index("fma"))
    big = ceiling_big_input(dev)
    fma_ms = events_ms(lambda: ck.chain("fma", x), iters=5)
    copy_ms = events_ms(lambda: ck.copy_scale(big))
    return ceiling_point(fma_ms, copy_ms, x)


def read_bound_check(out, x, adds: int, what: str) -> None:
    """Requires the read ``out`` [8, 128] of ``x`` within float32
    summation error of the float64 sum: ``adds`` x 2^-24 x the sum of |x|
    (``adds`` the additions on an output's path)."""
    folded = x.double().view(x.shape[0], 8, x.shape[2] // 128, 128)
    want, mag = folded.sum((0, 2)), folded.abs().sum((0, 2))
    excess = float(((out.double() - want).abs() - adds * 2.0 ** -24 * mag).max())
    require(excess <= 0.0, f"{what}: past the float32 summation bound of the f64 sum by {excess}")


def ceilings_phase(dev, gpu) -> tuple:
    """Phase ``ceilings`` (1d).  Each probe kernel of csrc/ceiling.cu
    against its twin, on the JAX probes' inputs (the chains at [34, 8,
    128] x 4,096 trips and the copy bit for bit, the read of the 256 MB
    array of ones exactly 65,536 everywhere) and on seeded random inputs
    at the shapes the kernels line times: every chain bit for bit at the
    elements that fill the card (streams uniform in [1, 2), 4,096 trips),
    the copy of a random CEIL_SHAPE bit for bit, and the read of it and
    the read's twin each within float32 summation error of the float64
    sum (``read_bound_check``, the card tests' bound; ``max_abs_err`` is
    the kernel's distance from the twin).
    Then ``utils/roofline.measure_ceilings`` on the card, its launches
    counted from zero, every row with its ``fit_ok``; the SASS of one
    chain step per op (``chain_sass_report``); the SM clock; the kernels',
    the twins' and the library calls' ms at those shapes by CUDA events
    (the fma chain's twin once, the run compared; the copy's
    ``torch.mul(x, c, out=y)``, the read's ``x.view(128, 8, 512,
    128).sum((0, 2))``), and the early ``ceiling_point`` of those
    launches, to hold against ``ceiling_retime`` at the run's end.  ->
    (the kernels line's rows chain, copy and read; the measured ceilings'
    model; the fma chain's elements; the early point)."""
    import torch

    from ascendpathtracing_tpu_torch import bench
    from ascendpathtracing_tpu_torch.ops import build
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck
    from ascendpathtracing_tpu_torch.utils import roofline

    t0 = time.time()
    chains = {}
    for op in ck.OPS:
        x = ck.chain_inputs(op, device=dev)
        k = ck.chain(op, x)
        require(torch.equal(k, ck.chain_plain(op, x)),
                f"chain {op}: the kernel differs from its twin on the JAX inputs")
        chains[op] = float(k[0, 0])
    ones = torch.ones(CEIL_SHAPE, device=dev)
    require(torch.equal(ck.copy_scale(ones), ck.copy_scale_plain(ones)),
            "copy: the kernel differs from its twin on ones")
    rows_folded = CEIL_SHAPE[0] * CEIL_SHAPE[2] // 128  # 65,536 rows of 128 lanes
    require(bool((ck.read_sum(ones) == rows_folded).all()), "read: not 65,536 everywhere")
    del ones
    jax_inputs_s = time.time() - t0

    torch.cuda.synchronize()
    ck.reset_launches()
    t1 = time.time()
    ceil = roofline.measure_ceilings(dev)
    torch.cuda.synchronize()
    measure_s = time.time() - t1
    launches = dict(ck.LAUNCHES)
    require(all(launches.values()), f"measure_ceilings launches {launches}")
    fits = {k: v["fit_ok"] for k, v in ceil.items() if isinstance(v, dict) and "fit_ok" in v}
    clocks = sm_clocks()
    sass = chain_sass_report(build.library_path("ceiling"))
    # the chains' instructions a second (SASS per step on the fast path x
    # steps a second), beside the card's lane-issue peak at its highest
    # clock: 4 schedulers x 32 lanes an SM a cycle
    peak = ceil["device"]["sms"] * 128 * clocks["clocks_max_sm_mhz"] * 1e6
    issue = {op: {"ginsns_per_s": sass[op]["fast_path_per_step"] * row["chain_elem_iters"]
                  / (row["step_ms"] * 1e-3) / 1e9}
             for op in ck.OPS if (row := ceil[f"vpu_{op}"])
             and sass.get(op, {}).get("fast_path_per_step")}
    for v in issue.values():
        v["share_of_issue_peak"] = v["ginsns_per_s"] * 1e9 / peak

    # Every chain against its twin on random streams at the elements that
    # fill the card; the fma chain (what the port's a * b + c issue) is
    # the kernels line's row, timed here on the same input, and its twin's
    # one run is both timed and compared.  Every ms by CUDA events, a
    # launch between two events, as the other rows' (measure_ceilings'
    # fits time launches back to back).
    t2 = time.time()
    chain_err = {}
    for i, op in enumerate(ck.OPS):
        x = chain_random_input(op, ceil[f"vpu_{op}"]["elements"], dev, CEIL_SEED + i)
        k = ck.chain(op, x)
        if op == "fma":
            xf = x
            chain_ms = events_ms(lambda: ck.chain("fma", xf), iters=5)
            times, p = bench.time_steps(lambda: ck.chain_plain("fma", xf), iters=1, warmup=0)
            plain_chain_ms = times[0]
        else:
            p = ck.chain_plain(op, x)
        chain_err[op] = float((k - p).abs().max())
        require(torch.equal(k, p), f"chain {op}: the kernel differs from its twin at "
                f"{tuple(x.shape)} on random streams (max |diff| {chain_err[op]})")
        del x, k, p
    n = xf.shape[1]

    big = ceiling_big_input(dev)
    y, y_plain = ck.copy_scale(big), ck.copy_scale_plain(big)
    copy_err = float((y - y_plain).abs().max())
    require(torch.equal(y, y_plain), f"copy: the kernel differs from its twin on random "
            f"{CEIL_SHAPE} (max |diff| {copy_err})")
    del y_plain
    r, r_plain = ck.read_sum(big), ck.read_sum_plain(big)
    adds = {"kernel": rows_folded // ck.read_ctas(big) + 8 + ck.read_ctas(big),
            "twin": rows_folded + 1}
    read_bound_check(r, big, adds["kernel"], "read")
    read_bound_check(r_plain, big, adds["twin"], "read's twin")
    read_err = float((r - r_plain).abs().max())
    del r, r_plain
    random_s = time.time() - t2

    scale = torch.full((), float(ck.COPY_SCALE), dtype=torch.float32, device=dev)
    copy_ms, read_ms = events_ms(lambda: ck.copy_scale(big)), events_ms(lambda: ck.read_sum(big))
    copy_plain_ms = events_ms(lambda: ck.copy_scale_plain(big))
    copy_lib_ms = events_ms(lambda: torch.mul(big, scale, out=y))
    read_plain_ms = events_ms(lambda: ck.read_sum_plain(big))
    read_lib_ms = events_ms(lambda: big.view(*CEIL_SHAPE[:2], -1, 128).sum((0, 2)))
    nbytes, elems = big.numel() * 4, big.numel()
    del big, y
    torch.cuda.empty_cache()
    early = ceiling_point(chain_ms, copy_ms, xf)
    del xf
    steps = ck.STREAMS * ck.LOOP * ck.UNROLL
    rows = [
        {"name": "chain", "route": "cuda", "source": SOURCE["chain"], "replaces": REPLACES["chain"],
         "run": "measure_ceilings", "launches": launches["chain"],
         "max_abs_err": max(chain_err.values()), "max_abs_err_by_op": chain_err,
         "op": "fma", "elements": n, "ms": chain_ms, "fit_ms": ceil["vpu_fma"]["step_ms"],
         "fit_ms_by_op": {op: ceil[f"vpu_{op}"]["step_ms"] for op in ck.OPS},
         "plain_ms": plain_chain_ms,
         **bound(35 * 4 * n, 2 * steps * n + (ck.STREAMS - 1) * n),
         "library_ms": None, "library": "none: no single PyTorch call runs an op chain"},
        {"name": "copy", "route": "cuda", "source": SOURCE["copy"], "replaces": REPLACES["copy"],
         "run": "measure_ceilings", "launches": launches["copy"], "max_abs_err": copy_err,
         "ms": copy_ms, "fit_ms": ceil["hbm_copy"]["step_ms"], "plain_ms": copy_plain_ms,
         **bound(2 * nbytes, elems), "library_ms": copy_lib_ms,
         "library": "torch.mul(x, c, out=y)"},
        {"name": "read", "route": "cuda", "source": SOURCE["read"], "replaces": REPLACES["read"],
         "run": "measure_ceilings", "launches": launches["read"], "max_abs_err": read_err,
         "ms": read_ms, "fit_ms": ceil["hbm_read"]["step_ms"], "plain_ms": read_plain_ms,
         **bound(nbytes + 4 * 8 * 128, elems), "library_ms": read_lib_ms,
         "library": "x.view(128, 8, 512, 128).sum((0, 2))"},
    ]
    phase("ceilings", gpu=gpu, chains_on_jax_inputs=chains, read_of_ones=65536.0,
          random_inputs={"chains": "streams uniform in [1, 2) at the elements that fill the "
                                   "card, 4,096 trips", "copy_read": f"randn {CEIL_SHAPE}",
                         "seed": CEIL_SEED},
          tolerance={"chains": "bitwise", "copy": "bitwise",
                     "read": "kernel and twin each within adds x 2^-24 x sum |x| of the "
                             "float64 sum", "read_adds": adds},
          max_abs_err={"chain": chain_err, "copy": copy_err, "read": read_err},
          ceilings=ceil, fit_ok=fits, launches=launches,
          chain_sass=sass, chain_issue=issue, issue_peak_ginsns_per_s=peak / 1e9,
          clocks_after=clocks, early=early,
          event_ms={"chain_fma": chain_ms, "copy": copy_ms, "read": read_ms},
          plain_ms={"chain_fma": plain_chain_ms, "copy": copy_plain_ms, "read": read_plain_ms},
          library_ms={"copy": copy_lib_ms, "read": read_lib_ms},
          seconds={"jax_inputs": jax_inputs_s, "measure_ceilings": measure_s,
                   "random_inputs": random_s, "phase": time.time() - t0})
    return rows, ceil["model"], n, early


def bound_measured(row, model) -> dict:
    """A kernels-line row's bytes and operations (``bound``'s) at the
    measured ceilings: the copy's bandwidth and ``r_issue``."""
    b_ms = row["bound_bytes"] / (model["bw_gb_per_s"] * 1e9) * 1e3
    o_ms = row["bound_ops"] / (model["r_issue_gslots"] * 1e9) * 1e3
    return {"bound_measured_ms": max(b_ms, o_ms),
            "bound_measured_by": "bytes" if b_ms >= o_ms else "operations"}


# One main-path step traced by utils/profiling.trace in a process of its
# own; argv[1] is the trace's directory.
TRACE_SCRIPT = r"""
import sys
import numpy as np, torch
from ascendpathtracing_tpu_torch import bench, camera, convert, scenes
from ascendpathtracing_tpu_torch.utils import profiling
rays = camera.generate_rays_numpy(1024, 1024, 1, seed=0).astype(np.float32)
rp = convert.rays_planes_from_numpy(rays, device=torch.device("cuda"))
step = bench.make_step("kernel", False, rp, scenes.cornell8(), bounces=8)
step()
torch.cuda.synchronize()
with profiling.trace(sys.argv[1]):
    step()
"""


def profiling_phase(dev, gpu) -> None:
    """Phase ``profiling``: ``utils/profiling.benchmark_fit`` of the main
    path's step (RenderReference fwd + replay bwd, 4,194,304 cornell8
    rays x 8 bounces) beside the CUDA-event median of the same step in
    this run (fit_ok required), and ``trace(dir)`` around one step in a
    process of its own (TRACE_SCRIPT): the Chrome trace must name the
    render_ref.cu kernels of the step.  The device kernels of the same
    trace taken in this process, after the run's other profiler
    sessions, are reported beside it."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import bench, camera, convert, scenes
    from ascendpathtracing_tpu_torch.utils import profiling

    t0 = time.time()
    scene = scenes.cornell8()
    rp = convert.rays_planes_from_numpy(
        camera.generate_rays_numpy(FULL_W, FULL_W, 1, seed=0).astype(np.float32), device=dev)
    step = bench.make_step("kernel", False, rp, scene, bounces=BOUNCES)
    events, _ = bench.time_steps(step, iters=20, warmup=2)
    # batches of 32 and 96 steps (~27 and ~80 ms), each pair doubling on
    # disagreement, up to six rounds: a few ms of host jitter a batch
    # stays inside the 5% agreement
    fit = profiling.benchmark_fit(lambda i: step(), iters=32, max_rounds=6)
    event_ms = statistics.median(events)
    require(fit["fit_ok"], f"benchmark_fit of the main path's step: {fit}")

    def traced_kernels(trace_dir):
        """{kernel: ms} of the Chrome trace in ``trace_dir``, and its bytes."""
        trace_file = Path(trace_dir) / "trace.json"
        kernels = {}
        for e in json.loads(trace_file.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                # "void (anonymous namespace)::render_ref_fwd_kernel<float, true, 8>(...)"
                name = (e["name"].replace("(anonymous namespace)::", "").removeprefix("void ")
                        .split("(")[0])
                kernels[name] = kernels.get(name, 0.0) + e.get("dur", 0.0) / 1e3
        return kernels, trace_file.stat().st_size

    with tempfile.TemporaryDirectory() as tmp:
        # in this process, after the run's other profiler sessions (reported)
        with profiling.trace(str(Path(tmp) / "here")):
            step()
        here, _ = traced_kernels(Path(tmp) / "here")
        # in a process of its own, as a user traces a step
        run_in_tree(REPO, TRACE_SCRIPT, [str(Path(tmp) / "own")], 600)
        kernels, trace_bytes = traced_kernels(Path(tmp) / "own")
    ref = {k: v for k, v in kernels.items() if k.startswith(("render_ref_", "reduce_partials"))}
    require(any("render_ref_fwd_kernel" in k for k in ref)
            and any("render_ref_bwd_replay_kernel" in k for k in ref),
            f"trace: no render_ref.cu kernels among {sorted(kernels)}")
    phase("profiling", gpu=gpu, rays=rp.shape[1], bounces=BOUNCES,
          benchmark_fit={**{k: v for k, v in fit.items() if k != "fenced_batches"},
                         "step_ms": fit["step_s"] * 1e3,
                         "fenced_batches": [[k, s] for k, s in fit["fenced_batches"]]},
          event_ms_median=event_ms, event_ms=events,
          fit_over_events=fit["step_s"] * 1e3 / event_ms,
          trace={"bytes": trace_bytes, "render_ref_kernels_ms": ref,
                 "device_kernels": len(kernels),
                 "device_kernels_traced_in_this_process": len(here)},
          seconds=time.time() - t0)


def roofline_phase(dev, gpu, rows, model) -> dict:
    """Phase ``roofline_counts``: ``utils/roofline.count_ops`` of the plain
    twins of three kernels at the kernels' inputs on the card:
    ``_render_ref_fwd_idx_kernel`` and ``_render_ref_bwd_replay_kernel``
    (4,194,304 cornell8 camera rays x 8 bounces; the replay on the
    forward's winners with a cotangent of ones) and ``render_pt.cu``
    (cornell8 at 1024 x 1024 x 4 samples, ``pt_path_stats``' size).
    ``other`` must be empty.  Each count's bound (its element ops over
    FP32_OPS) beside the hand model's bound of the kernels line and the
    kernel's ms at the same inputs, timed here; and ``utils/roofline.bound``
    of the count and the row's bytes at the measured ceilings ``model``
    (phase ``ceilings``: r_issue, the sqrt and division weights, the copy's
    bandwidth) -> {kernel: numbers}."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import bench, camera, convert, scenes
    from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk
    from ascendpathtracing_tpu_torch.utils import roofline

    t0 = time.time()
    scene = scenes.cornell8()
    kw = dict(light_index=scene.light_index, bounces=BOUNCES)
    rp = convert.rays_planes_from_numpy(
        camera.generate_rays_numpy(FULL_W, FULL_W, 1, seed=0).astype(np.float32), device=dev)
    sp = convert.scene_planes_from_numpy(scene.soa10(), device=dev)
    _, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    g = torch.ones((3, rp.shape[1]), device=dev)
    planes = convert.scene_planes_from_numpy(scene.soa10(np.float64), device=dev,
                                             dtype=torch.float32)
    mats = torch.tensor(scene.material, dtype=torch.int32, device=dev)
    pt_kw = dict(width=FULL_W, height=FULL_W, spp4=4, bounces=BOUNCES, rr_depth=PT_RR)
    cases = {
        "fwd_idx": (lambda: rk.render_reference_planes_with_idx_plain(rp, sp, **kw),
                    lambda: rk.render_reference_planes_with_idx(rp, sp, **kw),
                    f"{FULL_W}x{FULL_W}x4 rays x {BOUNCES} bounces"),
        "bwd_replay": (lambda: rk.render_ref_bwd_replay_plain(idx, sp, g, **kw),
                       lambda: rk.render_ref_bwd_replay(idx, sp, g, **kw),
                       f"{FULL_W}x{FULL_W}x4 rays x {BOUNCES} bounces"),
        "pt": (lambda: ptk.render_pt_plain(planes, mats, **pt_kw),
               lambda: ptk.render_pt(planes, mats, **pt_kw),
               f"{FULL_W}x{FULL_W}x4 samples, {BOUNCES} bounces, RR from {PT_RR}"),
    }
    hand = {r["name"]: r for r in rows}
    out = {}
    for name, (twin, kernel, size) in cases.items():
        torch.cuda.synchronize()
        c0 = time.time()
        counts = roofline.count_ops(twin)
        torch.cuda.synchronize()
        count_s = time.time() - c0
        require(not counts.other, f"count_ops of {name}'s twin: unclassified {counts.other}")
        kernel_ms = statistics.median(bench.time_steps(kernel, iters=10, warmup=2)[0])
        ops_ms = counts.vpu_slots / FP32_OPS * 1e3
        # the bytes at the kernels line's inputs
        measured = roofline.bound(counts, hand[name]["bound_bytes"], model)
        out[name] = {
            "size": size, "counts": counts.as_dict(), "count_seconds": count_s,
            "bound_count_ms": ops_ms, "kernel_ms": kernel_ms,
            "kernel_over_count_bound": kernel_ms / ops_ms,
            "bound_count_measured": measured,
            "kernel_over_count_measured_bound": kernel_ms / measured["bound_ms"],
            "hand_bound_ops_ms": hand[name]["bound_ops_ms"],
            "hand_bound_at": "the kernels line's inputs" + (
                " (64 samples: x16 this size)" if name == "pt" else "")}
        hand[name]["bound_count_ops_ms"] = ops_ms * (PT_SPP4 // 4 if name == "pt" else 1)
        hand[name]["bound_count_measured_ms"] = max(
            measured["vpu"] * (PT_SPP4 // 4 if name == "pt" else 1), measured["hbm"])
        hand[name]["bound_count_from"] = (
            f"utils/roofline.count_ops of the twin at {size}, element ops (flops + hard + "
            "vops) over 67 TFLOP/s" + (f", x {PT_SPP4 // 4} for 64 samples" if name == "pt"
                                       else ""))
    del idx, g, rp
    torch.cuda.empty_cache()
    phase("roofline_counts", gpu=gpu, **out, seconds=time.time() - t0,
          tolerance="other empty")
    return out


# ---- the sharded port (parallel/): ranks spawned on this card ----------
# Each world runs through parallel/distributed.run_local_world: its ranks
# are processes of their own that import this file (spawn) and share the
# one card, over gloo (NCCL refuses two ranks on one GPU; a world of one
# rank takes NCCL).  Ranks on one card show no scaling, and gloo stages
# what it sends through the host.
PAR_PT = dict(bounces=BOUNCES, rr_depth=PT_RR)  # the rings' PT render: 8 bounces, RR from 5
# The sharded train step against one rank's, float32: loss and parameters
# within this relative difference (the loss's and the gradient's sums run
# in another order; the colors are compared bit for bit).
TRAIN_RTOL = 1e-5


def par_ms(fn, iters=10, warmup=2) -> float:
    """Median ms of ``fn()`` between CUDA events, after ``warmup`` calls."""
    from ascendpathtracing_tpu_torch import bench

    return statistics.median(bench.time_steps(fn, iters=iters, warmup=warmup)[0])


def par_rank_info() -> dict:
    import torch.distributed as dist

    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device

    return {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(rank_device())}


def par_train_rank() -> dict:
    """One rank of ``sharded_train_step_4M_8bounce``: the CLI trainer's
    problem (cornell8, 4,194,304 rays, 8 bounces, albedo + 0.08, lr 0.05),
    this rank's shard, one counted step with its colors, then the step,
    the all-reduce of its [1 + 10 S] buffer and the two kernels timed."""
    import torch
    import torch.distributed as dist

    from ascendpathtracing_tpu_torch import cli
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk
    from ascendpathtracing_tpu_torch.parallel import make_mesh, make_train_step, shard_rays
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device
    from ascendpathtracing_tpu_torch.parallel.sharded import params_to_planes, split_scene_params

    dev = rank_device()
    rays, scene, target = cli.train_problem(FULL_W, FULL_W, BOUNCES, dev)
    mesh = make_mesh()
    rays = shard_rays(rays, mesh).T.contiguous().T  # the shard's planes, read in place
    target = shard_rays(target, mesh).T.contiguous().T
    params, aux = split_scene_params(scene)
    params = dict(params, albedo=params["albedo"] + 0.08)
    step = make_train_step(mesh, bounces=BOUNCES, learning_rate=0.05)
    torch.cuda.synchronize()
    rk.reset_launches()
    loss, new, colors = step(params, aux, rays, target, return_colors=True)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    out = {**par_rank_info(), "rays": rays.shape[0], "launches": launches, "loss": float(loss),
           "params": {k: v.cpu() for k, v in new.items()}, "colors": colors.cpu()}
    out["step_ms"] = par_ms(lambda: step(params, aux, rays, target))
    buf = torch.zeros(1 + 10 * scene["r2"].shape[0], device=dev)
    out["allreduce_ms"] = par_ms(lambda: dist.all_reduce(buf))
    planes, kw = params_to_planes(params), dict(light_index=aux["light_index"], bounces=BOUNCES)
    rp = rays.T
    out["fwd_idx_ms"] = par_ms(lambda: rk.render_reference_planes_with_idx(rp, planes, **kw))
    _, idx = rk.render_reference_planes_with_idx(rp, planes, **kw)
    g = torch.ones((3, rp.shape[1]), device=dev)
    out["bwd_replay_ms"] = par_ms(lambda: rk.render_ref_bwd_replay(idx, planes, g, **kw))
    return out


def par_counted(mod, fn):
    import torch

    torch.cuda.synchronize()
    mod.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in mod.LAUNCHES.items() if v}


def par_render_rank(with_train: bool) -> dict:
    """The sharded renders of one world.  Two ranks: ``par_train_rank``
    (with_train), the reference render on a (2, 1) mesh through
    ``render_ref.cu``'s forward, the s4 mesh render in "indexed" mode
    through ``wbvh.cu`` and the three rings in float64.  Four ranks: the
    (2, 2) mesh's tensor-parallel render in float64 at 256 x 256 and in
    float32 at full size.  Gathered colors come back from rank 0."""
    import torch
    import torch.distributed as dist

    from ascendpathtracing_tpu_torch import bench, camera, scenes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.models import mesh as mm
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk
    from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
    from ascendpathtracing_tpu_torch.parallel import (
        gather_colors, make_mesh, render_pt_mesh_sharded, render_reference_sharded, shard_rays)
    from ascendpathtracing_tpu_torch.parallel import pipeline
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device

    dev, n = rank_device(), dist.get_world_size()
    out = {**par_rank_info(), "train": par_train_rank() if with_train else None}
    mine = dist.get_rank() == 0

    def rays(w, dtype):
        return torch.tensor(camera.generate_rays_numpy(w, w, 1, seed=0), dtype=dtype)

    def cornell(dtype):
        return megakernel.scene_to_device(scenes.cornell8(), device=dev, dtype=dtype)

    def keep(x):  # the gathered colors, on rank 0 only
        full = gather_colors(x)
        return full if mine else None

    mesh = make_mesh()
    out["mesh"] = list(mesh.shape)
    if n == 4:
        r64 = shard_rays(rays(256, torch.float64), mesh).to(dev)
        out["tp_f64"] = keep(render_reference_sharded(r64, cornell(torch.float64), mesh,
                                                      bounces=BOUNCES))
        r32 = shard_rays(rays(FULL_W, torch.float32), mesh).to(dev)
        c32 = cornell(torch.float32)
        out["tp_f32_ms"] = par_ms(lambda: render_reference_sharded(r32, c32, mesh,
                                                                   bounces=BOUNCES), 3, 1)
        out["tp_f32"] = keep(render_reference_sharded(r32, c32, mesh, bounces=BOUNCES))
        return out
    r32 = shard_rays(rays(FULL_W, torch.float32), mesh).to(dev)
    c32 = cornell(torch.float32)
    colors, out["dp_launches"] = par_counted(rk, lambda: render_reference_sharded(
        r32, c32, mesh, bounces=BOUNCES))
    out["dp_ms"] = par_ms(lambda: render_reference_sharded(r32, c32, mesh, bounces=BOUNCES))
    out["dp_f32"] = keep(colors)

    mdev = mm.mesh_scene_to_device(bench.mesh_scene(MESH_SUBDIV), device=dev,
                                   pallas_bvh_kernel=True, tris_per_chunk=16)
    colors, out["mesh_launches"] = par_counted(wk, lambda: render_pt_mesh_sharded(
        0, r32, mdev, mesh, bit_equal="indexed", **PAR_PT))
    out["mesh_ms"] = par_ms(lambda: render_pt_mesh_sharded(0, r32, mdev, mesh,
                                                           bit_equal="indexed", **PAR_PT), 3, 1)
    out["mesh_colors"] = keep(colors)
    del mdev, colors

    ring = make_mesh(axis_names=("stage",))
    r64 = shard_rays(rays(FULL_W, torch.float64), ring).to(dev)
    c64 = cornell(torch.float64)
    padded = megakernel.scene_to_device(scenes.smallpt9(), device=dev, dtype=torch.float64)
    pad = -padded["r2"].shape[0] % n  # spheres no ray hits (r2 = -1), as test_pipeline.py pads
    padded = {k: torch.cat([v, torch.full((pad, *v.shape[1:]), -1.0 if k == "r2" else 0,
                                          dtype=v.dtype, device=dev)])
              if k != "light_index" else v for k, v in padded.items()}
    for name, fn in (("pipelined", lambda: pipeline.render_reference_pipelined(
                          r64, c64, ring, bounces=BOUNCES)),
                     ("ring_scene", lambda: pipeline.render_reference_ring_scene(
                          r64, c64, ring, bounces=BOUNCES)),
                     ("pt_ring", lambda: pipeline.render_pt_ring_scene(11, r64, padded, ring,
                                                                       **PAR_PT))):
        t0 = time.time()
        out[name] = keep(fn())
        out[f"{name}_s"] = time.time() - t0
    return out


def parallel_phases(dev, gpu) -> dict:
    """The sharded port on the card, phases ``sharded_*``, ``ring_*`` and
    ``cli_shard`` -> {kernel: {run: launches a rank}} for the kernels
    line.

    - ``sharded_train_step_4M_8bounce``: the main path at full width,
      worlds of 1 and 2 ranks: each rank's colors bitwise the one-rank
      colors' rows, one fwd_idx and one bwd_replay launch a rank, loss and
      new parameters within TRAIN_RTOL of the one-rank step's; the step,
      the all-reduce and the kernels timed in each rank.
    - ``sharded_render_4M_8bounce``: the (2, 1) mesh through
      ``render_ref.cu`` bitwise the unsharded kernel render; the (2, 2)
      mesh's tensor-parallel render (plain torch) bitwise the unsharded
      plain twin in float64 at 256 x 256 and in float32 at full size,
      and against the kernel within phase 3's 1e-12 (float64) and with
      the share of rays equal to the kernel's stated (float32: the kernel
      and its twin part trails on < 1% of rays, phase
      ``fwd_idx_f32_8bounce_4M``).
    - ``sharded_mesh_render``: the xla-mesh cell's scene (icosphere s4,
      16 triangles a chunk), 4,194,304 rays, 8 bounces, "indexed", 2 ranks
      through ``wbvh.cu``, bitwise the one-device render.
    - ``ring_pipelines_f64``: the three rings at 2 stages, 4,194,304 rays
      in float64, bitwise the single-device renders (tests/test_pipeline.py).
    - ``cli_shard``: ``cli render --shard 2`` byte-equal to ``--shard 0``
      at full width (4,194,304 rays), and ``python -m
      ascendpathtracing_tpu_torch.graft_entry 2`` exits 0."""
    import numpy as np
    import torch

    from ascendpathtracing_tpu_torch import bench, camera, convert, scenes
    from ascendpathtracing_tpu_torch.models import megakernel
    from ascendpathtracing_tpu_torch.models import mesh as mm
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk
    from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk
    from ascendpathtracing_tpu_torch.parallel.distributed import choose_backend, run_local_world

    t_begin = time.time()
    note = ("ranks share one card (no scaling expected); gloo stages its sends "
            "through the host; a one-rank world runs NCCL")
    light = scenes.cornell8().light_index
    sp32 = convert.scene_planes_from_numpy(scenes.cornell8().soa10(), device=dev)

    def rays(w, dtype=torch.float32):
        return torch.tensor(camera.generate_rays_numpy(w, w, 1, seed=0), dtype=dtype, device=dev)

    t0 = time.time()
    one = run_local_world(par_train_rank, 1, device="cuda", timeout=600)[0]
    two = run_local_world(par_render_rank, 2, device="cuda", args=(True,), timeout=900)
    four = run_local_world(par_render_rank, 4, device="cuda", args=(False,), timeout=600)
    worlds_s = time.time() - t0

    # ---- sharded_train_step_4M_8bounce ----------------------------------
    m = one["rays"] // 2
    want = {"fwd": 0, "fwd_idx": 1, "bwd_replay": 1, "bwd_recompute": 0}
    trains = [one] + [r["train"] for r in two]
    diffs = {"loss": 0.0, "params": 0.0}
    for k, res in enumerate(two):
        tr = res["train"]
        require(torch.equal(tr["colors"], one["colors"][k * m:(k + 1) * m]),
                f"sharded train step: rank {k}'s colors differ from the one-rank rows")
        require(tr["launches"] == want, f"sharded train step rank {k}: launches {tr['launches']}")
        diffs["loss"] = max(diffs["loss"], abs(tr["loss"] - one["loss"]) / abs(one["loss"]))
        for p, v in tr["params"].items():
            require(torch.equal(v, two[0]["train"]["params"][p]),
                    f"sharded train step: parameters differ between ranks ({p})")
            diffs["params"] = max(diffs["params"], float(((v - one["params"][p]).abs()
                                  / one["params"][p].abs().clamp_min(1e-6)).max()))
    require(one["launches"] == want and diffs["loss"] <= TRAIN_RTOL
            and diffs["params"] <= TRAIN_RTOL, f"sharded train step vs one rank: {diffs}, "
            f"one-rank launches {one['launches']}")
    per_world = {n: [{k: r[k] for k in ("rank", "backend", "device", "step_ms", "allreduce_ms",
                                        "fwd_idx_ms", "bwd_replay_ms")} for r in rs]
                 for n, rs in ((1, [one]), (2, [r["train"] for r in two]))}
    phase("sharded_train_step_4M_8bounce", gpu=gpu, rays=one["rays"], bounces=BOUNCES,
          backend={1: one["backend"], 2: two[0]["backend"]}, rule=choose_backend("cuda", 2),
          colors="bitwise the one-rank rows", launches_a_rank=want, max_rel_diff=diffs,
          tolerance=f"loss and parameters rtol {TRAIN_RTOL} (float32: the sums run in "
                    "another order)", ranks=per_world, note=note)

    # ---- sharded_render_4M_8bounce ----------------------------------------
    r32 = rays(FULL_W)
    kernel = rk.render_reference(r32, sp32, light_index=light, bounces=BOUNCES).cpu().numpy()
    require(np.array_equal(two[0]["dp_f32"], kernel),
            "sharded render (2, 1): not bitwise the unsharded kernel render")
    require(all(r["dp_launches"] == {"fwd": 1} for r in two),
            f"sharded render (2, 1) launches {[r['dp_launches'] for r in two]}")
    twin = rk.render_reference_planes_plain(r32.T.contiguous(), sp32, light_index=light,
                                            bounces=BOUNCES).T.cpu().numpy()
    require(np.array_equal(four[0]["tp_f32"], twin),
            "sharded render (2, 2) f32: not bitwise the plain twin")
    share = float((four[0]["tp_f32"] == kernel).all(axis=1).mean())
    require(share >= 0.99, f"sharded render (2, 2) f32: {share:.4%} of rays equal the kernel's")
    r256 = rays(256, torch.float64)
    sp64 = convert.scene_planes_from_numpy(scenes.cornell8().soa10(np.float64), device=dev,
                                           dtype=torch.float64)
    k64 = rk.render_reference(r256, sp64, light_index=light, bounces=BOUNCES).cpu().numpy()
    twin64 = rk.render_reference_planes_plain(r256.T.contiguous(), sp64, light_index=light,
                                              bounces=BOUNCES).T.cpu().numpy()
    err64 = float(np.abs(four[0]["tp_f64"] - k64).max())
    require(np.array_equal(four[0]["tp_f64"], twin64) and np.allclose(
        four[0]["tp_f64"], k64, rtol=1e-12, atol=1e-12), "sharded render (2, 2) f64 256x256: "
            f"not bitwise the plain twin, or {err64} from the kernel")
    phase("sharded_render_4M_8bounce", gpu=gpu, rays=kernel.shape[0],
          backend={2: two[0]["backend"], 4: four[0]["backend"]},
          dp_2x1={"mesh": two[0]["mesh"], "bitwise_vs_kernel": True,
                  "launches_a_rank": two[0]["dp_launches"],
                  "ms_a_rank": [r["dp_ms"] for r in two]},
          tp_2x2={"mesh": four[0]["mesh"], "f64_256x256": "bitwise the plain twin",
                  "f64_max_abs_err_vs_kernel": err64, "f32_full": "bitwise the plain twin",
                  "f32_share_equal_kernel": share, "ms_a_rank": [r["tp_f32_ms"] for r in four]},
          tolerance="(2, 1) bitwise the kernel; (2, 2), plain torch, bitwise the plain twin, "
                    "and against the kernel f64 allclose 1e-12 (phase 3's), f32 share of rays "
                    ">= 99% (phase 4's trail flips)", note=note)

    # ---- sharded_mesh_render ----------------------------------------------
    mdev = mm.mesh_scene_to_device(bench.mesh_scene(MESH_SUBDIV), device=dev,
                                   pallas_bvh_kernel=True, tris_per_chunk=16)
    wk.reset_launches()
    ref = mm.render_pt_mesh(r32, mdev, seed=0, **PAR_PT)
    torch.cuda.synchronize()
    one_launches = dict(wk.LAUNCHES)
    require(np.array_equal(two[0]["mesh_colors"], ref.cpu().numpy()),
            "sharded mesh render: not bitwise the one-device render")
    require(all(r["mesh_launches"] == {"wbvh": BOUNCES} for r in two),
            f"sharded mesh render launches {[r['mesh_launches'] for r in two]}")
    phase("sharded_mesh_render", gpu=gpu, scene=f"icosphere s{MESH_SUBDIV} in smallpt9, 16 "
          "triangles a chunk", rays=ref.shape[0], bounces=BOUNCES, bit_equal="indexed",
          backend=two[0]["backend"], bitwise_vs_one_device=True,
          launches_a_rank=two[0]["mesh_launches"], one_device_launches=one_launches,
          ms_a_rank=[r["mesh_ms"] for r in two], mean=float(ref.mean()), note=note)
    del mdev, ref

    # ---- ring_pipelines_f64 -----------------------------------------------
    r64 = rays(FULL_W, torch.float64)
    c64 = megakernel.scene_to_device(scenes.cornell8(), device=dev, dtype=torch.float64)
    expect = megakernel.render_reference_impl(r64, c64, bounces=BOUNCES).cpu().numpy()
    s64 = megakernel.scene_to_device(scenes.smallpt9(), device=dev, dtype=torch.float64)
    expect_pt = megakernel.render_pt_impl(r64, s64, seed=11, **PAR_PT).cpu().numpy()
    for name, ref in (("pipelined", expect), ("ring_scene", expect), ("pt_ring", expect_pt)):
        require(np.array_equal(two[0][name], ref), f"ring {name}: not bitwise the single-device "
                "render")
    phase("ring_pipelines_f64", gpu=gpu, stages=2, rays=expect.shape[0], bounces=BOUNCES,
          backend=two[0]["backend"], tolerance="bitwise (tests/test_pipeline.py)",
          seconds_a_render={k: two[0][f"{k}_s"] for k in ("pipelined", "ring_scene", "pt_ring")},
          pt_mean=float(expect_pt.mean()), note=note)

    # ---- cli_shard ----------------------------------------------------------
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "ascendpathtracing_tpu_torch.cli", "render",
                "--width", str(FULL_W), "--height", str(FULL_W), "--bounces", str(BOUNCES),
                "--mode", "reference", "--backend", "cuda"]
        lines = {}
        for n in (0, 2):
            proc = subprocess.run([*base, "--shard", str(n), "--out", f"{tmp}/s{n}"], cwd=REPO,
                                  capture_output=True, text=True, timeout=600, check=False)
            require(proc.returncode == 0, f"cli render --shard {n}: exit {proc.returncode}\n"
                    f"{proc.stderr[-3000:]}")
            lines[n] = json.loads(proc.stdout.strip().splitlines()[-1])
        for name in ("color.ppm", "color.bin"):
            require((Path(tmp) / "s0" / name).read_bytes() == (Path(tmp) / "s2" / name)
                    .read_bytes(), f"cli render --shard 2: {name} differs from --shard 0")
    dry = subprocess.run([sys.executable, "-m", "ascendpathtracing_tpu_torch.graft_entry", "2"],
                         cwd=REPO, capture_output=True, text=True, timeout=600, check=False)
    require(dry.returncode == 0, f"graft_entry 2: exit {dry.returncode}\n{dry.stderr[-3000:]}")
    phase("cli_shard", gpu=gpu, shard2=lines[2], shard0_render_s=lines[0]["render_s"],
          ppm_and_bin_byte_equal=True, graft_entry=dry.stdout.strip().splitlines()[-1],
          seconds=time.time() - t0)
    phase("parallel_seconds", gpu=gpu, worlds_s=worlds_s,
          seconds_all_parallel_phases=time.time() - t_begin)
    return {"fwd": {"sharded_render (2, 1)": two[0]["dp_launches"]["fwd"]},
            "fwd_idx": {"sharded_train_step": two[0]["train"]["launches"]["fwd_idx"]},
            "bwd_replay": {"sharded_train_step": two[0]["train"]["launches"]["bwd_replay"]},
            "wbvh": {"sharded_mesh_render": two[0]["mesh_launches"]["wbvh"]}}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout (e.g. the parent commit's, from git "
                         "archive): each kernel whose sources differ is timed in both "
                         "trees in turns (phase mesh_times)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
              "required", file=sys.stderr)
        return 1
    if not (REPO / "ascendpathtracing_tpu_torch" / "__init__.py").exists():
        # run alone, away from a checkout: nothing to build or drive
        print(f"chip_smoke: no ascendpathtracing_tpu_torch package beside {Path(__file__).name} "
              f"in {REPO}; run it from the root of a checkout", file=sys.stderr)
        return 1

    import numpy as np

    from ascendpathtracing_tpu_torch import bench, cli, convert
    from ascendpathtracing_tpu_torch.device import gpu_name_and_power_limit
    from ascendpathtracing_tpu_torch import camera, oracle, scenes
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
    from ascendpathtracing_tpu_torch.accel import native, tri
    from ascendpathtracing_tpu_torch.diff import camera as dcam
    from ascendpathtracing_tpu_torch.diff import camera_fused as dcf
    from ascendpathtracing_tpu_torch.diff import mesh as dmesh
    from ascendpathtracing_tpu_torch.diff import mesh_fused as mf
    from ascendpathtracing_tpu_torch.models import mesh as mm
    from ascendpathtracing_tpu_torch.ops import build, chunk_grid
    from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
    from ascendpathtracing_tpu_torch.ops import ceiling_kernels as ck
    from ascendpathtracing_tpu_torch.ops import histogram_kernels as segk
    from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
    from ascendpathtracing_tpu_torch.ops import pt_kernels as ptk
    from ascendpathtracing_tpu_torch.ops import render_kernels as rk
    from ascendpathtracing_tpu_torch.ops import wbvh_kernels as wk

    dev = torch.device("cuda")
    gpu = gpu_name_and_power_limit()
    scene = scenes.cornell8()
    light = scene.light_index
    kw = dict(light_index=light, bounces=BOUNCES)

    def rays_planes(w, dtype=np.float32):
        r = camera.generate_rays_numpy(w, w, 1, seed=0).astype(dtype)
        t = torch.float64 if dtype == np.float64 else torch.float32
        return r, convert.rays_planes_from_numpy(r, device=dev, dtype=t)

    def planes(dtype=np.float32):
        t = torch.float64 if dtype == np.float64 else torch.float32
        return convert.scene_planes_from_numpy(scene.soa10(dtype), device=dev, dtype=t)

    # ---- 1. build (all seven libraries at once) ------------------------
    t0 = time.time()
    libs = build.LIBRARIES
    parent = None if args.parent is None else args.parent.resolve()
    ab_names, ab_untimed = ab_kernels(parent) if parent else ((), ())
    parent_build = None  # the other tree builds its kernels meanwhile
    ab_saved = {}  # the A/B's inputs, saved as the phases make them
    if ab_names:
        parent_build = subprocess.Popen(
            [sys.executable, "-c", "import sys\nfrom ascendpathtracing_tpu_torch.ops import "
             "build\nbuild.build_all(sys.argv[1:])", *ab_names], cwd=parent,
            env={**os.environ, "PYTHONPATH": str(parent)}, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
    # the native host library (g++) builds beside the CUDA libraries
    with ThreadPoolExecutor(max_workers=1) as pool:
        native_build = pool.submit(native.build)
        build.build_all(libs)
        native_lib = native_build.result()  # NativeUnavailable fails the run
    kernel_mods = (rk, ptk, wk, mpt, segk, bk, ck)
    for mod in kernel_mods:
        mod.load_library()
    if parent_build is not None:
        _, err = parent_build.communicate()
        require(parent_build.returncode == 0, f"--parent {parent}: build failed:\n{err[-3000:]}")
    require(mf.LAYER_CHUNK * MESH_CHUNKS == PT_SPP4, "replay chunks per step")
    build_s = time.time() - t0
    regs, spills = {}, {}
    for lib in libs:
        log = build.library_path(lib).with_suffix(".log").read_text()
        regs[lib] = [ln.split("info    : ")[-1] for ln in log.splitlines() if "Used" in ln]
        spills.update(spills_by_kernel(log))
    # float32 (and helper) functions must not spill; float64 spills are
    # reported, not hidden.
    f64_spills = {k: v for k, v in spills.items() if "_kernelId" in k}
    other = {k: v for k, v in spills.items() if k not in f64_spills}
    require(len(spills) >= 2 * len(libs) and all(v == (0, 0) for v in other.values()),
            f"register spills: {other}")
    # The fused mesh kernel's twelve instantiations: registers (the float
    # ones without spills, above) and resident 256-thread blocks per SM
    # with the s4 cell's 8,160 bytes of boxes in shared memory.
    mesh_regs = keyed("mesh_pt", registers_by_kernel(
        build.library_path("mesh_pt").with_suffix(".log").read_text()))
    mesh_blocks = mpt.blocks_per_sm(24 * (320 + 20))
    require(sorted(mesh_regs) == sorted(mesh_blocks) and min(mesh_blocks.values()) >= 1,
            f"fused mesh kernel: registers {mesh_regs}, blocks per SM {mesh_blocks}")
    # The path tracer's and the BVH walk's registers (their MinBlocks and
    # occupancy), and the traversal kernel's.
    pt_regs, wbvh_regs = (keyed(lib, registers_by_kernel(
        build.library_path(lib).with_suffix(".log").read_text())) for lib in ("render_pt", "wbvh"))
    bvh_regs = [n for k, n in registers_by_kernel(build.library_path("bvh").with_suffix(".log")
                                                  .read_text()).items() if "bvh_kernel" in k]
    require(sorted(pt_regs) == ["f32", "f32_debug", "f64", "f64_debug"] and len(bvh_regs) == 1
            and len(wbvh_regs) == 16, f"registers: render_pt {pt_regs}, bvh {bvh_regs}, "
            f"wbvh {wbvh_regs}")
    # The kernels that gained a debug instantiation keep the registers of
    # the others (with --parent, the parent build's), and their SASS is
    # reported beside the parent's.
    same_regs, sass_vs_parent = {}, {}
    for lib, new_regs in (("render_pt", pt_regs), ("wbvh", wbvh_regs), ("mesh_pt", mesh_regs)):
        if lib in ab_names:
            old_lib = next((parent / "build" / "ascendpathtracing_tpu_torch")
                           .glob(f"lib{lib}-*.so"))
            old_regs = keyed(lib, registers_by_kernel(old_lib.with_suffix(".log").read_text()))
            same_regs[lib] = {k: [v, new_regs.get(k)] for k, v in old_regs.items()}
            require(all(v == new_regs.get(k) for k, v in old_regs.items()),
                    f"{lib}: registers differ from the parent's {same_regs[lib]}")
            sass_vs_parent[lib] = same_sass(old_lib, build.library_path(lib), lib)
    # The reference kernels: registers of each instantiation the kernels
    # line times (float32, cornell8's S = 8), no spills in any of
    # render_ref.cu's functions (float64 too), and the bounce loop's SASS:
    # instructions per bounce, the issue floor at the main path's size, no
    # local memory (LDL/STL) in the loop; with --parent the parent's too.
    ref_log = build.library_path("render_ref").with_suffix(".log").read_text()
    ref_regs = {name: n for name, stem, arg in REF_SASS
                for k, n in registers_by_kernel(ref_log).items() if stem in k and arg in k}
    ref_spills = {k: v for k, v in spills_by_kernel(ref_log).items() if v != (0, 0)}
    require(sorted(ref_regs) == sorted(r[0] for r in REF_SASS) and not ref_spills,
            f"render_ref.cu: registers {ref_regs}, spills {ref_spills}")
    clock = sm_clocks()["clocks_max_sm_mhz"]
    ref_sass = {"new": ref_sass_report(build.library_path("render_ref"), FULL_W ** 2 * 4,
                                       BOUNCES, scene.n_spheres, clock)}
    if "render_ref" in ab_names:
        ref_sass["parent"] = ref_sass_report(
            next((parent / "build" / "ascendpathtracing_tpu_torch").glob("librender_ref-*.so")),
            FULL_W ** 2 * 4, BOUNCES, scene.n_spheres, clock)
        ref_sass["same_sass_as_parent"] = {
            name: ref_sass["new"][name].get("sass_sha256") == ref_sass["parent"][name].get(
                "sass_sha256") for name, _, _ in REF_SASS}
    for name, _, _ in REF_SASS:
        loop = ref_sass["new"].get(name, {})
        require("cuobjdump" in ref_sass["new"] or (loop.get("per_bounce") and loop["LDL"] == 0
                                                   and loop["STL"] == 0),
                f"render_ref.cu {name}: bounce loop {loop}")
    phase("build", seconds=build_s, gpu=gpu, torch=torch.__version__,
          cuda=torch.version.cuda, ptxas=regs, render_pt_registers=pt_regs,
          render_ref_registers=ref_regs, render_ref_sass=ref_sass, max_sm_clock_mhz=clock,
          bvh_registers=bvh_regs[0], wbvh_registers=wbvh_regs, mesh_pt_registers=mesh_regs,
          registers_vs_parent=same_regs or "not measured: no --parent",
          same_sass_as_parent=sass_vs_parent or "not measured: no --parent",
          mesh_pt_blocks_per_sm=mesh_blocks,
          mesh_pt_queue_capacity=mpt.queue_overflows()["capacity"],
          native_library=str(native_lib.relative_to(REPO)),
          parent=None if parent is None else str(parent), ab_kernels=ab_names,
          f64_spill_bytes={k: v for k, v in f64_spills.items() if v != (0, 0)})
    print(gpu, flush=True)

    # ---- 1b. the card-only tests, in a pytest process of their own ------
    # without tests/conftest.py (it imports jax, which this machine need
    # not have); every test must pass and none skip.
    t0 = time.time()
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
           "tests/test_torch_cuda.py"]
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "report.xml"  # the counts, whatever -q prints
        proc = subprocess.run([*cmd, f"--junitxml={report}", "--durations=6"], cwd=REPO,
                              capture_output=True, text=True, timeout=600, check=False)
        suite = ElementTree.parse(report).getroot() if report.exists() else None
    if suite is not None and suite.tag == "testsuites":
        suite = suite[0]
    tally = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")} \
        if suite is not None else {}
    passed = tally.get("tests", 0) - sum(tally.get(k, 0) for k in ("failures", "errors",
                                                                    "skipped"))
    require(proc.returncode == 0 and tally.get("tests", 0) > 0 and passed == tally["tests"],
            f"card-only tests: exit {proc.returncode}, {tally}\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    slowest = [ln.strip() for ln in proc.stdout.splitlines()
               if re.match(r"\s*[\d.]+s (call|setup)", ln)]
    phase("card_only_tests", command=" ".join(["python3", *cmd[1:]]), passed=passed,
          failed=tally["failures"] + tally["errors"], skipped=tally["skipped"],
          seconds=time.time() - t0, slowest=slowest)

    # ---- 1c. the native host library: required, and build_bvh's default -
    native_host_phase(gpu)

    # ---- 1d. the roofline ceiling probes (csrc/ceiling.cu): before the
    # heavy phases, and timed again at the run's end (ceilings_late)
    ceil_rows, ceil_model, ceil_n, ceil_early = ceilings_phase(dev, gpu)

    # ---- 2. fwd f32, 1 bounce, 64x64x1: bitwise vs oracle and plain ----
    r64, rp = rays_planes(64)
    sp = planes()
    k = rk.render_reference_planes(rp, sp, light_index=light, bounces=1)
    p = rk.render_reference_planes_plain(rp, sp, light_index=light, bounces=1)
    ora = oracle.render_reference_numpy(r64, scene, bounces=1)
    e_ora = float(np.abs(k.T.cpu().numpy() - ora).max())
    require(e_ora == 0.0, f"fwd f32 1 bounce vs oracle: max err {e_ora}")
    require(torch.equal(k, p), "fwd f32 1 bounce vs plain twin: not bitwise")
    phase("fwd_f32_1bounce_64x64", max_abs_err_vs_oracle=e_ora,
          bitwise_vs_plain=True, tolerance="bitwise")

    # ---- 3. fwd+idx f64, 8 bounces, 256x256x1 --------------------------
    r256, rp = rays_planes(256, np.float64)
    sp64 = planes(np.float64)
    c, idx = rk.render_reference_planes_with_idx(rp, sp64, **kw)
    cp, idxp = rk.render_reference_planes_with_idx_plain(rp, sp64, **kw)
    ora = oracle.render_reference_numpy(r256, scene, bounces=BOUNCES, dtype=np.float64)
    e_ora = float(np.abs(c.T.cpu().numpy() - ora).max())
    require(np.allclose(c.T.cpu().numpy(), ora, rtol=1e-12, atol=1e-12),
            f"fwd_idx f64 vs f64 oracle: max err {e_ora}")
    require(torch.equal(idx, idxp), "fwd_idx f64: idx differs from the plain twin")
    phase("fwd_idx_f64_8bounce_256x256", max_abs_err_vs_oracle=e_ora,
          idx_equal_plain=True, tolerance="allclose 1e-12")

    # ---- 4. fwd+idx f32, 8 bounces, 4,194,304 rays ----------------------
    _, rp = rays_planes(FULL_W)
    n = rp.shape[1]
    c, idx = rk.render_reference_planes_with_idx(rp, sp, **kw)
    c_noidx = rk.render_reference_planes(rp, sp, **kw)
    cp, idxp = rk.render_reference_planes_with_idx_plain(rp, sp, **kw)
    agree = (idx == idxp).all(dim=0)
    flipped = 1.0 - float(agree.float().mean())
    fwd_err = float((c - cp).abs().max())
    require(torch.equal(c[:, agree], cp[:, agree]),
            "rays with equal idx trails are not bitwise equal")
    require(flipped < 0.01, f"{flipped:.4%} of rays have a different idx trail")
    require(torch.equal(c, c_noidx), "fwd and fwd_idx kernels disagree")
    require(bool(torch.isfinite(c).all()), "non-finite colors")
    phase("fwd_idx_f32_8bounce_4M", rays=n, trail_differs_share=flipped,
          max_abs_err_vs_plain=fwd_err, tolerance="bitwise where trails agree")
    max_err = {"fwd": fwd_err, "fwd_idx": fwd_err}

    # ---- 5. replay and recompute backward vs plain twins ---------------
    def rel_close(a, b, rtol):
        return bool(torch.allclose(a, b, rtol=rtol, atol=0.0))

    def max_rel(a, b):
        nz = b != 0
        return float(((a - b)[nz].abs() / b[nz].abs()).max()) if nz.any() else 0.0

    for dtype, tdt, rtol in ((np.float32, torch.float32, 1e-5),
                             (np.float64, torch.float64, 1e-12)):
        _, rpx = rays_planes(FULL_W, dtype)
        spx = planes(dtype)
        _, idx_x = rk.render_reference_planes_with_idx(rpx, spx, **kw)
        g = torch.arange(3 * n, device=dev, dtype=tdt).reshape(3, n)
        d_rep = rk.render_ref_bwd_replay(idx_x, spx, g, **kw)
        d_rep2 = rk.render_ref_bwd_replay(idx_x, spx, g, **kw)
        d_rec = rk.render_ref_bwd(rpx, spx, g, **kw)
        d_rec2 = rk.render_ref_bwd(rpx, spx, g, **kw)
        p_rep = rk.render_ref_bwd_replay_plain(idx_x, spx, g, **kw)
        p_rec = rk.render_ref_bwd_plain(rpx, spx, g, **kw)
        require(rel_close(d_rep, p_rep, rtol), f"replay bwd {tdt} vs plain")
        require(rel_close(d_rec, p_rec, rtol), f"recompute bwd {tdt} vs plain")
        require(float(d_rep[0:4].abs().max()) == 0.0, "replay rows 0-3 not 0")
        require(float(d_rec[0:4].abs().max()) == 0.0, "recompute rows 0-3 not 0")
        require(torch.equal(d_rep, d_rep2) and torch.equal(d_rec, d_rec2),
                "two backward runs differ")
        phase(f"bwd_{str(tdt).split('.')[-1]}_4M_arange_g",
              replay_max_rel_err=max_rel(d_rep, p_rep),
              recompute_max_rel_err=max_rel(d_rec, p_rec), rtol=rtol,
              rows_0_3_zero=True, repeat_bitwise=True)
        del rpx, idx_x, g, p_rep, p_rec
    torch.cuda.empty_cache()

    # Main path's own cotangent (sum -> ones), f32, for the kernel table.
    ones = torch.ones((3, n), device=dev)
    max_err["bwd_replay"] = float(
        (rk.render_ref_bwd_replay(idx, sp, ones, **kw)
         - rk.render_ref_bwd_replay_plain(idx, sp, ones, **kw)).abs().max())
    max_err["bwd_recompute"] = float(
        (rk.render_ref_bwd(rp, sp, ones, **kw)
         - rk.render_ref_bwd_plain(rp, sp, ones, **kw)).abs().max())

    # ---- 6. the main path, counted run by run ---------------------------
    step_plain = bench.make_step("plain", False, rp, scene, bounces=BOUNCES)
    model = rk.RenderReference(sp, **kw)
    model_rec = rk.RenderReference(sp, **kw, replay=False)
    rays_in = rp.clone().requires_grad_(True)

    def counted(run):
        torch.cuda.synchronize()
        for mod in kernel_mods:
            mod.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items()}

    def train_step(m, rays):
        out = m(rays)
        out.sum().backward()
        return out

    launches = {}
    out, launches["train_step"] = counted(lambda: train_step(model, rays_in))
    with torch.no_grad():
        out_fwd, launches["inference_render"] = counted(lambda: model(rp))
    _, launches["train_step_recompute"] = counted(lambda: train_step(model_rec, rp))
    want = {k: RUNS[k] for k in launches}
    require(launches == want, f"launches per run {launches}, expected {want}")
    require(bool(torch.isfinite(out).all()), "non-finite step output")
    require(float(rays_in.grad.abs().max()) == 0.0, "ray gradient not exactly 0")
    require(torch.equal(out.detach(), out_fwd), "inference and training forward differ")
    g_ker = model.scene_planes.grad
    require(torch.equal(g_ker, model_rec.scene_planes.grad),
            "replay and recompute steps differ")
    _, (g_alb, g_emi, _, _) = step_plain()
    # f32 sums over 4M rays taken in different orders (kernel: per-block
    # shuffles then a fixed tree; torch: its own reduction) differ by a
    # few ulp per level; 1e-3 also covers any ray whose trail flips.
    require(rel_close(g_ker[7:10].T, g_alb, 1e-3), "albedo grad vs plain autograd")
    require(rel_close(g_ker[4:7, light], g_emi[light], 1e-3),
            "emission grad vs plain autograd")
    require(float(g_ker[0:4].abs().max()) == 0.0, "geometry grad rows not 0")
    phase("main_path_4M_8bounce", rays=n, launches=launches, ray_grad_zero=True,
          finite=True,
          albedo_max_rel_err=max_rel(g_ker[7:10].T, g_alb),
          emission_max_rel_err=max_rel(g_ker[4:7, light], g_emi[light]),
          tolerance="rtol 1e-3 vs plain autograd (f32 sums in other orders)")
    del out, out_fwd, step_plain, model, model_rec, rays_in
    torch.cuda.empty_cache()

    # ---- 7. times -------------------------------------------------------
    def med_ms(step, iters=10):
        times, _ = bench.time_steps(step, iters=iters, warmup=2)
        return statistics.median(times)

    steps = {}
    for renderer in ("kernel", "plain"):
        for fwd_only in (True, False):
            name = f"{renderer}_{'fwd' if fwd_only else 'fwd+bwd'}"
            ms = med_ms(bench.make_step(renderer, fwd_only, rp, scene, bounces=BOUNCES))
            steps[name] = {"ms": ms, "mrays_per_s": n / (ms * 1e-3) / 1e6}
            torch.cuda.empty_cache()
    phase("step_times_4M_8bounce", gpu=gpu, **steps)

    g1 = torch.ones((3, n), device=dev)
    calls = {
        "fwd": (lambda: rk.render_reference_planes(rp, sp, **kw),
                lambda: rk.render_reference_planes_plain(rp, sp, **kw)),
        "fwd_idx": (lambda: rk.render_reference_planes_with_idx(rp, sp, **kw),
                    lambda: rk.render_reference_planes_with_idx_plain(rp, sp, **kw)),
        "bwd_replay": (lambda: rk.render_ref_bwd_replay(idx, sp, g1, **kw),
                       lambda: rk.render_ref_bwd_replay_plain(idx, sp, g1, **kw)),
        "bwd_recompute": (lambda: rk.render_ref_bwd(rp, sp, g1, **kw),
                          lambda: rk.render_ref_bwd_plain(rp, sp, g1, **kw)),
    }
    # Bounds at this run's inputs: n rays x 8 bounces of cornell8 (8
    # spheres); reference mode runs every bounce of every ray.  The bounds
    # count the function's own bytes, not the backwards' [3 + 3S, n_blocks]
    # scratch, which is this implementation's choice (its bytes, written
    # and read once, print beside the replay's split).
    s8 = scene.n_spheres
    ray_ops = n * BOUNCES * (SPHERE_OPS * s8 + REF_SHADE_OPS)
    bounds = {
        "fwd": bound(n * (24 + 12) + 40 * s8, ray_ops),
        "fwd_idx": bound(n * (24 + 12 + 4 * BOUNCES) + 40 * s8, ray_ops),
        "bwd_replay": bound(n * (4 * BOUNCES + 12) + 80 * s8, n * BOUNCES * 10),
        "bwd_recompute": bound(n * (24 + 12) + 80 * s8, ray_ops + n * BOUNCES * 10),
    }
    rows = []
    for name, (ker, plain) in calls.items():
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "run": RUN_OF[name],
            "launches": launches[RUN_OF[name]][name],
            "max_abs_err": max_err[name], "ms": med_ms(ker),
            "plain_ms": med_ms(plain), **bounds[name], "library_ms": None,
            "registers": ref_regs[name],
            "sass_per_bounce": ref_sass["new"].get(name, {}).get("per_bounce"),
            "issue_floor_ms": ref_sass["new"].get(name, {}).get("issue_floor_ms"),
        })
        torch.cuda.empty_cache()
    # The replay's two launches, its kernel and the pass that sums the
    # blocks' partials, by the profiler's device time per kernel name (as
    # ``bench --profile`` gathers it), ms per call.
    split = bench.profile_steps(calls["bwd_replay"][0], iters=10, top=4)
    replay_split = {key: sum(ms for name, ms in split["top_device_ms_per_step"] if key in name)
                    for key in ("render_ref_bwd_replay_kernel", "reduce_partials_kernel")}
    require(all(v > 0 for v in replay_split.values()),
            f"replay split: no device time for a kernel {split}")
    next(r for r in rows if r["name"] == "bwd_replay")["split_ms"] = replay_split
    phase("kernel_times_4M_8bounce", gpu=gpu,
          **{r["name"]: {"ms": r["ms"], "plain_ms": r["plain_ms"]} for r in rows},
          bwd_replay_split_ms=replay_split,
          bwd_replay_profile=split,
          bwd_scratch_bytes=2 * 4 * (3 + 3 * s8) * -(-n // rk.BLOCK))

    # ---- 8. entry points -----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["render", "--backend", "cuda", "--renderer", "kernel",
                           "--width", "256", "--height", "256", "--bounces", "1",
                           "--oracle", "--out", tmp])
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc == 0 and stats["oracle_rays_bitexact"] == 1.0, f"cli render: {stats}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_self = cli.main(["selftest", "--backend", "cuda"])
    self_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_self == 0 and self_line == {"selftest": "PASS", "passed": 8, "ran": 8,
                                           "backend": "cuda"},
            f"cli selftest failed:\n{buf.getvalue()}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_bench = bench.main([])
    bench_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_bench == 0 and bench_line["value"] > 0
            and bench_line["detail"]["launches_per_step"] == {"fwd_idx": 1.0, "bwd_replay": 1.0},
            f"bench: {bench_line}")
    phase("entry_points", cli_render=stats, selftest=self_line, bench=bench_line)
    del rp, idx, g1, calls
    torch.cuda.empty_cache()

    # ---- 8b. the trainer: cli train at the main path's size ------------
    # 1024 x 1024 pixels, one tent quad each (4,194,304 rays), 8 bounces of
    # cornell8, f32: 40 steps, then --resume for 20, against a straight 60;
    # the final parameters bitwise equal, the loss finite and lower than at
    # step 1, and every step through render_ref.cu's fwd_idx and replay
    # kernels (the target through its forward).  Then the step's time by
    # CUDA events beside the main path's fwd+bwd (phase 7).
    from ascendpathtracing_tpu_torch.parallel import sharded
    from ascendpathtracing_tpu_torch.utils import checkpoint as ckpt

    train_args = ["train", "--backend", "cuda", "--width", str(FULL_W), "--height",
                  str(FULL_W), "--bounces", str(BOUNCES)]
    train_lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        split, straight = f"{tmp}/split.npz", f"{tmp}/straight.npz"
        for name, argv in (("first_40", ["--steps", "40", "--ckpt", split]),
                           ("resume_20", ["--steps", "20", "--ckpt", split, "--resume"]),
                           ("straight_60", ["--steps", "60", "--ckpt", straight])):
            buf, err = io.StringIO(), io.StringIO()
            for mod in kernel_mods:
                mod.reset_launches()
            t0 = time.time()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                rc = cli.main([*train_args, *argv])
            torch.cuda.synchronize()
            require(rc == 0, f"cli train {name}: exit {rc}\n{err.getvalue()[-2000:]}")
            train_lines[name] = {
                "json": json.loads(buf.getvalue().strip().splitlines()[-1]),
                "seconds": time.time() - t0,
                "launches": {k: v for k, v in rk.LAUNCHES.items() if v},
                "stderr": err.getvalue().strip().splitlines()}
        (pa, sa, _), (pb, sb, _) = ckpt.load_checkpoint(split), ckpt.load_checkpoint(straight)
    require(sa == sb == 60 and all(np.array_equal(pa[k], pb[k]) for k in sharded.PARAM_KEYS),
            "cli train: 40 + resume 20 differs from a straight 60")
    require(any("resumed from" in ln and "at step 40" in ln
                for ln in train_lines["resume_20"]["stderr"]), "cli train: no resume line")
    for name, n_steps in (("first_40", 40), ("resume_20", 20), ("straight_60", 60)):
        want = {"fwd": 1, "fwd_idx": n_steps, "bwd_replay": n_steps}
        require(train_lines[name]["launches"] == want,
                f"cli train {name}: launches {train_lines[name]['launches']}, expected {want}")
    from ascendpathtracing_tpu_torch.models import megakernel

    t_rays, t_scene, t_target = cli.train_problem(FULL_W, FULL_W, BOUNCES, dev)
    t_params, t_aux = sharded.split_scene_params(t_scene)
    t_params = dict(t_params, albedo=t_params["albedo"] + 0.08)
    train_step = sharded.make_train_step(None, bounces=BOUNCES, learning_rate=0.05)
    loss1, _ = train_step(t_params, t_aux, t_rays, t_target)
    loss60 = train_lines["straight_60"]["json"]["final_loss"]
    require(np.isfinite(loss60) and loss60 < float(loss1),
            f"cli train: loss {loss60} after 60 steps, {float(loss1)} at step 1")
    require(train_lines["resume_20"]["json"]["final_loss"] == loss60,
            "cli train: the resumed run's final loss differs from the straight run's")

    def train_loop(k):
        p = t_params
        for _ in range(k):
            _, p = train_step(p, t_aux, t_rays, t_target)
        return p

    train_loop(3)  # warm
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    train_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ev0.record()
        train_loop(20)
        ev1.record()
        torch.cuda.synchronize()
        train_ms.append({"events_ms_per_step": ev0.elapsed_time(ev1) / 20,
                         "host_ms_per_step": (time.time() - t0) * 1e3 / 20})
    train_step_ms = statistics.median(r["events_ms_per_step"] for r in train_ms)
    # where the step's time goes: device time by kernel, busy and idle
    train_profile = bench.profile_steps(
        lambda: train_step(t_params, t_aux, t_rays, t_target), iters=10, top=10)
    phase("train_cli_4M_8bounce", gpu=gpu, rays=FULL_W * FULL_W * 4,
          runs={k: {kk: v[kk] for kk in ("json", "seconds", "launches")}
                for k, v in train_lines.items()},
          resume_bitwise_vs_straight=True, loss_step1=float(loss1), loss_step60=loss60,
          step_ms=train_step_ms, step_times=train_ms, step_profile=train_profile,
          main_path_fwd_bwd_ms=steps["kernel_fwd+bwd"]["ms"])
    del t_rays, t_target, t_params, train_step
    torch.cuda.empty_cache()

    # ---- 8c. post-processing and the oracle through the CLI ------------
    # render --denoise 2 --tonemap aces --clamp 8 --aov gbuffer at 1024 x
    # 1024 (reference mode, 8 bounces): the artifacts, final.ppm within one
    # level of the same pipeline run on the CPU over a 256 x 256 render,
    # and the pipeline's time on the card (host clock, synchronized).
    from ascendpathtracing_tpu_torch import post
    from ascendpathtracing_tpu_torch.utils import io as pio

    post_args = ["--denoise", "2", "--tonemap", "aces", "--clamp", "8", "--aov", "gbuffer"]
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["render", "--backend", "cuda", "--width", str(FULL_W), "--height",
                           str(FULL_W), "--bounces", str(BOUNCES), *post_args, "--check-finite",
                           "--out", tmp])
        post_stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rc == 0 and post_stats["final"].endswith("final.ppm"), f"cli post: {post_stats}")
        names = ("color.ppm", "final.ppm", "depth.ppm", "normal.ppm", "albedo.ppm")
        require(all((Path(tmp) / n).exists() for n in names), "cli post: missing artifacts")
        final = pio.read_ppm(f"{tmp}/final.ppm")
        require(final.shape == (FULL_W, FULL_W, 3) and final.max() > 0, "cli post: final.ppm")
        colors_full = torch.tensor(pio.read_color_bin(f"{tmp}/color.bin"), device=dev)
    p_rays = torch.tensor(camera.generate_rays_numpy(FULL_W, FULL_W, 1, seed=0)
                          .astype(np.float32), device=dev)
    p_gbuf = megakernel.render_gbuffer_impl(p_rays, megakernel.scene_to_device(scene, device=dev))
    pkw = dict(clamp=8.0, denoise=2, tonemap="aces", exposure=1.0)
    require(np.array_equal(cli.post_pipeline(colors_full, p_gbuf, FULL_W, FULL_W, 1, **pkw),
                           final), "post pipeline: not the CLI's final.ppm")
    post_ms = []  # host clock: the pipeline decodes on the host between device passes
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        cli.post_pipeline(colors_full, p_gbuf, FULL_W, FULL_W, 1, **pkw)
        torch.cuda.synchronize()
        post_ms.append((time.time() - t0) * 1e3)
    hdr_rand = torch.rand((FULL_W, FULL_W, 3), device=dev)
    denoise_ms = statistics.median(bench.time_steps(
        lambda: post.atrous_denoise(hdr_rand, iterations=2), iters=5, warmup=1)[0])
    w256 = 256
    r256 = torch.tensor(camera.generate_rays_numpy(w256, w256, 1, seed=0).astype(np.float32))
    c256 = rk.render_reference(r256.to(dev), planes(), light_index=light, bounces=BOUNCES)
    g_cpu = megakernel.render_gbuffer_impl(r256, megakernel.scene_to_device(scene))
    g_dev = megakernel.render_gbuffer_impl(r256.to(dev), megakernel.scene_to_device(
        scene, device=dev))
    f_dev = cli.post_pipeline(c256, g_dev, w256, w256, 1, **pkw)
    f_cpu = cli.post_pipeline(c256.cpu(), g_cpu, w256, w256, 1, **pkw)
    post_levels = int(np.abs(f_dev.astype(int) - f_cpu.astype(int)).max())
    require(post_levels <= 1, f"post pipeline card vs CPU at 256x256: {post_levels} levels")
    phase("post_cli_1024", gpu=gpu, cli=post_stats, pipeline_ms=statistics.median(post_ms),
          pipeline_ms_runs=post_ms, atrous_2_levels_ms=denoise_ms,
          card_vs_cpu_levels_256=post_levels,
          tolerance="final.ppm within one level of the CPU's")
    del colors_full, p_rays, p_gbuf, r256, c256, hdr_rand
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["oracle", "--width", "64", "--height", "64", "--bounces", "1",
                           "--out", tmp])
        oracle_line = json.loads(buf.getvalue().strip().splitlines()[-1])
        o_colors = pio.read_color_bin(f"{tmp}/oracle_color.bin")
    o_rays, o_rp = rays_planes(64)
    o_ker = rk.render_reference_planes(o_rp, planes(), light_index=light, bounces=1)
    require(rc == 0 and np.array_equal(o_ker.T.cpu().numpy(), o_colors),
            f"cli oracle: {oracle_line}, not the kernel's colors at 1 bounce")
    phase("oracle_cli", cli=oracle_line, bitwise_vs_kernel_1bounce=True)

    # ---- 9-13. the fused path tracer (csrc/render_pt.cu) ---------------
    def pt_inputs(name, dtype=torch.float32):
        s = scenes.get_scene(name)
        return (
            convert.scene_planes_from_numpy(s.soa10(np.float64), device=dev, dtype=dtype),
            torch.tensor(s.material, dtype=torch.int32, device=dev),
        )

    def pt_pair(name, dtype, w, spp4, **kw):
        planes, mats = pt_inputs(name, dtype)
        kw = dict(width=w, height=w, spp4=spp4, bounces=BOUNCES, rr_depth=PT_RR, **kw)
        return ptk.render_pt(planes, mats, **kw), ptk.render_pt_plain(planes, mats, **kw)

    def rel_share(a, b, rtol):
        """Share of pixels with |a - b| <= rtol * |b|."""
        return float(((a - b).abs() <= rtol * b.abs()).float().mean())

    # 9. The Philox streams and the arithmetic agree: float64, kernel vs
    # twin, 64x64, spp4 = 16.
    f64 = {}
    for name in ("cornell8", "smallpt9"):
        k, p = pt_pair(name, torch.float64, 64, 16)
        require(bool(torch.allclose(k, p, rtol=1e-9, atol=0.0)),
                f"pt f64 {name}: kernel vs twin not allclose at rtol 1e-9")
        f64[name] = {"max_rel_err": max_rel(k, p), "bitwise": bool(torch.equal(k, p))}
    phase("pt_f64_philox_64x64_spp16", tolerance="allclose rtol 1e-9", **f64)

    # 10. float32, kernel vs twin, 64x64: zero uniforms, then Philox.
    f32 = {}
    nu = 2 + 3 * BOUNCES
    for label, u in (("zero_uniforms", torch.zeros((16, nu, 64 * 64), device=dev)),
                     ("philox", None)):
        k, p = pt_pair("cornell8", torch.float32, 64, 16, uniforms=u)
        share = rel_share(k, p, 1e-5)
        mean_rel = abs(float(k.mean()) - float(p.mean())) / float(p.mean())
        require(share >= 0.999 and mean_rel <= 1e-6,
                f"pt f32 {label}: share within 1e-5 {share}, means {mean_rel}")
        f32[label] = {"share_within_1e-5": share, "mean_rel_diff": mean_rel}
    phase("pt_f32_64x64_spp16", tolerance="share >= 99.9% within 1e-5 rel, "
          "means within 1e-6 rel", **f32)

    # 11. Full size: kernel (seed 0) finite and >= 0; the twin's run with
    # seed 0 for the error, and an independent run (seed 1) whose mean
    # must be within 4 standard errors (of the paired per-pixel
    # difference) of the kernel's; selftest check 4 on the card.
    planes, mats = pt_inputs("cornell8")
    full = dict(width=FULL_W, height=FULL_W, spp4=PT_SPP4, bounces=BOUNCES, rr_depth=PT_RR)
    img = ptk.render_pt(planes, mats, **full)
    require(bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0,
            "pt full size: non-finite or negative pixels")
    plain_times, plain0 = bench.time_steps(
        lambda: ptk.render_pt_plain(planes, mats, **full), iters=3, warmup=1)
    pt_err = float((img - plain0).abs().max())
    share0 = rel_share(img, plain0, 1e-5)
    require(share0 >= 0.99, f"pt full size vs twin, same seed: share {share0}")
    plain1 = ptk.render_pt_plain(planes, mats, **full, seed=1)
    diff = (img - plain1).double()
    se = float(diff.std()) / diff[0].numel() ** 0.5
    z = float(diff.mean()) / se
    require(abs(z) < 4.0, f"pt full size: kernel mean vs twin (seed 1) at {z} SE")
    energy = cli.pt_energy_check(dev)
    require(energy.pop("ok"), f"selftest check 4 on the card: {energy}")
    phase("pt_full_1024x1024_spp64", mean=float(img.mean()), min=float(img.min()),
          max_abs_err_vs_twin=pt_err, share_within_1e5_vs_twin=share0,
          bitwise_vs_twin=bool(torch.equal(img, plain0)),
          twin_seed1_mean=float(plain1.mean()), z_vs_twin_seed1=z,
          selftest_check4=energy)
    del plain0, plain1, diff

    # 12. The fused path tracer through the bench's step and entry point.
    pt_step = bench.make_pt_step("kernel", True, scenes.cornell8(), device=dev,
                                 bounces=BOUNCES, spp4=PT_SPP4)
    (out_pt, _), launches["pt_step"] = counted(pt_step)
    require(launches["pt_step"] == RUNS["pt_step"],
            f"pt step launches {launches['pt_step']}, expected {RUNS['pt_step']}")
    require(torch.equal(out_pt, img), "bench pt step differs from the full-size image")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_bench = bench.main(["--mode", "pt"])
    pt_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_bench == 0 and pt_line["value"] > 0
            and pt_line["detail"]["launches_per_step"] == {"pt": 1.0},
            f"bench --mode pt: {pt_line}")
    phase("pt_main_path_counted", launches=launches["pt_step"], bench=pt_line)
    del out_pt

    # 13. Times: kernel (10 runs), its twin (3 runs, above), and the plain
    # estimator at 4,194,304 rays of smallpt9, fwd and fwd+bwd (3 runs).
    pt_ms = statistics.median(bench.time_steps(
        lambda: ptk.render_pt(planes, mats, **full), iters=10, warmup=2)[0])
    rays4m = torch.tensor(camera.generate_rays_numpy(FULL_W, FULL_W, 1, seed=0)
                          .astype(np.float32), device=dev)
    est = {}
    for fwd_only in (True, False):
        st = bench.make_pt_step("plain", fwd_only, scenes.smallpt9(), device=dev,
                                bounces=BOUNCES, rays=rays4m)
        ms = statistics.median(bench.time_steps(st, iters=3, warmup=1)[0])
        est["fwd" if fwd_only else "fwd+bwd"] = {
            "ms": ms, "mrays_per_s": rays4m.shape[0] / (ms * 1e-3) / 1e6}
        torch.cuda.empty_cache()
    plain_ms = statistics.median(plain_times)
    samples = FULL_W * FULL_W * PT_SPP4
    # The bound counts this run's live sample-bounces: the same paths
    # through the mesh kernel with residuals, with a cube no ray reaches
    # (the image is render_pt's bit for bit, so the paths are).
    behind8 = mm.MeshScene.cornell_with_mesh(*meshes.cube(center=(50, 40, 250), size=25.0),
                                             base_scene="cornell8")
    tb = mpt.mesh_pt_tables(behind8, device=dev)
    img_b, wid_b, _ = mpt.render_pt_mesh(*tb[:4], materials=tb[4], with_residuals=True,
                                         **full, **mpt.pt_tables_kwargs(tb[5], dev))
    require(torch.equal(img_b, img), "cornell8 + unreachable cube is not render_pt's image")
    pt_live = int((wid_b >= 0).sum())
    del img_b, wid_b, tb
    torch.cuda.empty_cache()
    phase("pt_times", gpu=gpu, kernel_ms=pt_ms,
          kernel_msamples_per_s=samples / (pt_ms * 1e-3) / 1e6,
          twin_ms=plain_ms, twin_runs=len(plain_times), plain_estimator_4M=est,
          live_sample_bounces=pt_live)
    rows.append({
        "name": "pt", "route": "cuda", "source": SOURCE["pt"],
        "replaces": REPLACES["pt"], "run": RUN_OF["pt"],
        "launches": launches[RUN_OF["pt"]]["pt"], "max_abs_err": pt_err,
        "ms": pt_ms, "plain_ms": plain_ms,
        **bound(12 * FULL_W * FULL_W,
                pt_live * (SPHERE_OPS * s8 + PT_SHADE_OPS) + samples * CAM_OPS),
        "library_ms": None,
    })

    # 13b. Where the path tracer's steps go, from the twin's record of its
    # paths at cornell8, 1024 x 1024 x 4 samples (its image is the
    # kernel's bit for bit): bounces taken and rays traced (queries) per
    # path; a thread per pixel costs its warp the longest path of each
    # layer, path regeneration about the largest of the lanes' sums over
    # the layers, and the zero-throughput exit drops the queries made with
    # a throughput of zero (after the black front wall or the light).
    rec_kw = dict(width=FULL_W, height=FULL_W, spp4=4, bounces=BOUNCES, rr_depth=PT_RR)
    img_rec, queried, live, zero = ptk.path_record_plain(planes, mats, **rec_kw)
    require(torch.equal(img_rec, ptk.render_pt(planes, mats, **rec_kw)),
            "pt 1024x1024 x 4 spp: kernel and twin differ")
    per_path = {"bounces": live.sum(dim=1), "queries": queried.sum(dim=1),
                "queries_after_exit": (queried & ~zero).sum(dim=1)}  # [layers, pixels]

    def warp_max(x):  # the longest of each warp's 32 lanes
        return x.reshape(*x.shape[:-1], -1, 32).max(dim=-1).values.float()

    path_stats = {f"mean_{k}_per_path": float(v.float().mean()) for k, v in per_path.items()}
    path_stats.update({
        f"per_thread_steps_per_layer_{k}": float(warp_max(per_path[k]).mean())
        for k in ("bounces", "queries")})
    path_stats.update({
        f"regen_steps_per_layer_{k}": float(warp_max(per_path[k].sum(dim=0)).mean()) / 4
        for k in ("queries", "queries_after_exit")})
    path_stats["zero_throughput_share_of_bounces"] = float((live & zero).sum() / live.sum())
    path_stats["zero_throughput_share_of_queries"] = float(zero.sum() / queried.sum())
    phase("pt_path_stats", scene="cornell8", size=f"{FULL_W}x{FULL_W}x4",
          kernel_equals_twin=True, **path_stats)
    del img_rec, queried, live, zero, per_path

    del planes, mats, rays4m
    torch.cuda.empty_cache()

    # ---- 13c-13d. profiling and op counts (utils/profiling,
    # utils/roofline), while the card and host are as quiet as at phase 7:
    # at the end of the run the main step's events read ~25% slower than
    # at phase 7 and benchmark_fit's rounds spread past its 5%.
    profiling_phase(dev, gpu)
    roofline_phase(dev, gpu, rows, ceil_model)
    torch.cuda.empty_cache()

    # ---- 14-18. the mesh path (csrc/wbvh.cu, csrc/mesh_pt.cu) ----------
    def brute_first_hit(rp, v32, faces, batch=8192):
        """Float32 brute force over every face, in batches of rays ->
        (t, face); the reference of the traversal checks."""
        planes = [tuple(torch.tensor(c, device=dev) for c in p)
                  for p in tri.triangle_planes(v32, faces, dtype=np.float32)]
        ts, fs = [], []
        for i in range(0, rp.shape[1], batch):
            t = tri.intersect_triangles_brute(tuple(rp[0:3, i:i + batch]),
                                              tuple(rp[3:6, i:i + batch]), *planes, 1e-4)
            ts.append(t.amin(dim=0))
            fs.append(t.argmin(dim=0))
        return torch.cat(ts), torch.cat(fs)

    def wbvh_pair(rp, cb, sb, rows, ssb, **kw):
        """Kernel vs twin, bitwise in every output; kernel outputs."""
        k = wk.intersect_chunks(rp, cb, sb, rows, ssb, stats=True, **kw)
        p = wk.intersect_chunks_plain(rp, cb, sb, rows, ssb, stats=True, **kw)
        same = [torch.equal(a, b) for a, b in zip(k, p) if isinstance(a, torch.Tensor)]
        if kw.get("attrs"):
            same += [torch.equal(a, b) for a, b in zip(k[2], p[2])]
        return all(same), k

    def vs_brute(tmin, slot, fos, bt, bf):
        """The traversal against brute force: the same hit set, and the
        share of hit rays whose t is within 1e-3 (the JAX check's bound)
        with the rest counted.  The two forms are not equal at the edge:
        a grazing ray's d0 - n.o cancels in the precomputed-plane form, and
        a ray through a shared edge can pass between two triangles whose
        plane-form u + v both round past 1 (an edge crack), where
        Moller-Trumbore finds one of them."""
        hit = bt < 1e19
        dt = (tmin[hit] - bt[hit]).abs()
        face_eq = fos[slot[hit].long()] == bf[hit]
        return {"same_hit_set": torch.equal(tmin < 1e19, hit),
                "hit_frac": float(hit.float().mean()),
                "share_t_within_1e-3": float((dt <= 1e-3).float().mean()),
                "n_t_beyond_1e-3": int((dt > 1e-3).sum()), "max_t_err": float(dt.max()),
                "n_other_face": int((~face_eq).sum())}

    def brute_ok(r):
        return r["same_hit_set"] and r["share_t_within_1e-3"] >= 0.9999

    # 14. wbvh, kernel vs twin (bitwise: tmin, slot, attrs, stats) and vs
    # brute force (same hit set, t within the JAX check's 1e-3): 4,194,304
    # camera rays against the s4 grid, and 65,536 random rays against a
    # forced 3-level grid of icosphere s5 with a ragged last super-super.
    ms = bench.mesh_scene(MESH_SUBDIV)
    m_planes, m_cb, m_sb, m_t24, m_mats, m_grid = mpt.mesh_pt_tables(ms, device=dev)
    m_kw = mpt.pt_tables_kwargs(m_grid, dev)
    rays_np = camera.generate_rays_numpy(FULL_W, FULL_W, 1, seed=0).astype(np.float32)
    rp_cam = convert.rays_planes_from_numpy(rays_np, device=dev)
    eq4m, (tk, hk, _, st4m) = wbvh_pair(rp_cam, m_cb, m_sb, m_t24, None, attrs=True, **m_kw)
    require(eq4m, "wbvh 4M camera rays: kernel and twin differ")
    fos = torch.tensor(m_grid.face_of_slot, device=dev)
    v_s4 = np.asarray(ms.vertices, np.float32)
    bt_cam, bf_cam = brute_first_hit(rp_cam, v_s4, ms.faces)
    brute4m = vs_brute(tk, hk, fos, bt_cam, bf_cam)
    require(brute_ok(brute4m), f"wbvh 4M vs brute: {brute4m}")
    wbvh_err = float((tk - wk.intersect_chunks_plain(rp_cam, m_cb, m_sb, m_t24, **m_kw)[0]).abs().max())

    v5, f5 = meshes.icosphere(subdivisions=5)
    v5 = np.asarray(v5, np.float32)
    g3 = chunk_grid.build_chunk_grid(v5, f5, tris_per_chunk=16, supers_per=8, supers2_per=12)
    cb3, sb3, t3, _ = chunk_grid.chunk_grid_to_device(g3, dev)
    rng_np = np.random.RandomState(0)
    o_ = rng_np.randn(3, 65536).astype(np.float32)
    o_ /= np.linalg.norm(o_, axis=0)
    o_ *= 3.0
    d_ = rng_np.randn(3, 65536).astype(np.float32)
    d_ /= np.linalg.norm(d_, axis=0)
    rp_rand = torch.tensor(np.concatenate([o_, d_]), device=dev)
    kw3 = dict(tris_per_chunk=16, supers_per=8, supers2_per=12)
    eq3, (t3k, h3k, st3) = wbvh_pair(rp_rand, cb3, sb3, t3,
                                     torch.tensor(g3.ssboxes, device=dev), **kw3)
    require(eq3, "wbvh 3-level: kernel and twin differ")
    brute3 = vs_brute(t3k, h3k, torch.tensor(g3.face_of_slot, device=dev),
                      *brute_first_hit(rp_rand, v5, f5))
    require(brute_ok(brute3), f"wbvh 3-level vs brute: {brute3}")
    # Boxes past the kernels' 40 KB shared-memory budget are read from
    # global memory: icosphere s5 in chunks of 4 (5,120 chunks, 320
    # supers, 130 KB of boxes).
    gg = chunk_grid.build_chunk_grid(v5, f5, tris_per_chunk=4, supers_per=16)
    cbg, sbg, tg, _ = chunk_grid.chunk_grid_to_device(gg, dev)
    eqg, (tgk, hgk, _) = wbvh_pair(rp_rand, cbg, sbg, tg, None, tris_per_chunk=4,
                                   supers_per=16)
    require(eqg, "wbvh global boxes: kernel and twin differ")
    bruteg = vs_brute(tgk, hgk, torch.tensor(gg.face_of_slot, device=dev),
                      *brute_first_hit(rp_rand, v5, f5))
    require(brute_ok(bruteg), f"wbvh global boxes vs brute: {bruteg}")
    phase("wbvh_kernel_vs_twin_and_brute", tolerance="bitwise vs twin; vs brute: same hit "
          "set, t within 1e-3 on >= 99.99% of hit rays",
          s5_global_boxes_65536={"grid": [gg.n_chunks, gg.n_supers, gg.n_supers2],
                                 "box_bytes": 24 * (gg.n_chunks + gg.n_supers), **bruteg},
          s4_camera_4M={
              "grid": [m_grid.n_chunks, m_grid.n_supers, m_grid.n_supers2], **brute4m,
              "chunks_tested_mean": float(st4m[0].float().mean()),
              "chunks_tested_max": int(st4m[0].max())},
          s5_3level_65536={"grid": [g3.n_chunks, g3.n_supers, g3.n_supers2], **brute3,
                           "chunks_tested_mean": float(st3[0].float().mean())})
    wbvh_walk = st4m.long().sum(dim=1).tolist()
    cam_grid = wk.plain_grid(m_cb, m_sb, torch.tensor(m_grid.ssboxes, device=dev).reshape(-1, 6),
                             m_t24, torch.float32, tris_per_chunk=m_grid.tris_per_chunk,
                             supers_per=m_grid.supers_per, supers2_per=m_grid.supers2_per)
    cam_roots = int(mpt.root_entries(cam_grid, tuple(rp_cam[0:3]), tuple(rp_cam[3:6])).sum())
    del cam_grid
    del st4m, st3, rp_rand, tgk, hgk
    torch.cuda.empty_cache()

    # 15. mesh_pt, 64x64, spp4 16, 8 bounces, RR from 5, on the JAX tests'
    # mixed-material scene (icosphere s2: mirror, glass, emissive faces):
    # f64 allclose rtol 1e-9, f32 >= 99.9% of pixels within 1e-5 and means
    # within 1e-6, with zero uniforms and with Philox; then a mesh that no
    # ray reaches gives render_pt's image bitwise.
    mixed = mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=14.0, subdivisions=2), albedo=(0.85, 0.55, 0.2))
    nf = mixed.faces.shape[0]
    mixed.face_material[: nf // 3] = scenes.SPEC
    mixed.face_material[nf // 3: nf // 2] = scenes.REFR
    mixed.face_emission[:4] = (0.0, 2.0, 0.5)
    small = {}
    for tdt in (torch.float64, torch.float32):
        tables = mpt.mesh_pt_tables(mixed, device=dev, dtype=tdt)
        kw = dict(materials=tables[4], width=64, height=64, spp4=16, bounces=BOUNCES,
                  rr_depth=PT_RR, **mpt.pt_tables_kwargs(tables[5], dev))
        for label, u in (("zero_uniforms", torch.zeros((16, 2 + 3 * BOUNCES, 64 * 64),
                                                       dtype=tdt, device=dev)),
                         ("philox", None)):
            k = mpt.render_pt_mesh(*tables[:4], uniforms=u, **kw)
            p = mpt.render_pt_mesh_plain(*tables[:4], uniforms=u, **kw)
            name = f"{str(tdt).split('.')[-1]}_{label}"
            if tdt == torch.float64:
                require(bool(torch.allclose(k, p, rtol=1e-9, atol=0.0)),
                        f"mesh_pt {name}: kernel vs twin not allclose at rtol 1e-9")
                small[name] = {"max_rel_err": max_rel(k, p), "bitwise": bool(torch.equal(k, p))}
            else:
                share = rel_share(k, p, 1e-5)
                mean_rel = abs(float(k.mean()) - float(p.mean())) / float(p.mean())
                require(share >= 0.999 and mean_rel <= 1e-6,
                        f"mesh_pt {name}: share within 1e-5 {share}, means {mean_rel}")
                small[name] = {"share_within_1e-5": share, "mean_rel_diff": mean_rel,
                               "bitwise": bool(torch.equal(k, p))}
    # Boxes from global memory (past 40 KB): icosphere s5 in chunks of 4.
    tables = mpt.mesh_pt_tables(mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=14.0, subdivisions=5)), device=dev, tris_per_chunk=4)
    kw = dict(materials=tables[4], width=16, height=16, spp4=4, bounces=BOUNCES,
              rr_depth=PT_RR, **mpt.pt_tables_kwargs(tables[5], dev))
    k = mpt.render_pt_mesh(*tables[:4], **kw)
    p = mpt.render_pt_mesh_plain(*tables[:4], **kw)
    share = rel_share(k, p, 1e-5)
    require(share >= 0.999, f"mesh_pt with global-memory boxes: share within 1e-5 {share}")
    small["float32_global_boxes_16x16"] = {
        "share_within_1e-5": share, "bitwise": bool(torch.equal(k, p)),
        "box_bytes": 24 * (tables[5].n_chunks + tables[5].n_supers)}
    behind = mm.MeshScene.cornell_with_mesh(*meshes.cube(center=(50, 40, 250), size=25.0))
    for tdt in (torch.float32, torch.float64):
        tables = mpt.mesh_pt_tables(behind, device=dev, dtype=tdt)
        kw = dict(width=128, height=128, spp4=16, bounces=BOUNCES, rr_depth=PT_RR, seed=7)
        a = mpt.render_pt_mesh(*tables[:4], materials=tables[4], **kw,
                               **mpt.pt_tables_kwargs(tables[5], dev))
        require(torch.equal(a, ptk.render_pt(tables[0], tables[4], **kw)),
                f"unreachable mesh {tdt}: not render_pt's image bitwise")
    phase("mesh_pt_64x64_spp16", tolerance="f64 allclose rtol 1e-9; f32 share >= 99.9% "
          "within 1e-5 rel, means within 1e-6 rel",
          unreachable_mesh_bitwise_vs_render_pt=True,
          **small)

    # 16. Full size: kernel 1024x1024 x 64 spp on s4 (seed 0), finite and
    # >= 0.  The twin runs at full resolution with 4 samples (a
    # full-sample twin takes minutes): with seed 0 and residuals against
    # the kernel at the same 4 samples (8 bounces, RR from 5: wid and resv
    # bitwise, so every RR-death bounce too), counting its walk for the
    # bound; and with seed 1 as an independent run whose mean must be
    # within 4 standard errors (of the per-pixel difference, both images'
    # noise) of the kernel's 64-sample mean.  The twin runs once with
    # every option (residuals, camera, stats of STATS_TILE-pixel cells);
    # the kernel runs each option as its main path launches it: residuals
    # and camera (render_with_camera) bitwise in image, wid, resv and suv,
    # and stats alone (phase 22d) bitwise in image and kstats.
    full = dict(materials=m_mats, width=FULL_W, height=FULL_W, bounces=BOUNCES,
                rr_depth=PT_RR, **m_kw)
    m_img = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, **full)
    require(bool(torch.isfinite(m_img).all()) and float(m_img.min()) >= 0.0,
            "mesh_pt full size: non-finite or negative pixels")
    k4, kwid4, kresv4, ksuv4 = mpt.render_pt_mesh(
        m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4, with_residuals=True,
        with_camera=True, **full)
    walk4 = torch.zeros((BOUNCES, 5), dtype=torch.int64, device=dev)  # a row per bounce
    p4, pwid4, presv4, psuv4, pks4 = mpt.render_pt_mesh_plain(
        m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4, with_residuals=True,
        with_camera=True, with_stats=True, stats_tile=STATS_TILE, walk_counts=walk4, **full)
    require(torch.equal(kwid4, pwid4) and torch.equal(kresv4, presv4),
            "mesh_pt full resolution vs twin, same seed: residuals (wid, resv) not bitwise")
    require(torch.equal(ksuv4, psuv4), "mesh_pt full resolution vs twin: suv not bitwise")
    ks_img4, kks4 = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4,
                                       with_stats=True, stats_tile=STATS_TILE, **full)
    require(torch.equal(kks4, pks4), "mesh_pt full resolution vs twin: kstats differ")
    twin_live4 = int((pwid4 >= 0).sum())
    rr_death4 = int(((kwid4[PT_RR:-1] >= 0) & (kwid4[PT_RR + 1:] < 0)).sum())
    full_opts = {"image_bitwise_camera_vs_twin": bool(torch.equal(k4, p4)),
                 "image_bitwise_stats_vs_twin": bool(torch.equal(ks_img4, p4)),
                 "suv_bitwise": True, "kstats_equal": True,
                 "kstats_chunks_mean_by_bounce": kks4[:BOUNCES].float().mean(dim=1).tolist()}
    require(full_opts["image_bitwise_camera_vs_twin"] and full_opts["image_bitwise_stats_vs_twin"],
            f"mesh_pt full resolution vs twin: images differ {full_opts}")
    del kwid4, kresv4, pwid4, presv4, ksuv4, psuv4, ks_img4, kks4, pks4
    mesh_err = float((k4 - p4).abs().max())
    share4 = rel_share(k4, p4, 1e-5)
    require(share4 >= 0.99, f"mesh_pt full resolution vs twin, same seed: share {share4}")
    twin_times, p1 = bench.time_steps(lambda: mpt.render_pt_mesh_plain(
        m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4, seed=1, **full), iters=1, warmup=0)
    diff = (m_img - p1).double()
    se = float(diff.std()) / diff[0].numel() ** 0.5
    z_mesh = float(diff.mean()) / se
    require(abs(z_mesh) < 4.0, f"mesh_pt full size: kernel mean vs twin (seed 1) at {z_mesh} SE")
    phase("mesh_pt_full_1024x1024_spp64", mean=float(m_img.mean()), min=float(m_img.min()),
          twin_spp4=MESH_TWIN_SPP4, max_abs_err_vs_twin_spp4=mesh_err,
          bitwise_vs_twin_spp4=bool(torch.equal(k4, p4)), residuals_bitwise_vs_twin_spp4=True,
          options_vs_twin_spp4=full_opts, stats_tile=STATS_TILE,
          live_sample_bounces_spp4=twin_live4, paths_ended_in_rr_bounces_spp4=rr_death4,
          twin_walk_spp4=walk4.sum(dim=0).tolist(),
          share_within_1e5_vs_twin=share4, twin_seed1_mean=float(p1.mean()),
          z_vs_twin_seed1=z_mesh)
    del k4, p4, p1, diff
    torch.cuda.empty_cache()

    # 17. The mesh path through its entry points, counted from zero.
    dev_chunks = mm.mesh_scene_to_device(ms, device=dev, pallas_bvh_kernel=True)
    (ft, fk, fh), launches["first_hit_mesh"] = counted(
        lambda: mm.first_hit_mesh_impl(torch.tensor(rays_np, device=dev), dev_chunks))
    require(launches["first_hit_mesh"] == RUNS["first_hit_mesh"],
            f"first_hit_mesh launches {launches['first_hit_mesh']}")
    # Triangle pixels carry the traversal's t and slot (on the query's own
    # tables, built from float32 vertices); elsewhere a sphere is as near
    # or nearer.
    conf = dev_chunks["static"]
    tc, hc, _ = wk.intersect_chunks(
        rp_cam, *dev_chunks["wbvh"], tris_per_chunk=conf.tris_per_chunk,
        supers_per=conf.supers_per, supers2_per=conf.supers2_per, attrs=True)
    tri_px = fk == 2
    require(bool(tri_px.any()) and torch.equal(ft[tri_px], tc[tri_px])
            and torch.equal(fh[tri_px], hc[tri_px]) and bool((tc[~tri_px] >= ft[~tri_px]).all()),
            "first_hit_mesh: triangle pixels disagree with the traversal")
    mesh_step, _ = bench.make_mesh_step("kernel", ms, device=dev, bounces=BOUNCES,
                                        spp4=PT_SPP4)
    (out_mesh, _), launches["mesh_step"] = counted(mesh_step)
    require(launches["mesh_step"] == RUNS["mesh_step"],
            f"mesh step launches {launches['mesh_step']}")
    require(torch.equal(out_mesh, m_img), "bench mesh step differs from the full-size image")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_bench = bench.main(["--mode", "mesh", "--fwd-only"])
    mesh_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_bench == 0 and mesh_line["value"] > 0
            and mesh_line["detail"]["launches_per_step"] == {"mesh_pt": 1.0},
            f"bench --mode mesh --fwd-only: {mesh_line}")
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["render", "--scene", "mesh-icosphere", "--mode", "pt",
                           "--renderer", "kernel", "--backend", "cuda", "--width", "256",
                           "--height", "256", "--samples", "4", "--bounces", "8",
                           "--check-finite", "--out", tmp])
        mesh_cli = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rc == 0 and (Path(tmp) / "color.ppm").exists(), f"cli mesh render: {mesh_cli}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_self, self_launches = counted(lambda: cli.main(["selftest", "--backend", "cuda"]))
    self_lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    # check 5 launches the chunk kernel once, check 6's bounce-loop render
    # once per bounce (4)
    require(rc_self == 0 and self_lines[-1]["passed"] == 8 and self_lines[-1]["ran"] == 8
            and self_launches["wbvh"] == 5 and self_launches["segsum"] >= 1
            and self_lines[5]["check"] == "mesh_pt_fused_energy_vs_xla" and self_lines[5]["ok"]
            and self_lines[6]["check"] == "mesh_fused_vjp_grads" and self_lines[6]["ok"]
            and self_lines[7]["check"] == "checkify_float_guards" and self_lines[7]["ok"],
            f"cli selftest: {self_lines}, launches {self_launches}")
    phase("mesh_entry_points_counted", first_hit_mesh=launches["first_hit_mesh"],
          triangle_pixels=int(tri_px.sum()), mesh_step=launches["mesh_step"],
          bench=mesh_line, cli_render=mesh_cli, selftest_check5=self_lines[4],
          selftest_mesh_xla=self_lines[5], selftest_mesh_vjp=self_lines[6],
          selftest_launches=self_launches)
    del out_mesh, ft, fk, fh, tc, hc, dev_chunks

    # 18. Times: wbvh kernel (10 runs) vs twin (3) at 4,194,304 camera
    # rays with attrs, as first_hit_mesh calls it; mesh_pt kernel (10
    # runs) at the full size; its twin at phase 16's size (1 run, above).
    wbvh_call = (lambda: wk.intersect_chunks(rp_cam, m_cb, m_sb, m_t24, attrs=True, **m_kw))
    wbvh_plain = (lambda: wk.intersect_chunks_plain(rp_cam, m_cb, m_sb, m_t24, attrs=True,
                                                    **m_kw))
    wbvh_ms = med_ms(wbvh_call)
    wbvh_plain_ms = statistics.median(bench.time_steps(wbvh_plain, iters=3, warmup=1)[0])

    def mesh_frame():
        return mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, **full)

    mesh_ms = statistics.median(bench.time_steps(mesh_frame, iters=10, warmup=1)[0])
    mpt.queue_overflows()  # from zero: one frame's overflows
    require(torch.equal(mesh_frame(), m_img), "mesh frame does not repeat bit for bit")
    overflows = mpt.queue_overflows()
    # Where the frame's time goes: the same spheres alone through
    # render_pt.cu, and through mesh_pt.cu with the mesh out of every
    # ray's reach (behind the camera: each ray still tests the 20 super
    # boxes, and enters none); both give the sphere image bit for bit.
    far = mpt.mesh_pt_tables(mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 400), radius=14.0, subdivisions=MESH_SUBDIV)), device=dev)
    require((far[5].n_chunks, far[5].n_supers) == (m_grid.n_chunks, m_grid.n_supers),
            "the unreachable mesh's grid differs from the cell's")
    spheres_alone = dict(width=FULL_W, height=FULL_W, spp4=PT_SPP4, bounces=BOUNCES,
                         rr_depth=PT_RR)

    def spheres_frame():
        return ptk.render_pt(m_planes, m_mats, **spheres_alone)

    def unreachable_frame():
        return mpt.render_pt_mesh(*far[:4], materials=far[4], **spheres_alone,
                                  **mpt.pt_tables_kwargs(far[5], dev))

    require(torch.equal(spheres_frame(), unreachable_frame()),
            "unreachable s4 mesh: not render_pt's image bitwise")
    breakdown = {"spheres_render_pt_ms": med_ms(spheres_frame, 10),
                 "unreachable_mesh_ms": med_ms(unreachable_frame, 10), "frame_ms": mesh_ms}
    del far
    mesh_plain_ms = statistics.median(twin_times)
    m_samples = FULL_W * FULL_W * PT_SPP4
    # The phase's line waits for the frame's bound (phase 19's live
    # sample-bounces).
    mesh_times = dict(
        gpu=gpu, wbvh_4M_ms=wbvh_ms, wbvh_twin_4M_ms=wbvh_plain_ms, mesh_pt_ms=mesh_ms,
        mesh_pt_msamples_per_s=m_samples / (mesh_ms * 1e-3) / 1e6, mesh_twin_ms=mesh_plain_ms,
        mesh_twin_size=f"{FULL_W}x{FULL_W}x{MESH_TWIN_SPP4}", twin_runs=len(twin_times),
        queue_overflows_per_frame=overflows, breakdown=breakdown,
        render_pt_ms=pt_ms)
    # wbvh: 4M camera rays with attrs, the walk of phase 14's counts.
    n_cam = rp_cam.shape[1]
    mesh_rows = {}
    for name, err, ms_k, ms_p in (("wbvh", wbvh_err, wbvh_ms, wbvh_plain_ms),
                                  ("mesh_pt", mesh_err, mesh_ms, mesh_plain_ms)):
        mesh_rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "run": RUN_OF[name],
            "launches": launches[RUN_OF[name]][name], "max_abs_err": err,
            "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
        }
        rows.append(mesh_rows[name])
    mesh_rows["wbvh"].update(bound(n_cam * (24 + 8 + 44),
                                   walk_ops(wbvh_walk, n_cam, m_grid, roots=cam_roots)),
                             root_entries=cam_roots)
    del rp_cam
    torch.cuda.empty_cache()

    # ---- 19-22. the mesh training step (csrc/mesh_pt.cu residuals,
    # csrc/segsum.cu, diff/mesh_fused) -----------------------------------
    # 19. Residuals, 64x64, spp4 16, 4 bounces, RR from 2, the mixed
    # scene: kernel vs twin bitwise in image, wid and resv (f32 and f64,
    # zero uniforms and Philox); the image with residuals is the image
    # without, bit for bit.
    res19 = {}
    for tdt in (torch.float32, torch.float64):
        tables = mpt.mesh_pt_tables(mixed, device=dev, dtype=tdt)
        kw = dict(materials=tables[4], width=64, height=64, spp4=16, bounces=4, rr_depth=2,
                  **mpt.pt_tables_kwargs(tables[5], dev))
        for label, u in (("zero_uniforms", torch.zeros((16, 2 + 3 * 4, 64 * 64), dtype=tdt,
                                                       device=dev)),
                         ("philox", None)):
            name = f"{str(tdt).split('.')[-1]}_{label}"
            k = mpt.render_pt_mesh(*tables[:4], uniforms=u, with_residuals=True, **kw)
            p = mpt.render_pt_mesh_plain(*tables[:4], uniforms=u, with_residuals=True, **kw)
            same = [torch.equal(a, b) for a, b in zip(k, p)]
            require(all(same), f"residuals {name}: kernel vs twin (image, wid, resv) {same}")
            require(torch.equal(k[0], mpt.render_pt_mesh(*tables[:4], uniforms=u, **kw)),
                    f"residuals {name}: the image changed")
            wid19 = k[1]
            res19[name] = {"dead_share": float((wid19 < 0).float().mean()),
                           "triangle_share": float((wid19 >= 9).float().mean()),
                           "rr_bounce_s_gt_1_share": float((k[2][2:, 6][wid19[2:] >= 0] > 1)
                                                           .float().mean())}
    phase("mesh_pt_residuals_64x64_spp16", tolerance="bitwise (image, wid, resv); image "
          "with residuals == without", **res19)

    # 19b. The camera and stats outputs, 64x64, spp4 16, 8 bounces, RR from
    # 5, the mixed scene: kernel vs twin bitwise in image, wid, resv, suv
    # and kstats (f32 with Philox, f64 with zero uniforms; cells of 1024
    # pixels), with both options and with each on its own; image, wid and
    # resv the same as the launch with residuals alone.  kstats also on a
    # 3-level grid (icosphere s5, chunks of 16, 8
    # per super, 12 per super-super: ragged, so pad boxes take part), f32,
    # 32x32 x 4 samples (its twin walks 1,526 boxes in Python loops).
    cam19 = {}
    for tdt in (torch.float32, torch.float64):
        tables = mpt.mesh_pt_tables(mixed, device=dev, dtype=tdt)
        kw = dict(materials=tables[4], width=64, height=64, spp4=16, bounces=BOUNCES,
                  rr_depth=PT_RR, with_residuals=True, **mpt.pt_tables_kwargs(tables[5], dev))
        opts = dict(with_camera=True, with_stats=True, stats_tile=1024)
        u = (None if tdt == torch.float32 else
             torch.zeros((16, 2 + 3 * BOUNCES, 64 * 64), dtype=tdt, device=dev))
        for label in ("philox",) if u is None else ("zero_uniforms",):
            name = f"{str(tdt).split('.')[-1]}_{label}"
            k = mpt.render_pt_mesh(*tables[:4], uniforms=u, **opts, **kw)
            p = mpt.render_pt_mesh_plain(*tables[:4], uniforms=u, **opts, **kw)
            same = [torch.equal(a, b) for a, b in zip(k, p)]
            require(all(same), f"camera/stats {name}: kernel vs twin (image, wid, resv, suv, "
                    f"kstats) {same}")
            base = mpt.render_pt_mesh(*tables[:4], uniforms=u, **kw)
            require(all(torch.equal(a, b) for a, b in zip(k[:3], base)),
                    f"camera/stats {name}: the options changed the image, wid or resv")
            # each option on its own, as its main path launches it
            cam_only = mpt.render_pt_mesh(*tables[:4], uniforms=u, with_camera=True, **kw)
            same = [torch.equal(a, b) for a, b in zip(cam_only, p[:4])]
            require(all(same), f"with_camera alone {name}: kernel vs twin (image, wid, resv, "
                    f"suv) {same}")
            stats_kw = {**kw, "with_residuals": False}
            stats_only = mpt.render_pt_mesh(*tables[:4], uniforms=u, with_stats=True,
                                            stats_tile=1024, **stats_kw)
            same = [torch.equal(a, b) for a, b in zip(stats_only, (p[0], p[4]))]
            require(all(same), f"with_stats alone {name}: kernel vs twin (image, kstats) {same}")
            cam19[name] = {"suv_min_max": [float(k[3].min()), float(k[3].max())],
                           "kstats_chunks_by_bounce": k[4][:BOUNCES].float().mean(dim=1).tolist()}
    ms5 = mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=14.0, subdivisions=5), albedo=(0.85, 0.55, 0.2))
    t5 = mpt.mesh_pt_tables(ms5, device=dev, tris_per_chunk=16, supers_per=8, supers2_per=12)
    kw5 = dict(materials=t5[4], width=32, height=32, spp4=4, bounces=BOUNCES, rr_depth=PT_RR,
               with_stats=True, stats_tile=256, **mpt.pt_tables_kwargs(t5[5], dev))
    k5 = mpt.render_pt_mesh(*t5[:4], **kw5)
    p5 = mpt.render_pt_mesh_plain(*t5[:4], **kw5)
    require(torch.equal(k5[1], p5[1]) and torch.equal(k5[0], p5[0]),
            "stats on the 3-level grid: kernel vs twin (image, kstats) differ")
    require(int(k5[1][2 * BOUNCES].max()) > 0, "3-level grid: no super-super entered")
    cam19["float32_3level_s5_32x32_spp4"] = {
        "grid": [t5[5].n_chunks, t5[5].n_supers, t5[5].n_supers2],
        "kstats_mean_bounce0": [float(k5[1][lv * BOUNCES].float().mean()) for lv in range(3)]}
    del k5, p5, t5, ms5
    phase("mesh_pt_camera_stats_64x64_spp16", tolerance="bitwise (image, wid, resv, suv); "
          "kstats equal; both options and each alone; image, wid, resv == the launch "
          "without the options", **cam19)

    # The full-size residuals (1024x1024 x 64 spp of s4, seed 0): the
    # same paths as phase 16's forward, and the real replay stream.
    n_slots = m_t24.shape[0]
    img_r, wid_r, resv_r = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4,
                                              with_residuals=True, **full)
    require(torch.equal(img_r, m_img), "full-size image with residuals differs from without")
    # The image rebuilt from the residuals alone reads every offset of
    # wid and resv (resv has 3.76e9 elements, past 2^31).
    rebuilt = image_from_residuals(wid_r, resv_r, PT_SPP4, mf.LAYER_CHUNK)
    rebuild_err = float(((img_r.double() - rebuilt).abs() / rebuilt.clamp_min(1e-300)).max())
    require(bool(((img_r.double() - rebuilt).abs() <= 1e-5 * rebuilt).all()),
            f"full-size image vs its rebuild from the residuals: max rel err {rebuild_err}")
    del rebuilt
    mesh_live = int((wid_r >= 0).sum())
    # The walk's operations: phase 16's twin count over its 4 layers,
    # scaled by the live sample-bounces of the 64.
    walk_all = walk4.sum(dim=0)
    mesh_walk = walk_ops(walk_all[1:4].tolist(), int(walk_all[0]), m_grid,
                         roots=int(walk_all[4])) * mesh_live / twin_live4
    mesh_rows["mesh_pt"].update(bound(12 * FULL_W * FULL_W,
                                      mesh_live * (SPHERE_OPS * 9 + PT_SHADE_OPS)
                                      + FULL_W * FULL_W * PT_SPP4 * CAM_OPS + mesh_walk))
    mesh_times["walk_root_entry_share_twin_spp4"] = int(walk_all[4]) / int(walk_all[0])
    mesh_times["mesh_pt_bound_ms"] = mesh_rows["mesh_pt"]["bound_ms"]
    mesh_times["mesh_pt_x_of_bound"] = mesh_ms / mesh_rows["mesh_pt"]["bound_ms"]
    phase("mesh_times", **mesh_times)
    n_seg = 9 + n_slots

    # 20. The segment-sum kernel vs its twin in float64: kocc equal, each
    # segment within SEG_TOL x (sum of |vals| over its rows); two launches
    # on the same inputs give the same sums and kocc bit for bit.
    def seg_check(seg, vals, n_slots, f64_too=False):
        ref = segk.segment_rows_plain(seg, vals.double(), n_slots=n_slots)
        mag = segk.segment_rows_plain(seg, vals.double().abs(), n_slots=n_slots)
        kocc_ref = segk.occupancy_plain(seg, n_slots=n_slots)
        out = {}
        runs = [("paged_f32", vals)] + ([("paged_f64", vals.double())] if f64_too else [])
        for label, v in runs:
            acc, kocc = segk.segment_rows_paged(seg, v, n_slots=n_slots)
            again, kocc2 = segk.segment_rows_paged(seg, v, n_slots=n_slots)
            require(torch.equal(acc, again) and torch.equal(kocc, kocc2),
                    f"segsum {label}: two launches differ")
            require(torch.equal(kocc, kocc_ref), f"segsum {label}: kocc differs")
            err = (acc.double() - ref).abs()
            out[label] = float((err / mag.clamp_min(1e-300)).max())
            require(bool((err <= SEG_TOL * mag).all()),
                    f"segsum {label}: beyond tolerance, max err / sum|vals| {out[label]}")
        acc = segk.segment_rows_matmul(seg, vals, n_slots=n_slots)
        require(torch.equal(acc, segk.segment_rows_matmul(seg, vals, n_slots=n_slots)),
                "segsum matmul: two launches differ")
        err = (acc.double() - ref).abs()
        out["matmul_f32"] = float((err / mag.clamp_min(1e-300)).max())
        require(bool((err <= SEG_TOL * mag).all()),
                f"segsum matmul: beyond tolerance, max err / sum|vals| {out['matmul_f32']}")
        out["max_abs_err"] = float((segk.segment_rows_paged(seg, vals, n_slots=n_slots)[0].double()
                                    - ref).abs().max())
        out["kocc_mean"] = float(kocc_ref.float().mean())
        return out

    rng = np.random.RandomState(0)
    seg20 = {}
    for label, n_rows, s, r in (("random", 10000, 700, 6), ("random", 4096, 513, 3),
                                ("random", 2048, 2048, 8), ("backward", 1 << 16, 5121, 6),
                                ("clustered", 20000, 20000, 6), ("clustered", 4096, 9000, 3),
                                ("wide", 1 << 14, 6000, 6)):
        if label == "clustered":
            seg = (rng.randint(0, 20, n_rows) * (s // 20) + rng.randint(0, s // 40, n_rows))
            seg[: n_rows // 100] = -1
            seg[n_rows // 100: n_rows // 50] = s + 7
        else:
            lo, hi = {"random": (-1, s), "backward": (0, s + 200), "wide": (-5, s + 100)}[label]
            seg = rng.randint(lo, hi, n_rows)
        seg_t = torch.tensor(seg.astype(np.int32), device=dev)
        vals_t = torch.tensor(rng.randn(r, n_rows).astype(np.float32), device=dev)
        seg20[f"{label}_{n_rows}x{s}x{r}"] = seg_check(seg_t, vals_t, s, f64_too=True)
    acc = segk.segment_rows_matmul(torch.tensor([0, 5, 100, -3, 2], dtype=torch.int32, device=dev),
                                 torch.ones((2, 5), device=dev), n_slots=6)
    require(acc[[0, 5, 2]].eq(1).all() and float(acc.sum()) == 6.0, "out-of-range ids kept")
    # A synthetic 1,310,720-slot stream (icosphere s8's slot count, where
    # the TPU left its VMEM kernel): 2^25 rows, 60% in runs of sphere ids,
    # the rest in runs of 64 rows over neighbouring slots.
    s8_slots = 1310720
    n8 = 1 << 25
    row = torch.arange(n8, device=dev)
    region = (row >> 6) * 2654435761 % (s8_slots // 16) * 16
    tri_ids = 9 + region + torch.randint(0, 16, (n8,), device=dev)
    seg8 = torch.where(torch.rand(n8, device=dev) < 0.6, (row >> 10) % 9, tri_ids).int()
    vals8 = torch.rand((6, n8), device=dev)
    seg20["synthetic_s8_33554432x1310729x6"] = seg_check(seg8, vals8, 9 + s8_slots)
    seg20["synthetic_s8_33554432x1310729x6"]["kernel_ms"] = med_ms(
        lambda: segk.segment_rows_paged(seg8, vals8, n_slots=9 + s8_slots), iters=5)
    del row, region, tri_ids, seg8, vals8
    # The real replay stream: chunk 0 of the full-size training step
    # (8 layers x 8 bounces x 1,048,576 pixels), cotangent ones.
    g_cell = torch.full((3, 1, FULL_W * FULL_W), 1.0 / PT_SPP4, device=dev)
    seg_real = wid_r[:, :mf.LAYER_CHUNK].reshape(-1)
    vals_real = mf.replay_rows(wid_r[:, :mf.LAYER_CHUNK], resv_r[:, :, :mf.LAYER_CHUNK],
                               g_cell).reshape(6, -1)
    real = seg_check(seg_real, vals_real, n_seg)
    seg20["replay_chunk0"] = real
    if ab_names:
        ab_saved["replay"] = (seg_real.cpu(), vals_real.cpu(), n_seg)
    n_real = seg_real.shape[0]
    seg_ms = med_ms(lambda: segk.segment_rows_paged(seg_real, vals_real, n_slots=n_seg))
    seg_plain_ms = med_ms(lambda: segk.segment_rows_plain(seg_real, vals_real, n_slots=n_seg),
                          iters=5)
    # library_ms: one index_add_ call on the same stream, the dropped rows
    # sent to a dump row (index and rows made contiguous beforehand).
    idx_lib = torch.where((seg_real >= 0) & (seg_real < n_seg), seg_real,
                          n_seg).long()
    src_lib = vals_real.T.contiguous()
    acc_lib = torch.zeros((n_seg + 1, 6), device=dev)
    seg_lib_ms = med_ms(lambda: acc_lib.index_add_(0, idx_lib, src_lib))
    del idx_lib, src_lib, acc_lib
    seg_bound = bound(n_real * (4 + 6 * 4) + n_seg * 6 * 4, n_real * 6)
    phase("segsum_kernel_vs_twin", gpu=gpu, tolerance=f"kocc equal; per segment "
          f"|kernel - f64 twin| <= {SEG_TOL} x sum |vals|; two launches bitwise equal",
          streams=seg20, deterministic=True, replay_rows=n_real, kernel_ms=seg_ms,
          kernel_ms_atomic_before=SEG_ATOMIC_MS, twin_ms=seg_plain_ms,
          index_add_ms=seg_lib_ms, **seg_bound)
    del seg_real, vals_real
    torch.cuda.empty_cache()

    # 21. The full training step (1024x1024 x 64 spp of s4, 8 bounces, RR
    # from 5) through make_render_pt_mesh_diff, counted from zero.
    train_step, _ = bench.make_mesh_step("kernel", ms, device=dev, bounces=BOUNCES,
                                         spp4=PT_SPP4, fwd_only=False)
    del img_r
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()  # phase 20's residuals among them
    torch.cuda.reset_peak_memory_stats()
    (loss_t, (gp, ga, ge)), launches["mesh_train_step"] = counted(train_step)
    peak_step = torch.cuda.max_memory_allocated() - resident
    require(launches["mesh_train_step"] == RUNS["mesh_train_step"],
            f"mesh train step launches {launches['mesh_train_step']}")
    require(all(bool(torch.isfinite(x).all()) for x in (loss_t, gp, ga, ge)),
            "mesh train step: non-finite gradients")
    pad = fos < 0
    require(float(gp[0:4].abs().max()) == 0.0, "mesh train step: plane rows 0-3 not 0")
    require(float(ga[pad].abs().sum()) == 0.0 and float(ge[pad].abs().sum()) == 0.0,
            "pad slots carry gradient")
    require(float(gp[4:10].abs().max()) > 0 and float(ga.abs().max()) > 0
            and float(ge.abs().max()) > 0, "mesh train step: zero gradients")
    # The same step again: the loss and the scene and slot gradients repeat
    # bit for bit (the segment-sum is deterministic).
    loss_t2, grads2 = train_step()
    require(torch.equal(loss_t, loss_t2) and all(torch.equal(a, b) for a, b in
                                                 zip((gp, ga, ge), grads2)),
            "mesh train step: two runs' gradients differ")
    del loss_t2, grads2
    # The same residuals replayed by the kernel and by the twin (f64
    # sums); every row is >= 0 for g = ones, so sum |rows| is the twin's
    # value and the gate is relative.
    g_ones = torch.ones((3, FULL_W * FULL_W), device=dev)
    rkw = dict(n_spheres=9, n_slots=n_slots, spp4=PT_SPP4)
    rep_k = mf.replay_backward(wid_r, resv_r, g_ones, **rkw)
    rep_p = mf.replay_backward(wid_r, resv_r, g_ones, plain=True, **rkw)
    rep_err = {}
    for name, a, b in zip(("d_planes", "d_slot_albedo", "d_slot_emission"), rep_k, rep_p):
        err = (a.double() - b.double()).abs()
        require(bool((err <= SEG_TOL * b.double().abs()).all()),
                f"replay {name}: kernel vs twin beyond {SEG_TOL}")
        rep_err[name] = float((err / b.double().abs().clamp_min(1e-300)).max())
    replay_ms = med_ms(lambda: mf.replay_backward(wid_r, resv_r, g_ones, **rkw), iters=3)
    replay_plain_ms = med_ms(lambda: mf.replay_backward(wid_r, resv_r, g_ones, plain=True,
                                                        **rkw), iters=3)
    dead_share = float((wid_r < 0).float().mean())
    del wid_r, resv_r, rep_k, rep_p
    torch.cuda.empty_cache()
    fwd_res_ms = med_ms(lambda: mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4,
                                                   with_residuals=True, **full)[0], iters=3)
    step_times, _ = bench.time_steps(train_step, iters=5, warmup=1)
    step_ms = statistics.median(step_times)
    phase("mesh_train_step_1024x1024_spp64", gpu=gpu, launches=launches["mesh_train_step"],
          finite=True, plane_rows_0_3_zero=True, pad_slots_zero=int(pad.sum()),
          repeat_bitwise=True,
          replay_kernel_vs_twin_max_rel=rep_err, tolerance=f"rtol {SEG_TOL} (rows >= 0)",
          step_ms_median=step_ms, step_ms=step_times, step_peak_memory_bytes=peak_step,
          fwd_only_ms=mesh_ms, fwd_with_residuals_ms=fwd_res_ms,
          replay_ms=replay_ms, replay_twin_ms=replay_plain_ms,
          segsum_ms_per_step=seg_ms * MESH_CHUNKS, live_sample_bounces=mesh_live,
          image_vs_rebuild_from_residuals_max_rel=rebuild_err,
          rebuild_tolerance="rtol 1e-5 per pixel (f64 rebuild)", mesh_walk_ops=mesh_walk,
          dead_bounce_share=dead_share,
          residual_bytes=FULL_W * FULL_W * PT_SPP4 * BOUNCES * 32,
          msamples_per_s=FULL_W * FULL_W * PT_SPP4 / (step_ms * 1e-3) / 1e6)
    seg_row = {
        "name": "segsum", "route": "cuda", "source": SOURCE["segsum"],
        "replaces": REPLACES["segsum"], "run": RUN_OF["segsum"],
        "launches": launches[RUN_OF["segsum"]]["segsum"], "max_abs_err": real["max_abs_err"],
        "ms": seg_ms, "plain_ms": seg_plain_ms, **seg_bound, "library_ms": seg_lib_ms,
    }
    rows.append(seg_row)
    del loss_t, gp, ga, ge, train_step
    torch.cuda.empty_cache()

    # 22. Finite differences on the card (test_pallas_mesh_pt_tpu.py:127-
    # 180): float64, 32x32, spp4 8, bounces = rr_depth = 3, seed 11, the
    # mixed scene in chunks of 8.  At fixed Philox draws the estimator is
    # a polynomial of degree <= 3 in each leaf, so central differences
    # with h = 1e-4 are exact to ~1e-9 relative; the slot leaves ride in
    # the float32 row table, so their step is the realized float32 one.
    p64, cb64, sb64, t64, mats64, grid64 = mpt.mesh_pt_tables(
        mixed, device=dev, dtype=torch.float64, tris_per_chunk=8, supers_per=0)
    render64 = mf.make_render_pt_mesh_diff(
        cb64, sb64, t64[:, :16], t64[:, 22:24], width=32, height=32, spp4=8,
        materials=mats64, bounces=3, rr_depth=3, seed=11, **mpt.pt_tables_kwargs(grid64, dev))
    wgt = torch.tensor(np.random.RandomState(1).rand(3, 32 * 32), device=dev)
    leaves0 = (p64, t64[:, 16:19].double(), t64[:, 19:22].double())

    def loss64(*xs):
        return (wgt * render64(*xs)).sum()

    leaves = tuple(x.clone().requires_grad_(True) for x in leaves0)
    g64 = torch.autograd.grad(loss64(*leaves), leaves)
    require(float(g64[0][0:4].abs().max()) == 0.0, "FD setup: plane rows 0-3 not 0")

    def fd(which, idx, h=1e-4):
        plus = [x.clone() for x in leaves0]
        minus = [x.clone() for x in leaves0]
        plus[which][idx] += h
        minus[which][idx] -= h
        if which > 0:
            plus[which] = plus[which].float().double()
            minus[which] = minus[which].float().double()
        with torch.no_grad():
            return (float(loss64(*plus) - loss64(*minus))
                    / float(plus[which][idx] - minus[which][idx]))

    fd_rows = []
    for which, count in ((0, 3), (1, 2)):
        sel = g64[which].abs().clone()
        if which == 0:
            sel[0:4] = 0
        for _ in range(count):
            idx = np.unravel_index(int(sel.argmax()), tuple(sel.shape))
            sel[idx] = 0
            est = fd(which, idx)
            got = float(g64[which][idx])
            require(abs(got - est) <= 1e-6 * max(abs(est), 1e-2),
                    f"FD gate leaf {which} {idx}: grad {got} vs fd {est}")
            fd_rows.append({"leaf": ["planes", "slot_albedo"][which],
                            "index": [int(i) for i in idx], "grad": got, "fd": est,
                            "rel_err": abs(got - est) / max(abs(est), 1e-2)})
    phase("mesh_fd_gate_f64_32x32", tolerance="|grad - fd| <= 1e-6 x max(|fd|, 1e-2)",
          probes=fd_rows)

    # The training step's entry point: bench --mode mesh (fwd+bwd).
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_bench = bench.main(["--mode", "mesh"])
    train_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_bench == 0 and train_line["value"] > 0
            and train_line["detail"]["launches_per_step"]
            == {"mesh_pt": 1.0, "segsum": float(MESH_CHUNKS)},
            f"bench --mode mesh: {train_line}")
    phase("mesh_train_entry_points", bench=train_line, bench_fwd_only=mesh_line)
    torch.cuda.empty_cache()

    # ---- 22b-22d. camera gradients through the fused renderer
    # (diff/camera_fused; csrc/mesh_pt.cu with_camera) and the frame's
    # walk record (with_stats) ------------------------------------------
    # 22b. render_with_camera at the s4 cell (1024x1024 x 64 spp, 8
    # bounces, RR from 5), counted from zero: loss = mean(depth^2), its
    # gradient in pos, raw_dir and fov; then with the sphere planes and
    # the slot rows requiring grad as well.  The depth of sample layer 0
    # against a float64 brute-force first hit over the rays rebuilt from
    # suv: the gates of tests/test_camera_fused.py where the winners agree.
    ckw = dict(materials=m_mats, width=FULL_W, height=FULL_W, spp4=PT_SPP4, bounces=BOUNCES,
               rr_depth=PT_RR, **m_kw)
    n_s = m_planes.shape[1]

    def camera_step(tables_grad=False):
        params = {k: v.requires_grad_(True) for k, v in dcam.CameraParams(device=dev).items()}
        planes_in, t24_in = m_planes, m_t24
        if tables_grad:
            planes_in = m_planes.clone().requires_grad_(True)
            t24_in = m_t24.clone().requires_grad_(True)
        _, depth, (wid, _, suv) = dcf.render_with_camera(params, planes_in, m_cb, m_sb, t24_in,
                                                         **ckw)
        leaves = [*params.values(), *((planes_in, t24_in) if tables_grad else ())]
        return depth.detach(), wid, suv, torch.autograd.grad((depth * depth).mean(), leaves)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (depth_c, wid_c, suv_c, cgrads), launches["camera_step"] = counted(camera_step)
    peak_cam = torch.cuda.max_memory_allocated() - resident
    require(launches["camera_step"] == RUNS["camera_step"],
            f"camera step launches {launches['camera_step']}")
    require(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in cgrads),
            f"camera step: non-finite or zero gradients {cgrads}")
    mdev64 = mm.mesh_scene_to_device(ms, device=dev, dtype=torch.float64, use_bvh=False)
    cam64 = dcf.cam_vector(dcam.CameraParams(dtype=torch.float64, device=dev), FULL_W, FULL_W,
                           dtype=torch.float64)
    su, sv = suv_c[0, 0].double(), suv_c[1, 0].double()
    dd = torch.stack([su * cam64[6] + sv * cam64[7] + cam64[3], sv * cam64[8] + cam64[4],
                      sv * cam64[9] + cam64[5]], 1)
    d64 = dd / dd.norm(dim=1, keepdim=True)
    rays64 = torch.cat([cam64[0:3][None] + dd * cam64[10], d64], 1)
    bt, bkind, bid = (torch.cat(x) for x in zip(*(
        mm.first_hit_mesh(rays64[i:i + 16384], mdev64) for i in range(0, rays64.shape[0], 16384))))
    code = wid_c[0, 0].long()
    is_tri = code >= n_s
    slot = torch.where(is_tri, code - n_s, 0)
    agree = torch.where(code < 0, bkind == 0, torch.where(
        is_tri, (bkind == 2) & (fos[slot].long() == bid.long()),
        (bkind == 1) & (code == bid.long())))
    hit = (bkind > 0) & agree
    dep = depth_c[0].double()
    steep = hit & is_tri & ((m_t24[slot, 13:16].double() * d64).sum(dim=1).abs() > 0.1)
    r2w = m_planes[0].double()[code.clamp(0, n_s - 1)]
    small, wall = hit & ~is_tri & (r2w < 1e6), hit & ~is_tri & (r2w >= 1e6)

    def within(mask, rtol, atol=0.0):
        return bool(((dep[mask] - bt[mask]).abs() <= atol + rtol * bt[mask].abs()).all())

    brute_cam = {"samples": int(code.numel()), "winners_agree": float(agree.float().mean()),
                 "hit_share": float(hit.float().mean()), "steep_triangles": int(steep.sum()),
                 "small_spheres": int(small.sum()), "walls": int(wall.sum()),
                 "max_rel_err_steep": float(((dep - bt).abs() / bt.abs())[steep].max())}
    require(brute_cam["winners_agree"] >= 0.97 and brute_cam["hit_share"] > 0.9
            and min(brute_cam["steep_triangles"], brute_cam["small_spheres"],
                    brute_cam["walls"]) > 100, f"camera depth vs brute force: {brute_cam}")
    require(within(steep, 2e-3) and within(small, 2e-3) and within(wall, 2e-3, 0.25)
            and within(hit, 5e-2, 0.25) and bool((dep[code < 0] == 0).all()),
            f"camera depth vs brute force beyond the gates: {brute_cam}")
    del mdev64, rays64, bt, bkind, bid, dd, d64
    # The forward with and without suv, in turns (the card's clocks drift
    # over a run, so only neighbouring times compare).
    fwd_turns = {False: [], True: []}
    for cam_on in (False, True, True, False):
        fwd_turns[cam_on].append(med_ms(lambda: mpt.render_pt_mesh(
            m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, with_residuals=True,
            with_camera=cam_on, **full)[0], iters=3))
    fwd_cam_ms = statistics.median(fwd_turns[True])

    def depth_fwd_bwd():
        params = {k: v.requires_grad_(True) for k, v in dcam.CameraParams(device=dev).items()}
        d = dcf.primary_depth(params, wid_c[0], suv_c, m_t24[:, :16], m_planes, n_spheres=n_s,
                              width=FULL_W, height=FULL_W)
        return torch.autograd.grad((d * d).mean(), list(params.values()))

    depth_ms = med_ms(depth_fwd_bwd, iters=3)
    del depth_c, wid_c, suv_c
    torch.cuda.empty_cache()
    cam_step_ms = med_ms(lambda: camera_step()[3], iters=3)
    (_, _, _, tgrads), launches["camera_step_tables"] = counted(lambda: camera_step(True))
    require(launches["camera_step_tables"] == RUNS["camera_step_tables"],
            f"camera step with table grads: launches {launches['camera_step_tables']}")
    geo = [3, 4, 5, 12]  # the slot row floats the depth reads: normal and d0
    other = [j for j in range(tgrads[4].shape[1]) if j not in geo]
    require(all(bool(torch.isfinite(g).all()) for g in tgrads)
            and float(tgrads[3][0:4].abs().max()) > 0 and float(tgrads[3][4:].abs().max()) == 0
            and float(tgrads[4][:, geo].abs().max()) > 0
            and float(tgrads[4][:, other].abs().max()) == 0,
            "camera step with table grads: gradients not where the depth reads the tables")
    cam_tables_ms = med_ms(lambda: camera_step(True)[3], iters=3)
    del tgrads
    torch.cuda.empty_cache()
    phase("camera_path_1024x1024_spp64", gpu=gpu, launches=launches["camera_step"],
          launches_tables_grad=launches["camera_step_tables"], finite=True,
          grad_abs_max={k: float(g.abs().max()) for k, g in zip(("pos", "raw_dir", "fov"), cgrads)},
          depth_vs_brute_f64_layer0=brute_cam, fwd_with_camera_ms=fwd_turns[True],
          fwd_with_residuals_ms=fwd_turns[False], suv_bytes=2 * PT_SPP4 * FULL_W * FULL_W * 4,
          depth_fwd_bwd_ms=depth_ms, step_ms=cam_step_ms, step_tables_grad_ms=cam_tables_ms,
          step_peak_memory_bytes=peak_cam, chunked="no: one pass over the 64 layers",
          tolerance="winners agree >= 97%; steep triangles and small spheres rtol 2e-3, "
                    "walls 2e-3 + 0.25, all hits 5e-2 + 0.25")

    # 22c. The float64 finite-difference gate of tests/test_camera_fused.py
    # on the card: icosphere s2 in smallpt9 (chunks of 16), 32x32 x 4
    # samples, 2 bounces, RR from 2, zero uniforms (the JAX test's
    # interpret-mode u = 0); the kernel's winners and screen coordinates
    # frozen, h = 1e-6, all 7 coordinates within 1e-4.
    ms2 = mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=14.0, subdivisions=2), albedo=(0.85, 0.55, 0.2))
    t2 = mpt.mesh_pt_tables(ms2, device=dev, tris_per_chunk=16)
    _, _, (wid2, _, suv2) = dcf.render_with_camera(
        dcam.CameraParams(device=dev), *t2[:4], materials=t2[4], width=32, height=32, spp4=4,
        bounces=2, rr_depth=2, uniforms=torch.zeros((4, 2 + 3 * 2, 32 * 32), device=dev),
        **mpt.pt_tables_kwargs(t2[5], dev))
    g16_64, pl64 = t2[3][:, :16].double(), t2[0].double()

    def cam_loss(prm):
        d = dcf.primary_depth(prm, wid2[0], suv2, g16_64, pl64, n_spheres=pl64.shape[1],
                              width=32, height=32)
        return (d * d).mean() * 1e-4

    prm = {k: v.requires_grad_(True)
           for k, v in dcam.CameraParams(dtype=torch.float64, device=dev).items()}
    cg64 = dict(zip(prm, torch.autograd.grad(cam_loss(prm), list(prm.values()))))
    cam_fd = []
    for name, g in cg64.items():
        for ci in range(g.numel()):
            step = torch.zeros(g.numel(), dtype=torch.float64, device=dev)
            step[ci] = 1e-6
            step = step.reshape(g.shape)
            with torch.no_grad():
                est = (float(cam_loss({**prm, name: prm[name] + step}))
                       - float(cam_loss({**prm, name: prm[name] - step}))) / 2e-6
            got = float(g.reshape(-1)[ci])
            require(abs(got - est) <= 1e-10 + 1e-4 * abs(est),
                    f"camera FD gate {name}[{ci}]: grad {got} vs fd {est}")
            cam_fd.append({"leaf": name, "index": ci, "grad": got, "fd": est,
                           "rel_err": abs(got - est) / max(abs(est), 1e-300)})
    require(len(cam_fd) == 7, "camera FD gate: not 7 coordinates")
    phase("camera_fd_gate_f64_32x32", tolerance="|grad - fd| <= 1e-10 + 1e-4 |fd|",
          probes=cam_fd)
    del t2, wid2, suv2

    # 22d. The s4 frame with with_stats (cells of STATS_TILE pixels x one
    # layer, and of one warp's 32 pixels): per bounce the chunks (and
    # supers) some live path of a cell enters, beside the chunks one path
    # enters on average (phase 16's twin, 4 layers at full resolution).
    # Their ratio says how far a cell's paths walk different chunk lists.
    def stats_frame(tile):
        return mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, with_stats=True,
                                  stats_tile=tile, **full)

    img_s, ks = stats_frame(STATS_TILE)
    require(torch.equal(img_s, m_img), "with_stats changed the frame")
    require(tuple(ks.shape) == (3 * BOUNCES, FULL_W * FULL_W // STATS_TILE * PT_SPP4),
            f"kstats shape {tuple(ks.shape)}")
    stats_ms = statistics.median(bench.time_steps(lambda: stats_frame(STATS_TILE), iters=3,
                                                  warmup=0)[0])
    _, ks_warp = stats_frame(32)
    by_bounce = []
    for b in range(BOUNCES):
        per_ray = float(walk4[b, 1]) / max(int(walk4[b, 0]), 1)
        k_tile, k_warp = ks[b].float(), ks_warp[b].float()
        by_bounce.append({
            "bounce": b, "chunks_mean": float(k_tile.mean()), "chunks_max": int(ks[b].max()),
            "supers_mean": float(ks[BOUNCES + b].float().mean()),
            "warp_chunks_mean": float(k_warp.mean()), "warp_chunks_max": int(ks_warp[b].max()),
            "warp_cells_zero_share": float((ks_warp[b] == 0).float().mean()),
            "per_ray_chunks_mean_twin": per_ray, "rays_walked_twin": int(walk4[b, 0]),
            "ratio_tile_to_ray": float(k_tile.mean()) / per_ray if per_ray else None,
            "ratio_warp_to_ray": float(k_warp.mean()) / per_ray if per_ray else None})
    del img_s, ks, ks_warp
    torch.cuda.empty_cache()
    phase("mesh_stats_1024x1024_spp64", gpu=gpu, stats_tile=STATS_TILE,
          grid={"chunks": m_grid.n_chunks, "supers": m_grid.n_supers,
                "supers2": m_grid.n_supers2},
          frame_ms=mesh_ms, frame_with_stats_ms=stats_ms, by_bounce=by_bounce,
          twin_spp4=MESH_TWIN_SPP4)
    mesh_rows["mesh_pt"].update(ms_with_camera=fwd_cam_ms, ms_with_stats=stats_ms)

    # ---- 23-26. the bounce-loop mesh renderer (csrc/bvh.cu, csrc/wbvh.cu,
    # models/mesh, diff/mesh) --------------------------------------------
    # 23. The BVH kernel on the lockstep tables of the s4 cell (max_leaf
    # 64): the 4,194,304 camera rays and the 4,194,304 rays that leave
    # bounce 1 of the bounce-loop render (incoherent).  Kernel == twin
    # bitwise on the first BVH_SLICE rays of each; kernel vs the chunk
    # kernel and vs brute force on all rays: the same hit set, and the
    # same face (through tri_order and face_of_slot) and t within 1e-3 on
    # >= 99.99% of the hit rays (the chunk kernel's plane-form test is not
    # watertight; Moller-Trumbore ties at shared edges go to the first
    # face in leaf order, not the lowest face index).
    dev_lock = mm.mesh_scene_to_device(ms, device=dev, pallas_bvh_kernel=True,
                                       pallas_kernel="lockstep")
    b_tabs = dev_lock["pallas_bvh"]
    max_leaf = dev_lock["static"].max_leaf

    def lockstep_tables(tree):  # models/mesh's lockstep tables of a FlatBVH
        planes = tuple(tuple(c[tree.tri_order] for c in t)
                       for t in tri.triangle_planes(v_s4, ms.faces, dtype=np.float32))
        return bk.pack_bvh(tree, planes, dev)

    # The default route's tables are the native builder's; bvh.cu is also
    # timed on the NumPy builder's tree of the same mesh and leaf size.
    nat_tree = native.build_bvh_native(v_s4, ms.faces, max_leaf=max_leaf)
    require(all(torch.equal(a, b) for a, b in zip(lockstep_tables(nat_tree), b_tabs)),
            "bvh: the lockstep tables are not the native builder's")
    np_tree = bvh_mod.build_bvh(v_s4, ms.faces, max_leaf=max_leaf, backend="numpy")
    np_tabs = lockstep_tables(np_tree)
    tri_order = torch.tensor(nat_tree.tri_order, device=dev).long()
    rp_cam = convert.rays_planes_from_numpy(rays_np, device=dev)
    grabbed = []
    mesh_hit = mm._mesh_hit

    def grab(o3, d3, *args, **kwargs):  # keeps the rays of each bounce's query
        grabbed.append(torch.stack([*o3, *d3]).float().contiguous())
        return mesh_hit(o3, d3, *args, **kwargs)

    mm._mesh_hit = grab
    try:
        mm.render_pt_mesh(torch.tensor(rays_np, device=dev),
                          mm.mesh_scene_to_device(ms, device=dev, pallas_bvh_kernel=True),
                          bounces=2, rr_depth=PT_RR)
    finally:
        mm._mesh_hit = mesh_hit
    require(len(grabbed) == 2, f"bounce-loop render queried the mesh {len(grabbed)} times")
    rp_bounce1 = grabbed.pop()
    del grabbed
    if ab_names:
        ab_saved["bounce1_rays"] = rp_bounce1.cpu()
    # wbvh on the bounce-1 rays: kernel vs twin bitwise (tmin, slot,
    # attrs, counts) on all of them, and the walk its counts and the root
    # box (unbounded, as the kernel tests it) give the bound.
    eq_b1, (_, _, _, st_b1) = wbvh_pair(rp_bounce1, m_cb, m_sb, m_t24, None, attrs=True,
                                        **m_kw)
    require(eq_b1, "wbvh bounce-1 rays: kernel and twin differ")
    b1_grid = wk.plain_grid(m_cb, m_sb, torch.tensor(m_grid.ssboxes, device=dev).reshape(-1, 6),
                            m_t24, torch.float32, tris_per_chunk=m_grid.tris_per_chunk,
                            supers_per=m_grid.supers_per, supers2_per=m_grid.supers2_per)
    b1_roots = int(mpt.root_entries(b1_grid, tuple(rp_bounce1[0:3]),
                                    tuple(rp_bounce1[3:6])).sum())
    b1_walk = st_b1.long().sum(dim=1).tolist()
    del st_b1

    def face_ok(r, n):
        """brute_ok, and the same face on >= 99.99% of the n rays."""
        return brute_ok(r) and r["n_other_face"] <= 1e-4 * r["hit_frac"] * n

    bvh_sets = {}
    for name, rp in (("camera", rp_cam), ("bounce1", rp_bounce1)):
        tk, hk = bk.intersect_bvh(rp, *b_tabs, max_leaf=max_leaf)
        sl = rp[:, :BVH_SLICE].contiguous()
        walk_b = torch.zeros((2, BVH_SLICE), dtype=torch.int64, device=dev)
        twin_times, (tp, hp) = bench.time_steps(
            lambda: bk.intersect_bvh_plain(sl, *b_tabs, max_leaf=max_leaf, counts=walk_b),
            iters=1, warmup=0)
        require(torch.equal(tk[:BVH_SLICE], tp) and torch.equal(hk[:BVH_SLICE], hp),
                f"bvh {name}: kernel and twin differ on the first {BVH_SLICE} rays")
        tn, hn = bk.intersect_bvh(rp, *np_tabs, max_leaf=max_leaf)
        walk_n = torch.zeros((2, BVH_SLICE), dtype=torch.int64, device=dev)
        tpn, hpn = bk.intersect_bvh_plain(sl, *np_tabs, max_leaf=max_leaf, counts=walk_n)
        require(torch.equal(tn[:BVH_SLICE], tpn) and torch.equal(hn[:BVH_SLICE], hpn),
                f"bvh {name}, NumPy tables: kernel and twin differ on the first "
                f"{BVH_SLICE} rays")
        numpy_tables = {
            "kernel_ms": med_ms(lambda: bk.intersect_bvh(rp, *np_tabs, max_leaf=max_leaf)),
            "walk_slice": {"nodes": int(walk_n[0].sum()), "triangles": int(walk_n[1].sum()),
                           "nodes_max": int(walk_n[0].max())},
            "same_t_as_native_share": float((tn == tk).float().mean())}
        del tn, hn, tpn, hpn, walk_n
        bt, bf = (bt_cam, bf_cam) if name == "camera" else brute_first_hit(rp, v_s4, ms.faces)
        wk.queue_overflows()
        tw, sw = wk.intersect_chunks(rp, m_cb, m_sb, m_t24, **m_kw)
        torch.cuda.synchronize()
        wbvh_overflows = wk.queue_overflows()
        if name == "bounce1":  # the slots the xla-mesh gathers read at bounce 1
            hseg = sw.to(torch.int32).clone()
        # vs_brute maps hk to faces through tri_order
        res = {"vs_brute": vs_brute(tk, hk, tri_order, bt, bf),
               "vs_wbvh": vs_brute(tk, hk, tri_order, tw, fos[sw.long()])}
        n_r = rp.shape[1]
        require(face_ok(res["vs_brute"], n_r) and face_ok(res["vs_wbvh"], n_r),
                f"bvh {name}: {res}")
        bvh_sets[name] = {
            **res, "kernel_ms": med_ms(lambda: bk.intersect_bvh(rp, *b_tabs, max_leaf=max_leaf)),
            "wbvh_ms": med_ms(lambda: wk.intersect_chunks(rp, m_cb, m_sb, m_t24, **m_kw)),
            "wbvh_attrs_ms": med_ms(lambda: wk.intersect_chunks(rp, m_cb, m_sb, m_t24,
                                                                attrs=True, **m_kw)),
            "wbvh_queue_overflows_per_launch": wbvh_overflows,
            "twin_ms_slice": twin_times[0],
            "walk_slice": {"nodes": int(walk_b[0].sum()), "triangles": int(walk_b[1].sum()),
                           "nodes_max": int(walk_b[0].max())},
            "numpy_tables": numpy_tables}
        del tk, hk, tp, hp, tw, sw, bt, bf, walk_b
    n_b = rp_cam.shape[1]
    del rp, rp_cam, rp_bounce1, bt_cam, bf_cam
    torch.cuda.empty_cache()
    phase("bvh_kernel_vs_twin_and_brute", gpu=gpu, rays=n_b, slice=BVH_SLICE,
          nodes=dev_lock["pallas_bvh"][0].shape[0], max_leaf=max_leaf, builder="native",
          numpy_tree_nodes=np_tree.n_nodes,
          tri_order_differs=int((np_tree.tri_order != nat_tree.tri_order).sum()),
          tolerance="bitwise vs twin on the slice; vs brute and wbvh: same hit set; same "
          "face and t within 1e-3 on >= 99.99% of hit rays", **bvh_sets)

    # 24. The bounce-loop render at the JAX bench's xla-mesh cell (s4,
    # 1024x1024 x 4 samples = 4,194,304 rays, 8 bounces, RR from 5) with
    # the chunk kernel and with the BVH kernel, each counted from zero:
    # one traversal launch per bounce.  The per-pixel means of chunks
    # (seed 0), lockstep (seed 1) and the fused kernel at the same size
    # agree within 4 standard errors of their per-pixel differences.
    xla_img, xla_fwd = {}, {}
    for trav in ("chunks", "lockstep"):
        step, _ = bench.make_xla_mesh_step(ms, device=dev, traversal=trav, bounces=BOUNCES)
        run = f"xla_mesh_fwd_{trav}"
        (img, _), launches[run] = counted(step)
        require(launches[run] == RUNS[run], f"{run} launches {launches[run]}")
        require(bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0,
                f"{run}: non-finite or negative colors")
        if trav == "lockstep":
            img, _ = step()  # the next seed: independent of the chunks image
        xla_img[trav] = img.reshape(-1, 4, 3).mean(dim=1).T  # per-pixel means [3, W*H]
        xla_fwd[trav] = {"ms": statistics.median(bench.time_steps(step, iters=5, warmup=0)[0]),
                         "mean": float(img.mean())}
        del img, step
    fused4 = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=4, **full)

    def z_score(a, b):
        diff = (a - b).double()
        return float(diff.mean()) / (float(diff.std()) / diff[0].numel() ** 0.5)

    zs = {"chunks_vs_lockstep": z_score(xla_img["chunks"], xla_img["lockstep"]),
          "chunks_vs_fused": z_score(xla_img["chunks"], fused4),
          "lockstep_vs_fused": z_score(xla_img["lockstep"], fused4)}
    require(all(abs(z) < 4.0 for z in zs.values()), f"xla mesh image means: {zs}")
    phase("xla_mesh_fwd_1024x1024_spp4", gpu=gpu, launches={
        k: launches[f"xla_mesh_fwd_{k}"] for k in ("chunks", "lockstep")}, z=zs,
        fused_mean=float(fused4.mean()), finite=True, **xla_fwd,
        msamples_per_s={k: n_b / (v["ms"] * 1e-3) / 1e6 for k, v in xla_fwd.items()})
    del xla_img, fused4
    torch.cuda.empty_cache()

    # 25. Its fwd+bwd step (chunks, diff): sum of the colors, gradients to
    # vertices, face albedo and face emission through diff/mesh; eager
    # autograd keeps every bounce's graph (no checkpointing).
    train, _ = bench.make_xla_mesh_step(ms, device=dev, traversal="chunks", bounces=BOUNCES,
                                        fwd_only=False)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (loss_x, grads_x), launches["xla_mesh_train_step"] = counted(train)
    peak_x = torch.cuda.max_memory_allocated() - resident
    require(launches["xla_mesh_train_step"] == RUNS["xla_mesh_train_step"],
            f"xla mesh train step launches {launches['xla_mesh_train_step']}")
    require(bool(torch.isfinite(loss_x)) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in grads_x),
        "xla mesh train step: non-finite or zero gradients")
    grad_max = dict(zip(("vertices", "face_albedo", "face_emission"),
                        (float(g.abs().max()) for g in grads_x)))
    del loss_x, grads_x
    train_times, _ = bench.time_steps(train, iters=3, warmup=0)
    # _hist_kernel's own row: segment_rows_matmul as the gathers' backward
    # calls it (models/mesh._GatherPlanes: eight planes per launch, the
    # slot of each ray, slot 0 on a miss) on the bounce-1 slots of phase
    # 23 (4,194,304 rows) with seeded cotangents, against its twin and
    # index_add_; two launches bitwise equal.
    del train
    matmul = segk.segment_rows_matmul
    hslots = m_t24.shape[0]
    hvals = torch.randn((segk.MAX_ROWS, hseg.shape[0]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    if ab_names:
        ab_saved["gather"] = (hseg.cpu(), hvals.cpu(), hslots)
    require(torch.equal(matmul(hseg, hvals, n_slots=hslots), matmul(hseg, hvals, n_slots=hslots)),
            "segment_rows_matmul on the gather stream: two launches differ")
    href = segk.segment_rows_plain(hseg, hvals.double(), n_slots=hslots)
    hmag = segk.segment_rows_plain(hseg, hvals.double().abs(), n_slots=hslots)
    require(bool(((matmul(hseg, hvals, n_slots=hslots).double() - href).abs()
                  <= SEG_TOL * hmag).all()), "segment_rows_matmul on the gather stream vs twin")
    hist_ms = med_ms(lambda: matmul(hseg, hvals, n_slots=hslots))
    hist_plain_ms = med_ms(lambda: segk.segment_rows_plain(hseg, hvals, n_slots=hslots), iters=5)
    h_idx = torch.where((hseg >= 0) & (hseg < hslots), hseg, hslots).long()
    h_src = hvals.T.contiguous()
    h_acc = torch.zeros((hslots + 1, hvals.shape[0]), dtype=hvals.dtype, device=dev)
    hist_lib_ms = med_ms(lambda: h_acc.index_add_(0, h_idx, h_src))
    n_h, r_h = hseg.shape[0], hvals.shape[0]
    seg_row.update(matmul_rows=n_h, matmul_planes=r_h, matmul_slots=hslots, matmul_ms=hist_ms,
                   matmul_plain_ms=hist_plain_ms, matmul_library_ms=hist_lib_ms,
                   **{f"matmul_{k}": v for k, v in bound(
                       n_h * (4 + r_h * hvals.element_size()) + hslots * r_h * 8,
                       n_h * r_h).items()})
    del hseg, hvals, href, hmag, h_idx, h_src, h_acc
    torch.cuda.empty_cache()

    # Finite differences on the card (tests/test_mesh_grad.py:50-84):
    # float64 brute force, 24x24 camera rays, icosphere s1 (r 12) in
    # smallpt9, 4 bounces, the Philox stream (seed 7): the largest face
    # albedo and emission gradients of the mean radiance (rtol 1e-5) and
    # vertex gradients of the first-hit depth (rtol 1e-4).
    fd_ms = mm.MeshScene.cornell_with_mesh(*meshes.icosphere(
        center=(50, 40, 60), radius=12.0, subdivisions=1), albedo=(0.6, 0.5, 0.4))
    fd_dev = mm.mesh_scene_to_device(fd_ms, device=dev, dtype=torch.float64, use_bvh=False)
    fd_params = dmesh.mesh_params(fd_ms, torch.float64, device=dev)
    fd_faces = torch.tensor(fd_ms.faces, device=dev)
    fd_rays = torch.tensor(camera.generate_rays_numpy(24, 24, 1, seed=0), device=dev)

    def radiance(p):
        return dmesh.render_pt_mesh_params(fd_rays, p, fd_dev, fd_faces, bounces=4,
                                           seed=7).mean()

    def depth(p):
        d = dmesh.depth_aov_params(fd_rays, p, fd_dev, fd_faces)
        return (d * (d < 1e19).double()).sum()

    fd_rows = []
    for loss_fn, name, count, rtol, atol in ((radiance, "face_albedo", 2, 1e-5, 1e-10),
                                             (radiance, "face_emission", 2, 1e-5, 1e-10),
                                             (depth, "vertices", 3, 1e-4, 1e-8)):
        leaves = {k: v.clone().requires_grad_(k == name) for k, v in fd_params.items()}
        (g,) = torch.autograd.grad(loss_fn(leaves), (leaves[name],))
        for fi in torch.argsort(g.abs().flatten(), descending=True)[:count].tolist():
            idx = divmod(fi, 3)
            plus = {k: v.clone() for k, v in fd_params.items()}
            minus = {k: v.clone() for k, v in fd_params.items()}
            plus[name][idx] += 1e-6
            minus[name][idx] -= 1e-6
            with torch.no_grad():
                est = (float(loss_fn(plus)) - float(loss_fn(minus))) / 2e-6
            got = float(g[idx])
            require(abs(got - est) <= atol + rtol * abs(est),
                    f"xla FD gate {name} {idx}: grad {got} vs fd {est}")
            fd_rows.append({"leaf": name, "index": list(idx), "grad": got, "fd": est,
                            "rel_err": abs(got - est) / max(abs(est), 1e-300)})
    phase("xla_mesh_train_step", gpu=gpu, launches=launches["xla_mesh_train_step"],
          finite=True, grad_max=grad_max, checkpoint="none (eager autograd)",
          step_ms_median=statistics.median(train_times), step_ms=train_times,
          step_peak_memory_bytes=peak_x,
          gather_segsum={k: v for k, v in seg_row.items() if k.startswith("matmul_")},
          msamples_per_s=n_b / (statistics.median(train_times) * 1e-3) / 1e6,
          fd_gate_f64_24x24=fd_rows, fd_tolerance="face attributes rtol 1e-5, vertices 1e-4")

    # 26. Entry points: cli render of a mesh scene with --renderer plain
    # (one chunk-kernel launch per bounce), the selftest (phase 17, 7 of
    # 7), and the xla-mesh bench fwd+bwd, --fwd-only and --traversal
    # lockstep --fwd-only; lockstep fwd+bwd is refused (exit 2).
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, cli_launches = counted(lambda: cli.main(
                ["render", "--scene", "mesh-icosphere", "--mode", "pt", "--renderer", "plain",
                 "--backend", "cuda", "--width", "256", "--height", "256", "--samples", "4",
                 "--bounces", str(BOUNCES), "--check-finite", "--out", tmp]))
        xla_cli = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rc == 0 and (Path(tmp) / "color.ppm").exists()
                and cli_launches == {**_NONE, "wbvh": BOUNCES},
                f"cli mesh render --renderer plain: {xla_cli}, launches {cli_launches}")
    xla_bench = {}
    for label, argv, want in (
            ("fwd+bwd", [], {"wbvh": float(BOUNCES), "segsum": 4.0 * BOUNCES - 2}),
            ("fwd_only", ["--fwd-only"], {"wbvh": float(BOUNCES)}),
            ("lockstep_fwd_only", ["--traversal", "lockstep", "--fwd-only"],
             {"bvh": float(BOUNCES)})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_bench = bench.main(["--mode", "mesh", "--renderer", "xla", *argv])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rc_bench == 0 and line["value"] > 0
                and line["detail"]["launches_per_step"] == want,
                f"bench --mode mesh --renderer xla {argv}: {line}")
        xla_bench[label] = line
    with contextlib.redirect_stderr(io.StringIO()):
        rc_refused = bench.main(["--mode", "mesh", "--renderer", "xla", "--traversal",
                                 "lockstep"])
    require(rc_refused == 2, f"lockstep fwd+bwd bench: exit {rc_refused}, expected 2")
    phase("xla_mesh_entry_points", cli_render=xla_cli, cli_launches=cli_launches,
          selftest="7 of 7 (phase 17)", bench=xla_bench, lockstep_fwd_bwd_exit=rc_refused)

    # The BVH kernel's row: launches of the lockstep render, kernel ms on
    # the bounced rays (the render's bounces 1-7) and on the camera rays,
    # the twin's ms on its slice, the bound at the bounced rays: bytes of
    # rays, outputs and tables; box and triangle tests from the twin's walk
    # on its slice, scaled to all rays.
    walk_b1 = bvh_sets["bounce1"]["walk_slice"]
    n_nodes, n_tris = b_tabs[0].shape[0], b_tabs[2].shape[0]
    rows.append({
        "name": "bvh", "route": "cuda", "source": SOURCE["bvh"], "replaces": REPLACES["bvh"],
        "run": RUN_OF["bvh"], "launches": launches[RUN_OF["bvh"]]["bvh"],
        "max_abs_err": 0.0, "ms": bvh_sets["bounce1"]["kernel_ms"],
        "ms_camera_rays": bvh_sets["camera"]["kernel_ms"],
        "ms_numpy_tables": {k: bvh_sets[k]["numpy_tables"]["kernel_ms"]
                            for k in ("bounce1", "camera")},
        "plain_ms": bvh_sets["bounce1"]["twin_ms_slice"], "plain_rays": BVH_SLICE,
        **bound(n_b * (24 + 8) + 36 * (n_nodes + n_tris),
                (walk_b1["nodes"] * BOX_OPS + walk_b1["triangles"] * TRI_OPS) * n_b / BVH_SLICE),
        "bound_ops_from": f"the twin's node and triangle tests on the first {BVH_SLICE} "
                          f"bounce-1 rays, x {n_b} / {BVH_SLICE}",
        "library_ms": None, "library": "none: no single PyTorch call traverses a BVH",
    })
    # The chunk kernel's bounce-1 numbers beside its camera row: ms with
    # attrs, the bound from the kernel's own counts over all the rays and
    # the rays entering the root box.
    mesh_rows["wbvh"].update(
        ms_bounce1_rays=bvh_sets["bounce1"]["wbvh_attrs_ms"], bounce1_walk=b1_walk,
        bounce1_root_entries=b1_roots,
        **{f"bounce1_{k}": v for k, v in bound(
            n_b * (24 + 8 + 44), walk_ops(b1_walk, n_b, m_grid, roots=b1_roots)).items()})

    # ---- the wavefront renderers (models/wavefront) ---------------------
    # Their runs' launches go into the rows of the kernels they launch
    # (wavefront_launches), and the segment-sum's numbers at the image
    # scatter's shapes into its row (wavefront_*).
    torch.cuda.empty_cache()
    wave = wavefront_phases(dev, gpu, kernel_mods)
    for row in rows:
        if row["name"] in ("wbvh", "bvh", "segsum"):
            row["wavefront_launches"] = {run: n[row["name"]] for run, n in
                                         wave["launches"].items() if row["name"] in n}
    seg_row.update({f"wavefront_{k}": v for k, v in wave["segsum"].items()})
    torch.cuda.empty_cache()

    # ---- the sharded port (parallel/) -----------------------------------
    # Worlds of 1, 2 and 4 ranks on this card; their launches a rank go
    # into the rows of the kernels they run (sharded_launches).
    sharded = parallel_phases(dev, gpu)
    for row in rows:
        if row["name"] in sharded:
            row["sharded_launches"] = sharded[row["name"]]
    torch.cuda.empty_cache()

    # ---- debug dumps ----------------------------------------------------
    # Each kernel's debug instantiation prints, with device printf, the
    # lines its plain twin prints from torch (both read back from fd 1),
    # and leaves every output of the debug-off launch bit for bit:
    # render_pt.cu at cornell8's 1024 x 1024 x 64 samples, wbvh.cu on the
    # 4,194,304 camera rays against the s4 grid in tiles of 1,024 rays (the
    # JAX test's tile: 4,096 lines), mesh_pt.cu at the s4 cell; cells of
    # 2,048 pixels (the Pallas wrappers' tile) of sample layer 0.  Layer 0's
    # paths do not depend on spp4 (Philox keys by pixel and layer), so the
    # full frames' lines equal the twins' at 4 samples.
    import ctypes

    libc = ctypes.CDLL(None)
    dump_labels = ("pt_pallas alive", "wbvh tile worklist k", "mesh_pt worklist k",
                   "mesh_pt alive")

    def dumped(fn):
        """fn()'s result and the dump lines written to fd 1 meanwhile."""
        sys.stdout.flush()
        with tempfile.TemporaryFile() as f:
            saved = os.dup(1)
            os.dup2(f.fileno(), 1)
            try:
                out = fn()
                torch.cuda.synchronize()
                sys.stdout.flush()
                libc.fflush(None)
            finally:
                os.dup2(saved, 1)
                os.close(saved)
            f.seek(0)
            text = f.read().decode()
        return out, [ln for ln in text.splitlines() if ln.partition(": ")[0] in dump_labels]

    def dumped_ms(fn):
        """Median ms of fn over 5 runs (their dump lines discarded)."""
        return statistics.median(dumped(lambda: bench.time_steps(fn, iters=5, warmup=1)[0])[0])

    dumps = {}
    planes_c, mats_c = pt_inputs("cornell8")
    d_pt = dict(width=FULL_W, height=FULL_W, bounces=BOUNCES, rr_depth=PT_RR)
    off_pt = ptk.render_pt(planes_c, mats_c, spp4=PT_SPP4, **d_pt)
    ptk.reset_launches()
    on_pt, k_pt = dumped(lambda: ptk.render_pt(planes_c, mats_c, spp4=PT_SPP4, debug=True,
                                               **d_pt))
    require(ptk.LAUNCHES == {"pt": 1}, f"debug render_pt launches {ptk.LAUNCHES}")
    _, k_pt4 = dumped(lambda: ptk.render_pt(planes_c, mats_c, spp4=4, debug=True, **d_pt))
    _, t_pt4 = dumped(lambda: ptk.render_pt_plain(planes_c, mats_c, spp4=4, debug=True,
                                                  **d_pt))
    require(len(k_pt) == BOUNCES and k_pt == k_pt4 == t_pt4,
            f"render_pt dump: kernel {k_pt} / {k_pt4}, twin {t_pt4}")
    require(torch.equal(on_pt, off_pt), "render_pt: the debug image differs")
    dumps["render_pt"] = {"lines": k_pt, "image_bitwise_vs_debug_off": True,
                          "ms_debug_on": dumped_ms(lambda: ptk.render_pt(
                              planes_c, mats_c, spp4=PT_SPP4, debug=True, **d_pt)),
                          "ms_debug_off": dumped_ms(lambda: ptk.render_pt(
                              planes_c, mats_c, spp4=PT_SPP4, **d_pt))}
    del planes_c, mats_c, off_pt, on_pt

    _, rp_d = rays_planes(FULL_W)
    off_w = wk.intersect_chunks(rp_d, m_cb, m_sb, m_t24, attrs=True, **m_kw)
    wk.reset_launches()
    on_w, k_w = dumped(lambda: wk.intersect_chunks(rp_d, m_cb, m_sb, m_t24, attrs=True,
                                                   debug=True, debug_tile=1024, **m_kw))
    require(wk.LAUNCHES == {"wbvh": 1}, f"debug wbvh launches {wk.LAUNCHES}")
    _, t_w = dumped(lambda: wk.intersect_chunks_plain(rp_d, m_cb, m_sb, m_t24, debug=True,
                                                      debug_tile=1024, **m_kw))
    require(len(k_w) == rp_d.shape[1] // 1024 and k_w == t_w,
            f"wbvh dump: {len(k_w)} kernel lines, {len(t_w)} twin lines, equal {k_w == t_w}")
    require(torch.equal(on_w[0], off_w[0]) and torch.equal(on_w[1], off_w[1])
            and all(torch.equal(a, b) for a, b in zip(on_w[2], off_w[2])),
            "wbvh: the debug outputs differ")
    k_vals = [int(ln.partition(": ")[2]) for ln in k_w]
    dumps["wbvh"] = {"lines": len(k_w), "first_lines": k_w[:4], "k_min": min(k_vals),
                     "k_max": max(k_vals), "k_mean": statistics.mean(k_vals),
                     "outputs_bitwise_vs_debug_off": True,
                     "ms_debug_on": dumped_ms(lambda: wk.intersect_chunks(
                         rp_d, m_cb, m_sb, m_t24, attrs=True, debug=True, debug_tile=1024,
                         **m_kw)),
                     "ms_debug_off": dumped_ms(lambda: wk.intersect_chunks(
                         rp_d, m_cb, m_sb, m_t24, attrs=True, **m_kw))}
    del rp_d, off_w, on_w

    d_mesh = dict(materials=m_mats, width=FULL_W, height=FULL_W, bounces=BOUNCES,
                  rr_depth=PT_RR, **m_kw)
    off_m = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, **d_mesh)
    mpt.reset_launches()
    on_m, k_m = dumped(lambda: mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4,
                                                  debug=True, **d_mesh))
    require(mpt.LAUNCHES == {"mesh_pt": 1}, f"debug mesh_pt launches {mpt.LAUNCHES}")
    _, k_m4 = dumped(lambda: mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=4,
                                                debug=True, **d_mesh))
    _, t_m4 = dumped(lambda: mpt.render_pt_mesh_plain(m_planes, m_cb, m_sb, m_t24, spp4=4,
                                                      debug=True, **d_mesh))
    require(len(k_m) == 2 * BOUNCES and k_m == k_m4 == t_m4,
            f"mesh_pt dump: kernel {k_m} / {k_m4}, twin {t_m4}")
    require(torch.equal(on_m, off_m), "mesh_pt: the debug image differs")
    dumps["mesh_pt"] = {"lines": k_m, "image_bitwise_vs_debug_off": True,
                        "ms_debug_on": dumped_ms(lambda: mpt.render_pt_mesh(
                            m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, debug=True, **d_mesh)),
                        "ms_debug_off": dumped_ms(lambda: mpt.render_pt_mesh(
                            m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, **d_mesh))}
    del off_m, on_m
    torch.cuda.empty_cache()
    phase("debug_dumps", gpu=gpu, debug_tile={"render_pt": 2048, "wbvh": 1024,
                                             "mesh_pt": 2048}, **dumps,
          tolerance="the kernel's lines equal the twin's; outputs bitwise vs debug off")

    # The A/B against --parent: AB_SCRIPT from each tree in turns (parent,
    # new, new, parent) on the inputs saved above; the means of each
    # tree's two turns.
    ab = {"not measured": "no --parent"} if parent is None else {
        name: "sources differ; AB_SCRIPT has no frame for it" for name in ab_untimed}
    if ab_names:
        torch.cuda.empty_cache()  # the other processes need the card's memory
        with tempfile.TemporaryDirectory() as tmp:
            saved = str(Path(tmp) / "ab_inputs.pt")
            torch.save(ab_saved, saved)
            del ab_saved
            runs = {"parent": [], "new": []}
            for who in ("parent", "new", "new", "parent"):
                runs[who].append(json.loads(run_in_tree(
                    parent if who == "parent" else REPO, AB_SCRIPT, [saved, *ab_names], 900)))
        turns = {who: [r["ms"] for r in rs] for who, rs in runs.items()}
        ab.update({name: {"parent_ms": statistics.mean(t[name] for t in turns["parent"]),
                          "ms": statistics.mean(t[name] for t in turns["new"]),
                          "turns": {who: [t[name] for t in ts] for who, ts in turns.items()}}
                   for name in turns["new"][0]})
        # Each tree's outputs repeat bit for bit in its two turns, and the
        # reference kernels' outputs (colors, idx, gradients) equal the
        # parent's bit for bit: the redesign keeps every operation.
        digests = {who: rs[0]["digests"] for who, rs in runs.items()}
        require(all(rs[0]["digests"] == rs[1]["digests"] for rs in runs.values()),
                "A/B: a tree's outputs differ between its two turns")
        differ = sorted(k for k in digests["new"] if digests["parent"].get(k) != digests["new"][k])
        require(not differ, f"A/B: outputs differ from the parent's: {differ}")
        ab["digests_equal_parent"] = sorted(digests["new"])
        flips = {who: rs[0]["facts"].get("trail_differs_share") for who, rs in runs.items()}
        if flips["new"] is not None:
            require(flips["parent"] is None or flips["new"] <= flips["parent"],
                    f"A/B: the share of rays whose trail differs from the twin's rose: {flips}")
            ab["trail_differs_share"] = flips
    for name, frame in (("pt", "render_pt"), ("mesh_pt", "mesh_pt"), ("wbvh", "wbvh"),
                        ("segsum", "segsum_replay"), ("bvh", "bvh_bounce1"),
                        ("fwd", "ref_fwd"), ("fwd_idx", "ref_fwd_idx"),
                        ("bwd_replay", "ref_bwd_replay"), ("bwd_recompute", "ref_bwd_recompute")):
        if isinstance(ab.get(frame), dict):
            next(r for r in rows if r["name"] == name)["parent_ms"] = ab[frame]["parent_ms"]
    phase("ab_vs_parent", gpu=gpu, parent=None if parent is None else str(parent),
          kernels=ab_names, frames=ab)

    # The ceiling probes timed again, late in the process, beside their
    # early reading (phase ceilings): does the card slow down?
    late = ceiling_retime(dev, ceil_n)
    phase("ceilings_late", gpu=gpu, early=ceil_early, late=late,
          late_over_early={k: late[k] / ceil_early[k] for k in ("fma_chain_ms", "copy_ms")})

    rows += ceil_rows
    for row in rows:
        row.update(bound_measured(row, ceil_model))
    print(gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
