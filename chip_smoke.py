"""Smoke test of the PyTorch/CUDA port (``ascendpathtracing_tpu_torch``) on
one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (all four
libraries at once), checks each against its plain PyTorch twin (and the
NumPy oracle) on the card, drives the main path once through the user
entry points (the differentiable render at 4,194,304 rays x 8 bounces of
cornell8, its forward, and the CLI, selftest and bench), then the fused
path tracer (cornell8, 1024 x 1024 pixels x 64 samples, 8 bounces, RR
from 5) through the bench's step, then the mesh path: the chunk-grid
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
finite-difference gate, and its CLI and bench entry points.  Right after
the build it runs the card-only tests (tests/test_torch_cuda.py) in a
pytest subprocess without the repository's conftest.  It proves
through the launch counters, reset
before each run, that each path went through its kernels, and times
kernels, plain versions and, where one PyTorch call computes the same
function, that call (``library_ms``) with CUDA events.  One line per
phase; the first failed check raises and the script exits non-zero.
Before the last line it prints the card's name and power limit
(nvidia-smi) and one JSON object with a row per kernel (its ``launches``
are counted in the run its ``run`` field names; ``bound_ms`` is the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s,
reckoned from this run's inputs); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
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
# Registers of the fused mesh kernel's instantiations without stats, as
# the build log showed them before the camera and stats outputs existed:
# those outputs must leave them as they were.
MESH_REGS_BEFORE = {"f32_forward": 75, "f64_forward": 106, "f32_residuals": 80,
                    "f64_residuals": 114}
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


def mesh_kernel_registers(log: str) -> dict:
    """The fused mesh kernel's registers by instantiation: {"<f32|f64>_
    <forward|residuals|camera>[_stats]": registers}."""
    out = {}
    for name, n in registers_by_kernel(log).items():
        if "render_pt_mesh_kernel" not in name:
            continue
        sink = ("camera" if "CameraResiduals" in name else
                "forward" if "NoResiduals" in name else "residuals")
        key = f"{'f32' if 'render_pt_mesh_kernelIf' in name else 'f64'}_{sink}"
        out[key + ("_stats" if "CellStats" in name else "")] = n
    return out


def bound(nbytes, ops) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM_BPS and the operations over FP32_OPS."""
    b_ms, o_ms = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return ({"bound_ms": b_ms, "bound_by": "bytes"} if b_ms >= o_ms
            else {"bound_ms": o_ms, "bound_by": "operations"})


def walk_ops(counts, n_rays, grid) -> int:
    """Operations of a chunk-grid walk: each ray tests the top level's
    boxes, each box it hits its children's boxes, each chunk it enters
    that chunk's triangles.  ``counts`` = (chunks tested, supers hit,
    super-supers hit) summed over the rays."""
    chunks, supers, supers2 = counts
    if grid.n_supers2:
        boxes = n_rays * grid.n_supers2 + supers2 * grid.supers2_per + supers * grid.supers_per
    elif grid.n_supers:
        boxes = n_rays * grid.n_supers + supers * grid.supers_per
    else:
        boxes = n_rays * grid.n_chunks
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
              "required", file=sys.stderr)
        return 1

    import numpy as np

    from ascendpathtracing_tpu_torch import bench, cli, convert
    from ascendpathtracing_tpu_torch.device import gpu_name_and_power_limit
    from ascendpathtracing_tpu_torch import camera, oracle, scenes
    from ascendpathtracing_tpu_torch.accel import meshes
    from ascendpathtracing_tpu_torch.accel import bvh as bvh_mod
    from ascendpathtracing_tpu_torch.accel import tri
    from ascendpathtracing_tpu_torch.diff import camera as dcam
    from ascendpathtracing_tpu_torch.diff import camera_fused as dcf
    from ascendpathtracing_tpu_torch.diff import mesh as dmesh
    from ascendpathtracing_tpu_torch.diff import mesh_fused as mf
    from ascendpathtracing_tpu_torch.models import mesh as mm
    from ascendpathtracing_tpu_torch.ops import build, chunk_grid
    from ascendpathtracing_tpu_torch.ops import bvh_kernels as bk
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

    # ---- 1. build (all six libraries at once) --------------------------
    t0 = time.time()
    libs = ("render_ref", "render_pt", "wbvh", "mesh_pt", "segsum", "bvh")
    build.build_all(libs)
    kernel_mods = (rk, ptk, wk, mpt, segk, bk)
    for mod in kernel_mods:
        mod.load_library()
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
    mesh_regs = mesh_kernel_registers(build.library_path("mesh_pt").with_suffix(".log")
                                      .read_text())
    require(len(mesh_regs) == 12 and all(mesh_regs[k] == v for k, v in MESH_REGS_BEFORE.items()),
            f"fused mesh kernel registers {mesh_regs}, expected {MESH_REGS_BEFORE} unchanged")
    require(mesh_regs["f32_camera"] <= 80,  # three blocks of 256 threads per SM (MinBlocks)
            f"float camera kernel at {mesh_regs['f32_camera']} registers, more than 80")
    phase("build", seconds=build_s, gpu=gpu, torch=torch.__version__,
          cuda=torch.version.cuda, ptxas=regs, mesh_pt_registers=mesh_regs,
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
    # spheres); reference mode runs every bounce of every ray.
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
        })
        torch.cuda.empty_cache()
    phase("kernel_times_4M_8bounce", gpu=gpu,
          **{r["name"]: {"ms": r["ms"], "plain_ms": r["plain_ms"]} for r in rows})

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
    require(rc_self == 0, f"cli selftest failed:\n{buf.getvalue()}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_bench = bench.main([])
    bench_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_bench == 0 and bench_line["value"] > 0
            and bench_line["detail"]["launches_per_step"] == {"fwd_idx": 1.0, "bwd_replay": 1.0},
            f"bench: {bench_line}")
    phase("entry_points", cli_render=stats, selftest="PASS", bench=bench_line)
    del rp, idx, g1, calls
    torch.cuda.empty_cache()

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

    del planes, mats, rays4m
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
    walk4 = torch.zeros((BOUNCES, 4), dtype=torch.int64, device=dev)  # a row per bounce
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
    require(rc_self == 0 and self_lines[-1]["passed"] == 7 and self_lines[-1]["ran"] == 7
            and self_launches["wbvh"] == 5 and self_launches["segsum"] >= 1
            and self_lines[5]["check"] == "mesh_pt_fused_energy_vs_xla" and self_lines[5]["ok"]
            and self_lines[6]["check"] == "mesh_fused_vjp_grads" and self_lines[6]["ok"],
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
    mesh_ms = statistics.median(bench.time_steps(
        lambda: mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, **full),
        iters=10, warmup=1)[0])
    mesh_plain_ms = statistics.median(twin_times)
    m_samples = FULL_W * FULL_W * PT_SPP4
    phase("mesh_times", gpu=gpu, wbvh_4M_ms=wbvh_ms, wbvh_twin_4M_ms=wbvh_plain_ms,
          mesh_pt_ms=mesh_ms, mesh_pt_msamples_per_s=m_samples / (mesh_ms * 1e-3) / 1e6,
          mesh_twin_ms=mesh_plain_ms,
          mesh_twin_size=f"{FULL_W}x{FULL_W}x{MESH_TWIN_SPP4}", twin_runs=len(twin_times))
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
    mesh_rows["wbvh"].update(bound(n_cam * (24 + 8 + 44), walk_ops(wbvh_walk, n_cam, m_grid)))
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
    mesh_walk = walk_ops(walk_all[1:].tolist(), int(walk_all[0]), m_grid) * mesh_live / twin_live4
    mesh_rows["mesh_pt"].update(bound(12 * FULL_W * FULL_W,
                                      mesh_live * (SPHERE_OPS * 9 + PT_SHADE_OPS)
                                      + FULL_W * FULL_W * PT_SPP4 * CAM_OPS + mesh_walk))
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
    tri_order = torch.tensor(bvh_mod.build_bvh(v_s4, ms.faces, max_leaf=max_leaf).tri_order,
                             device=dev).long()
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
        bt, bf = (bt_cam, bf_cam) if name == "camera" else brute_first_hit(rp, v_s4, ms.faces)
        tw, sw = wk.intersect_chunks(rp, m_cb, m_sb, m_t24, **m_kw)
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
            "twin_ms_slice": twin_times[0],
            "walk_slice": {"nodes": int(walk_b[0].sum()), "triangles": int(walk_b[1].sum()),
                           "nodes_max": int(walk_b[0].max())}}
        del tk, hk, tp, hp, tw, sw, bt, bf, walk_b
    n_b = rp_cam.shape[1]
    del rp, rp_cam, rp_bounce1, bt_cam, bf_cam
    torch.cuda.empty_cache()
    phase("bvh_kernel_vs_twin_and_brute", gpu=gpu, rays=n_b, slice=BVH_SLICE,
          nodes=dev_lock["pallas_bvh"][0].shape[0], max_leaf=max_leaf,
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
        "plain_ms": bvh_sets["bounce1"]["twin_ms_slice"], "plain_rays": BVH_SLICE,
        **bound(n_b * (24 + 8) + 36 * (n_nodes + n_tris),
                (walk_b1["nodes"] * BOX_OPS + walk_b1["triangles"] * TRI_OPS) * n_b / BVH_SLICE),
        "library_ms": None, "library": "none: no single PyTorch call traverses a BVH",
    })

    print(gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
