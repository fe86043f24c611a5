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
icosphere in smallpt9) through the bench's mesh step and the CLI.  It
proves through the launch counters, reset before each run, that each path
went through its kernels, and times kernels and plain versions with CUDA
events.  One line per phase; the first failed check raises and the script
exits non-zero.  Before the last line it prints the card's name and power
limit (nvidia-smi) and one JSON object with a row per kernel (its
``launches`` are counted in the run its ``run`` field names); the last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

FULL_W = 1024  # 1024 x 1024 x 4 = 4,194,304 rays, the main path's size
BOUNCES = 8
PT_SPP4, PT_RR = 64, 5  # the fused path tracer's cell: 1024 x 1024 x 64
MESH_SUBDIV = 4  # the mesh cell: icosphere s4, 5,120 triangles, 16 per chunk
MESH_TWIN_SPP4 = 4  # the mesh twin's samples at full resolution (1/16 of the cell)
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
}
REPLACES = {  # launch counter -> the TPU kernel it replaces
    "fwd": f"{PALLAS}:41",
    "fwd_idx": f"{PALLAS}:638",
    "bwd_replay": f"{PALLAS}:787",
    "bwd_recompute": f"{PALLAS}:923",
    "pt": f"{PALLAS}:226",
    "wbvh": "ascendpathtracing_tpu/ops/pallas_wbvh.py:528",
    "mesh_pt": "ascendpathtracing_tpu/ops/pallas_mesh_pt.py:111",
}
# The user-facing runs, each counted from zero, and the launches each
# must make.  ``train_step`` is the main path (fwd + replay bwd); the
# inference render runs the forward without residual, and the
# replay=False training step the recompute backward (phase 6).
# ``pt_step`` is one step of the bench's fused path-tracing cell (phase
# 12); ``first_hit_mesh`` the mesh first-hit query in chunks mode and
# ``mesh_step`` one step of the bench's mesh cell (phase 17).
_NONE = dict.fromkeys(SOURCE, 0)
RUNS = {
    "train_step": {**_NONE, "fwd_idx": 1, "bwd_replay": 1},
    "inference_render": {**_NONE, "fwd": 1},
    "train_step_recompute": {**_NONE, "fwd": 1, "bwd_recompute": 1},
    "pt_step": {**_NONE, "pt": 1},
    "first_hit_mesh": {**_NONE, "wbvh": 1},
    "mesh_step": {**_NONE, "mesh_pt": 1},
}
RUN_OF = {  # kernel -> the run whose count its row reports
    "fwd": "inference_render",
    "fwd_idx": "train_step",
    "bwd_replay": "train_step",
    "bwd_recompute": "train_step_recompute",
    "pt": "pt_step",
    "wbvh": "first_hit_mesh",
    "mesh_pt": "mesh_step",
}


class SmokeFailure(RuntimeError):
    pass


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
              "required", file=sys.stderr)
        return 1

    import numpy as np

    from ascendpathtracing_tpu_torch import bench, cli, convert
    from ascendpathtracing_tpu_torch.device import gpu_name_and_power_limit
    from ascendpathtracing_tpu_torch.host import camera, meshes, oracle, scenes
    from ascendpathtracing_tpu_torch.accel import tri
    from ascendpathtracing_tpu_torch.models import mesh as mm
    from ascendpathtracing_tpu_torch.ops import build, chunk_grid
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

    # ---- 1. build (all four libraries at once) -------------------------
    t0 = time.time()
    libs = ("render_ref", "render_pt", "wbvh", "mesh_pt")
    build.build_all(libs)
    for mod in (rk, ptk, wk, mpt):
        mod.load_library()
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
    phase("build", seconds=build_s, gpu=gpu, torch=torch.__version__,
          cuda=torch.version.cuda, ptxas=regs,
          f64_spill_bytes={k: v for k, v in f64_spills.items() if v != (0, 0)})
    print(gpu, flush=True)

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
        for mod in (rk, ptk, wk, mpt):
            mod.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, {**rk.LAUNCHES, **ptk.LAUNCHES, **wk.LAUNCHES, **mpt.LAUNCHES}

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
    rows = []
    for name, (ker, plain) in calls.items():
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "run": RUN_OF[name],
            "launches": launches[RUN_OF[name]][name],
            "max_abs_err": max_err[name], "ms": med_ms(ker),
            "plain_ms": med_ms(plain),
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
    require(rc_bench == 0 and bench_line["value"] > 0, f"bench: {bench_line}")
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
            and pt_line["detail"]["launches_per_step"] == 1.0, f"bench --mode pt: {pt_line}")
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
    phase("pt_times", gpu=gpu, kernel_ms=pt_ms,
          kernel_msamples_per_s=samples / (pt_ms * 1e-3) / 1e6,
          twin_ms=plain_ms, twin_runs=len(plain_times), plain_estimator_4M=est)
    rows.append({
        "name": "pt", "route": "cuda", "source": SOURCE["pt"],
        "replaces": REPLACES["pt"], "run": RUN_OF["pt"],
        "launches": launches[RUN_OF["pt"]]["pt"], "max_abs_err": pt_err,
        "ms": pt_ms, "plain_ms": plain_ms,
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
    brute4m = vs_brute(tk, hk, fos, *brute_first_hit(rp_cam, v_s4, ms.faces))
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
    # full-sample twin takes minutes): with seed 0 against the kernel at
    # the same 4 samples for the error, and with seed 1 as an independent
    # run whose mean must be within 4 standard errors (of the per-pixel
    # difference, both images' noise) of the kernel's 64-sample mean.
    full = dict(materials=m_mats, width=FULL_W, height=FULL_W, bounces=BOUNCES,
                rr_depth=PT_RR, **m_kw)
    m_img = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=PT_SPP4, **full)
    require(bool(torch.isfinite(m_img).all()) and float(m_img.min()) >= 0.0,
            "mesh_pt full size: non-finite or negative pixels")
    k4 = mpt.render_pt_mesh(m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4, **full)
    twin_times, p4 = bench.time_steps(lambda: mpt.render_pt_mesh_plain(
        m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4, **full), iters=1, warmup=0)
    mesh_err = float((k4 - p4).abs().max())
    share4 = rel_share(k4, p4, 1e-5)
    require(share4 >= 0.99, f"mesh_pt full resolution vs twin, same seed: share {share4}")
    t1_times, p1 = bench.time_steps(lambda: mpt.render_pt_mesh_plain(
        m_planes, m_cb, m_sb, m_t24, spp4=MESH_TWIN_SPP4, seed=1, **full), iters=1, warmup=0)
    twin_times += t1_times
    diff = (m_img - p1).double()
    se = float(diff.std()) / diff[0].numel() ** 0.5
    z_mesh = float(diff.mean()) / se
    require(abs(z_mesh) < 4.0, f"mesh_pt full size: kernel mean vs twin (seed 1) at {z_mesh} SE")
    phase("mesh_pt_full_1024x1024_spp64", mean=float(m_img.mean()), min=float(m_img.min()),
          twin_spp4=MESH_TWIN_SPP4, max_abs_err_vs_twin_spp4=mesh_err,
          bitwise_vs_twin_spp4=bool(torch.equal(k4, p4)),
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
        rc_bench = bench.main(["--mode", "mesh"])
    mesh_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc_bench == 0 and mesh_line["value"] > 0
            and mesh_line["detail"]["launches_per_step"] == 1.0, f"bench --mode mesh: {mesh_line}")
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
    require(rc_self == 0 and self_lines[-1]["passed"] == 5 and self_launches["wbvh"] == 1,
            f"cli selftest: {self_lines}, launches {self_launches}")
    phase("mesh_entry_points_counted", first_hit_mesh=launches["first_hit_mesh"],
          triangle_pixels=int(tri_px.sum()), mesh_step=launches["mesh_step"],
          bench=mesh_line, cli_render=mesh_cli, selftest_check5=self_lines[4],
          selftest_launches=self_launches)
    del out_mesh, ft, fk, fh, tc, hc, dev_chunks

    # 18. Times: wbvh kernel (10 runs) vs twin (3) at 4,194,304 camera
    # rays with attrs, as first_hit_mesh calls it; mesh_pt kernel (10
    # runs) at the full size; its twin at phase 16's size (2 runs, above).
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
    for name, err, ms_k, ms_p in (("wbvh", wbvh_err, wbvh_ms, wbvh_plain_ms),
                                  ("mesh_pt", mesh_err, mesh_ms, mesh_plain_ms)):
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "run": RUN_OF[name],
            "launches": launches[RUN_OF[name]][name], "max_abs_err": err,
            "ms": ms_k, "plain_ms": ms_p,
        })

    print(gpu_name_and_power_limit(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
