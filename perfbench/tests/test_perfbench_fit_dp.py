"""The data-parallel fit (``perfbench/traffic/fit_dp.py``) on four gloo
ranks on the CPU at a tiny size, through its launcher
(``perfbench/world.py``: rank 0 in the process, ranks 1-3 spawned): the
program's run comes out correct with ``replica_gap`` 0, the control and
every planted fault do not; a run whose rank fails, hangs or loads a
module named ``jax`` ends with exit code 4, no result and that rank's
log, and leaves no process behind; the cell on four cards (marked
``cuda``)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from perfbench import harness, spans, world

CELL = "cornell8.fit.dp4"
SIZE = dict(width=32, height=32, passes=2, warmup_steps=2, trace_after=1, trace_iterations=2,
            loss_every=1)
SEED = 2 ** 31 + 23
MODES = ["program", "control", "unchanged", "half", "altered", "exchange"]

READINGS = """
import json, sys, torch
from perfbench import control_dp
out = control_dp.readings("cornell8.fit.dp4", sys.argv[2].split(","), [int(sys.argv[3])], 0.2,
                          device=torch.device("cpu"), size=json.loads(sys.argv[1]))
print(json.dumps(out))
"""

LAUNCH = """
import json, sys, time, torch
from perfbench import harness
from perfbench.traffic import fit_dp
c = harness.load_cell("cornell8.fit.dp4")
r = harness.Run(c, seed=5, seconds=0.2, trace_on=True, device=torch.device("cpu"),
                t_start=time.perf_counter(), size=json.loads(sys.argv[1]))
out = fit_dp.run_jobs([r], stall_s=float(sys.argv[2]))[0]
assert not harness.forbidden_modules(), harness.forbidden_modules()
print(json.dumps(out.context["counts"]))
for r.trace_on in (False, True):
    print(json.dumps(harness.result(c, r, out, {})))
"""


def _python(tmp_path, code, *args, timeout=300):
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         env=dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=timeout, check=False)
    return out, time.monotonic() - t


def _left_behind(tmp_path):
    """Processes whose command line names a file under ``tmp_path``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if str(tmp_path).encode() in f.read():
                    found.append(pid)
        except OSError:
            pass
    return found


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Every mode, one after another on one world."""
    out, _ = _python(tmp_path_factory.mktemp("world"), READINGS, json.dumps(SIZE),
                     ",".join(MODES), str(SEED), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {mode: (checks, ok) for mode, _, checks, ok in
            json.loads(out.stdout.strip().splitlines()[-1])}


def test_program_is_correct_and_replicas_equal(readings):
    checks, ok = readings["program"]
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap", "replica_gap"}
    assert ok and checks["replica_gap"] == 0.0, checks


@pytest.mark.parametrize("mode", MODES[1:])
def test_control_and_faults_are_not_correct(readings, mode):
    checks, ok = readings[mode]
    assert not ok, checks


def test_an_exchange_left_out_trips_replica_or_grad_gap(readings):
    checks, _ = readings["exchange"]
    assert checks["replica_gap"] > 0 or checks["grad_gap"] > 0.1


def test_launcher_runs_rank_zero_here(tmp_path):
    out, _ = _python(tmp_path, LAUNCH, json.dumps(SIZE), str(world.STALL_S))
    assert out.returncode == 0, out.stderr[-3000:]
    counts, e2e, traced = map(json.loads, out.stdout.strip().splitlines()[-3:])
    assert counts["rays"] == 2 * 32 * 32 * 4 // 4 and counts["ranks"] == 4
    assert e2e["correct"] and e2e["checks"]["replica_gap"]["value"] == 0.0
    assert list(e2e)[-1] == "checks" and e2e["failed"] == 0
    assert set(e2e["metrics"]) == {"fit_mrays_per_s", "peak_mem_gib", "setup_s"}
    assert "host_ms.fit" in traced["metrics"] and traced["correct"]
    assert not _left_behind(tmp_path)
    assert not [p for p in os.listdir(tmp_path) if p.startswith("perfbench_world_")]


@pytest.mark.parametrize("fault", ["crash", "hang", "jax"])
def test_a_failed_or_hung_rank_ends_the_run(tmp_path, fault):
    out, seconds = _python(tmp_path, LAUNCH, json.dumps(dict(SIZE, fault=fault)), "10")
    assert out.returncode == world.EXIT_RANK_FAILED and out.stdout == ""
    tail = out.stderr[-2000:]
    assert "rank 3 of 4" in tail and "rank 3's log" in tail
    if fault == "crash":
        assert "planted fault" in tail
    elif fault == "hang":
        assert "passed no phase for 10 s" in tail and seconds < 120
    else:
        assert "rank 3 loaded modules that must not load: jax" in tail
    time.sleep(0.5)
    assert not _left_behind(tmp_path)
    assert not [p for p in os.listdir(tmp_path) if p.startswith("perfbench_world_")]


def test_all_reduce_reader_reads_its_span():
    read = harness.load_by_path("metrics", "all_reduce_ms.fit").read
    ops = [["ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0, 0.002,
            ["apt.train_step", "apt.train_step.all_reduce"]],
           ["CatArrayBatchedCopy", 0.003, 0.004, ["apt.train_step", "apt.train_step.all_reduce"]],
           ["render_ref_fwd_kernel", 0.004, 0.010, ["apt.train_step", "apt.kernel.fwd_idx"]]]
    ctx = {"trace": {"iterations": 2, "spans": {"spans": [["apt.train_step", 1, 0.0, 0.01]],
                                                 "ops": ops, "waits": []}}}
    assert read(ctx) == pytest.approx(1.5)
    assert read({"trace": {}}) is None
    assert spans.span_ms(ctx, "apt.train_step.all_reduce") == read(ctx)


def test_trainer_reader_leaves_out_nccl():
    read = harness.load_by_path("metrics", "trainer_torch_ms.dp").read
    events = [["void (anonymous namespace)::render_ref_fwd_kernel<float, true, 8>(float const*)",
               0.0, 0.004],
              ["void at::native::vectorized_elementwise_kernel<4, add>(int)", 0.004, 0.005],
              ["ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
               0.005, 0.006],
              ["nccl:all_reduce", 0.005, 0.0061],
              ["Memcpy DtoD (Device -> Device)", 0.0061, 0.0063]]
    ctx = {"trace": {"iterations": 2, "device_events": events}}
    assert read(ctx) == pytest.approx(0.6)
    whole = harness.load_by_path("metrics", "trainer_torch_ms").read(ctx)
    assert whole == pytest.approx(1.65)
    assert read({"trace": {"iterations": 2}}) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_four_card_run_prints_the_result_line(trace):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELL, "--seed",
                          "2147483713", "--seconds", "3", "--trace", trace], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200, check=False)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["checks"]["replica_gap"]["value"] == 0.0
    assert line["device"]["count"] == 4
    if trace == "1":
        assert {"all_reduce_ms.fit", "idle_share.fit", "host_ms.fit", "trainer_torch_ms.dp",
                "render_ref_fwd_idx_roofline",
                "render_ref_bwd_replay_roofline"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"fit_mrays_per_s", "peak_mem_gib", "setup_s"}
