"""The command's refusals: no result without a CUDA device or without
the program, and the card run itself (marked ``cuda``)."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

ARGS = ["--workload", "cornell8.render", "--seed", "2147483701", "--seconds", "2"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "-m", "perfbench.run", *ARGS, *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=900, check=False)


def test_refuses_without_the_card_or_the_program(tmp_path):
    if not torch.cuda.is_available():
        out = _run(ROOT, "--trace", "0")
        assert out.returncode != 0 and out.stdout == ""
        assert "CUDA" in out.stderr
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_card_run_prints_the_result_line(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(ROOT, "--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace == "1":
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"render_msamples_per_s", "frame_ms_p95", "setup_s"}
