"""The window arithmetic: a rate from the window's totals, the p95 over
all frames, and a stall that moves both; and the render loop driven by a
stand-in frame on the CPU."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.traffic import render

TINY = dict(width=8, height=8, spp4=4, check_pixels=8, check_frames=2, trace_iterations=2,
            warmup_frames=1)


def test_rate_is_totals_over_the_window():
    assert harness.millions_per_s(3_000_000, 1.5) == pytest.approx(2.0)
    # A stall adds wall time and no work: the rate falls by its share.
    assert harness.millions_per_s(3_000_000, 1.5 + 0.5) == pytest.approx(1.5)


def test_p95_over_all_frames_moves_with_a_tail():
    base = [10.0] * 100
    assert harness.p95(base) == pytest.approx(10.0)
    stalled = base[:90] + [100.0] * 10
    assert harness.p95(stalled) == pytest.approx(100.0)
    assert harness.p95([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(4.8)


def _run(stall_every, monkeypatch, in_flight=1, trace_on=False, seconds=0.5, profiled=None):
    def make_frame(cfg, wl, dev):
        n = {"i": 0}

        def frame(seed):
            n["i"] += 1
            if profiled is not None and torch.autograd.profiler._is_profiler_enabled:
                profiled.append(n["i"])
            time.sleep(0.03 if stall_every and n["i"] % stall_every == 0 else 0.002)
            return torch.zeros((3, wl["width"] * wl["height"]))
        return frame

    monkeypatch.setattr(render, "make_frame", make_frame)
    cell = harness.load_cell("cornell8.render")
    r = harness.Run(cell, seed=7, seconds=seconds, trace_on=trace_on,
                    device=torch.device("cpu"), t_start=time.perf_counter(),
                    size=dict(TINY, in_flight=in_flight))
    return render.run(r)


@pytest.mark.parametrize("in_flight", [1, 2])
def test_injected_stall_moves_rate_and_p95(monkeypatch, in_flight):
    smooth = _run(0, monkeypatch, in_flight)
    stalled = _run(4, monkeypatch, in_flight)
    samples = 8 * 8 * 4
    for out in (smooth, stalled):
        # Every frame of the window counts, over the whole window.
        rate = out.metrics["render_msamples_per_s"]
        assert out.attempted * samples / rate / 1e6 == pytest.approx(0.5, abs=0.1)
    assert stalled.metrics["render_msamples_per_s"] < 0.5 * smooth.metrics["render_msamples_per_s"]
    assert stalled.metrics["frame_ms_p95"] >= 30.0 > smooth.metrics["frame_ms_p95"]
    # An all-black frame is not the scene: the check says so.
    assert not smooth.checks["frame_rel_l1"].ok



@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_traced_stretch_holds_its_frames_alone(monkeypatch, in_flight):
    """With frames in flight, the frame after the traced stretch waits
    until the stretch has ended, so the profiler sees exactly
    ``trace_iterations`` frames; the host spans are the frames before it."""
    monkeypatch.setitem(TINY, "trace_after", 3)
    profiled = []
    out = _run(0, monkeypatch, in_flight, trace_on=True, seconds=3.0, profiled=profiled)
    assert out.context["trace"]["iterations"] == TINY["trace_iterations"]
    # Frames are counted from 1 and the warm-up frame comes first.
    assert profiled == [2 + 3 + k for k in range(TINY["trace_iterations"])]
    assert len(out.context["host_ms"]) == 3
    assert out.attempted > 3 + TINY["trace_iterations"]
