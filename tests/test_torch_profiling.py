"""The port's ``utils/profiling`` against the JAX package's: the three
scripted-clock cases of ``tests/test_profiling.py`` (a non-positive round
discarded, exhaustion flagged with the conservative fallback), the whole
``benchmark_fit`` dict key for key under one scripted clock, ``mrays``
and ``roofline``; and the port's fences, round trip, ``benchmark`` and
``trace`` on the CPU.  ``tests/test_torch_cuda.py`` holds
``benchmark_fit`` against CUDA events on a card."""

import json

import pytest
import torch

from ascendpathtracing_tpu.utils import profiling as jax_profiling
from ascendpathtracing_tpu_torch.utils import profiling


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class _ScriptedStep:
    """fn(i) that advances the fake clock; durations drawn from
    ``schedule`` (a list consumed call by call, the last value
    repeating)."""

    def __init__(self, clock, schedule):
        self.clock = clock
        self.schedule = list(schedule)

    def __call__(self, i):
        d = self.schedule.pop(0) if len(self.schedule) > 1 else self.schedule[0]
        self.clock.now += d
        return None


def _hermetic(monkeypatch, module):
    clock = _FakeClock()
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(module, "device_fence", lambda out: 0.0)
    return clock


@pytest.fixture
def fake_clock(monkeypatch):
    return _hermetic(monkeypatch, profiling)


def test_fit_constant_step_agrees(fake_clock):
    fn = _ScriptedStep(fake_clock, [2e-3])
    fit = profiling.benchmark_fit(fn, iters=2, warmup=1)
    assert fit["fit_ok"] is True
    assert fit["step_s"] == pytest.approx(2e-3, rel=1e-9)


def test_fit_discards_nonpositive_slope_round(fake_clock):
    # warmup(1), then batch(2) at 10 ms a call = 20 ms vs batch(6) at 1 ms
    # a call = 6 ms -> a negative slope -> the round is DISCARDED (k
    # doubles) and the later constant-2 ms rounds converge.
    sched = [1e-3] + [10e-3] * 2 + [1e-3] * 6 + [2e-3]
    fn = _ScriptedStep(fake_clock, sched)
    fit = profiling.benchmark_fit(fn, iters=2, warmup=1)
    assert fit["fit_ok"] is True
    assert fit["step_s"] == pytest.approx(2e-3, rel=1e-9)
    assert fit["step_s"] > 1e-6  # a clamp would have published 1e-12


def _exhausting(clock, module, monkeypatch):
    """Every pair's first batch slow and its second fast, so t2 < t1 in
    every round; the phase toggles at each batch's one fence."""
    costs = {0: 10e-3, 1: 0.5e-3}
    state = {"phase": 1}  # the warm-up's fence flips it to 0 before t1

    def scripted(i):
        clock.now += costs[state["phase"]]

    monkeypatch.setattr(module, "device_fence",
                        lambda out: state.update(phase=1 - state["phase"]) or 0.0)
    return scripted


def test_fit_exhaustion_flags_and_falls_back(fake_clock, monkeypatch):
    scripted = _exhausting(fake_clock, profiling, monkeypatch)
    fit = profiling.benchmark_fit(scripted, iters=2, warmup=1, max_rounds=3)
    assert fit["fit_ok"] is False
    # last round: k = 8, t2 = 24 * 0.5 ms -> the fallback 0.5 ms
    assert fit["step_s"] == pytest.approx(0.5e-3, rel=1e-9)


SCHEDULES = {
    "constant": [2e-3],
    "noisy_first_round": [1e-3] + [10e-3] * 2 + [1e-3] * 6 + [2e-3],
    "drifting": [3e-3, 1e-3, 2e-3, 4e-3, 2.5e-3] * 40 + [2e-3],
}


@pytest.mark.parametrize("name", [*SCHEDULES, "exhausting"])
def test_fit_dict_equals_jax(monkeypatch, name):
    """The same scripted steps through both modules: every key equal."""
    out = {}
    for module in (profiling, jax_profiling):
        clock = _hermetic(monkeypatch, module)
        if name == "exhausting":
            fn = _exhausting(clock, module, monkeypatch)
        else:
            fn = _ScriptedStep(clock, SCHEDULES[name])
        out[module] = module.benchmark_fit(fn, iters=2, warmup=1, max_rounds=3)
    assert out[profiling] == out[jax_profiling]
    assert set(out[profiling]) == {"step_s", "overhead_s", "rel_spread", "iters", "rounds",
                                   "fit_ok", "fenced_batches"}


@pytest.mark.parametrize("n,s,b,sph", [(4_194_304, 0.8e-3, 8, 8), (1, 0.0, 1, 1),
                                       (12345, 2.5, 3, 9)])
def test_mrays_and_roofline_equal_jax(n, s, b, sph):
    assert profiling.mrays(n, s) == jax_profiling.mrays(n, s)
    assert profiling.roofline(n, b, sph) == jax_profiling.roofline(n, b, sph)


def test_device_fence_on_cpu_tensors():
    assert profiling.device_fence(torch.arange(5.0)) == 10.0
    assert profiling.device_fence({"a": [torch.tensor([True, True, False])],
                                   "b": torch.ones(3)}) == 2.0
    assert profiling.device_fence((None, 3, "x")) == 0.0


def test_fetch_rtt_names_its_device():
    assert profiling.fetch_rtt(iters=3, device="cpu") > 0.0
    assert profiling.fetch_rtt(iters=2, device=torch.device("cpu")) > 0.0
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        profiling.fetch_rtt()


def test_benchmark_on_the_output_device():
    x = torch.ones(1024)
    res = profiling.benchmark(lambda a, k: a * k, x, k=2.0, iters=3)
    assert set(res) == {"mean_s", "iters", "fence_rtt_s"}
    assert res["iters"] == 3 and res["mean_s"] > 0 and res["fence_rtt_s"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64)
    with profiling.trace(str(tmp_path / "t")) as d:
        (x * 3).sum()
    assert d == str(tmp_path / "t")
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)
