"""What every cell's run shares: finding its files by name, the set-up
clock, the traced stretch of the window, the per-layer readers and the
result line.

A traffic kind (``perfbench/traffic/<kind>.py``) defines ``run(r: Run)
-> Outcome``: it makes the inputs, warms up, calls ``r.setup_done()``,
measures for ``r.seconds`` (calling ``r.tracer`` around its iterations),
then checks its outputs against the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time

from perfbench import inputs, trace

ROOT = inputs.ROOT
BENCHMARK = ROOT.parent / "BENCHMARK.json"
#: Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "ascendpathtracing_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name``: its workload and configuration files and the
    metrics ``BENCHMARK.json`` gives it."""
    bench = benchmark if benchmark is not None else json.loads(BENCHMARK.read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = inputs.load_json("workloads", name)
    config = inputs.load_json("configs", entries[0]["config"])
    if workload["config"] != entries[0]["config"] or workload["traffic"] != entries[0]["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, workload, config, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def build(names) -> None:
    """Builds the program's CUDA libraries ``names`` through its own
    ``ops/build`` (cached in the checkout's ``build/``)."""
    from ascendpathtracing_tpu_torch.ops import build as program_build

    program_build.build_all(names)


def traffic(kind: str):
    """``perfbench/traffic/<kind>.py``."""
    return importlib.import_module(f"perfbench.traffic.{kind}")


def load_by_path(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT.parent)}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Check:
    """One number compared: its value and its limit (at most)."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a traffic loop hands back.  ``metrics`` holds every
    end-to-end value it measured (the cell reports those BENCHMARK.json
    gives it); ``context`` what its per-layer readers read."""
    metrics: dict
    attempted: int
    failed: int
    checks: dict
    context: dict


class Tracer:
    """The profiled stretch of a window.  With tracing on, iterations
    [0, lead) run untraced (the host spans and the untraced wall time
    come from them), then the profiler starts (its start-up is slow, and
    it slows the host even once stopped) and iterations [lead, lead + n)
    run under it."""

    def __init__(self, on: bool, lead: int, n: int, device):
        self.on, self.lead, self.n, self.device = on, lead, n, device
        self.prof = None
        self.t0 = self.wall_s = self.lead_s = None
        self.count = 0

    def untraced(self, i: int) -> bool:
        """Whether iteration i runs before the profiler starts."""
        return not self.on or i < self.lead

    def before(self, i: int, window_t0: float) -> None:
        if not self.on or i != self.lead:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.lead_s = time.perf_counter() - window_t0
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def holds(self, i: int) -> bool:
        """Whether iteration i has to wait to be submitted: it is the
        first after the traced stretch, which has not ended yet (so that
        the stretch holds its iterations and no other)."""
        return self.on and i == self.lead + self.n and self.wall_s is None

    def after(self, i: int) -> None:
        if self.on and self.lead <= i < self.lead + self.n:
            self.count += 1
            if i == self.lead + self.n - 1:
                self.stop()

    def stop(self) -> None:
        """Ends the traced stretch with a synchronise; its events are read
        in :meth:`summary`, after the window."""
        if self.prof is None or self.wall_s is not None:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """busy and wall seconds of the traced stretch, its device events
        (start-relative, seconds), the breakdown, and the untraced wall
        seconds an iteration before it."""
        if self.wall_s is None:
            return {}
        dev_us, host_us = trace.profiler_events(self.prof)
        t0 = min([a for _, a, _ in dev_us + host_us], default=0.0)
        dev = [(n, (a - t0) * 1e-6, (b - t0) * 1e-6) for n, a, b in dev_us]
        host = [(n, (a - t0) * 1e-6, (b - t0) * 1e-6) for n, a, b in host_us]
        iv = [(a, b) for _, a, b in dev]
        end = max([b for _, _, b in dev + host], default=0.0)
        return {
            "iterations": self.count,
            "untraced_s_per_iteration": self.lead_s / self.lead if self.lead else None,
            "busy_s": trace.busy(iv),
            "window_s": self.wall_s,
            "device_events": dev,
            "breakdown": {
                "device_ops": trace.by_name(dev),
                "idle_gaps": trace.label_gaps(trace.gaps(iv, 0.0, end), host),
            },
        }


class Run:
    """One run of a cell."""

    def __init__(self, cell: Cell, *, seed: int, seconds: float, trace_on: bool, device,
                 t_start: float, size: dict | None = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on, self.device, self.t_start = trace_on, device, t_start
        self.config, self.workload = cell.config, dict(cell.workload, **(size or {}))
        self.setup_s = None

    def setup_done(self) -> None:
        """Ends set-up: everything the window needs is built and warm."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start

    def tracer(self) -> Tracer:
        return Tracer(self.trace_on, int(self.workload["trace_after"]),
                      int(self.workload["trace_iterations"]), self.device)


def per_layer(cell: Cell, context: dict) -> dict:
    """The cell's per-layer metrics whose readers find something."""
    out = {}
    for m in cell.per_layer:
        value = load_by_path("metrics", m["name"]).read(context)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def result(cell: Cell, run: Run, outcome: Outcome, device_info: dict) -> dict:
    """The result line's object; the checks come last."""
    if run.trace_on:
        metrics = per_layer(cell, outcome.context)
    else:
        values = dict(outcome.metrics, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {
        "correct": all(c.ok for c in outcome.checks.values()),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_info,
    }
    tr = outcome.context.get("trace") or {}
    if run.trace_on and tr:
        out["device"] = dict(device_info, busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = tr["breakdown"]
    out["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in outcome.checks.items()}
    return out


def millions_per_s(units: float, seconds: float) -> float:
    """A rate over a whole window: every unit completed in it over its
    wall time, in millions a second."""
    return units / seconds / 1e6


def p95(values) -> float:
    """The 95th percentile of all the values (linear interpolation)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), 95))


def worst(values) -> float:
    """The largest of the values, NaN counting as infinite."""
    return max(v if v == v else float("inf") for v in values)


def kept_leaves(ref_grad_norms: dict) -> list:
    """The leaves compared: those whose reference gradient is at least a
    thousandth of the median leaf's (a leaf whose gradient is nought to
    rounding moves by round-off alone)."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def norm_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's |prog norm - ref norm| / max(ref norm, the median
    leaf's ref norm), over ``keys``; ``prog`` and ``ref`` map leaves to
    norms."""
    med = statistics.median(ref.values())
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}
