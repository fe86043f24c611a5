"""The readings that a data-parallel fit cell's limits are set from, on
its cards: the program's runs over many seeds (the lower readings) and
the control or a planted fault in its place (the upper ones,
``perfbench/faults_dp.py``), every run on one world of ranks.

    python3 -m perfbench.control_dp --workload cornell8.fit.dp4
        --modes program,control,exchange --seeds 11,12,13 [--seconds 2] [--warmup 2]

Prints one JSON line a mode and seed: the compared numbers and whether
the run came out correct.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import harness

MODES = ("program", "control", "unchanged", "half", "altered", "exchange")


def readings(cell: str, modes, seeds, seconds: float, device=None, size=None):
    """Runs the cell once a mode and seed -> [(mode, seed, {check: value},
    correct), ...]."""
    from perfbench.traffic import fit_dp

    c = harness.load_cell(cell)
    device = device or torch.device("cuda", 0)
    plan = [(mode, seed) for mode in modes for seed in seeds]
    runs = [harness.Run(c, seed=seed, seconds=seconds, trace_on=False, device=device,
                        t_start=time.perf_counter(),
                        size=dict(size or {}, fault=None if mode == "program" else mode))
            for mode, seed in plan]
    out = []
    for (mode, seed), res in zip(plan, fit_dp.run_jobs(runs)):
        out.append((mode, seed, {k: v.value for k, v in res.checks.items()},
                    all(v.ok for v in res.checks.values())))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--warmup", type=int, default=None,
                   help="warm-up steps (default: the cell's); the check does not read them")
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    unknown = set(modes) - set(MODES)
    if unknown:
        p.error(f"unknown modes {sorted(unknown)}; expected some of {MODES}")
    chips = int(harness.load_cell(args.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench.control_dp: the cell needs {chips} CUDA devices", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    seeds = [int(s) for s in args.seeds.split(",")]
    size = {} if args.warmup is None else {"warmup_steps": args.warmup}
    for mode, seed, checks, ok in readings(args.workload, modes, seeds, args.seconds, size=size):
        print(json.dumps({"cell": args.workload, "mode": mode, "seed": seed, "checks": checks,
                          "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
