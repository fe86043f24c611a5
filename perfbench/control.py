"""The readings that the check's limits are set from, on the chip: the
program's own runs over many seeds (the lower readings) and the control
or a planted fault in its place (the upper ones), in one process.

    python3 -m perfbench.control --workload <cell> --mode program|control|unchanged|half|altered
        --seeds 11,12,13 [--seconds 2]

Prints one JSON line a seed: the compared numbers and whether the run
came out correct.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from perfbench import faults, harness


def readings(cell: str, mode: str, seeds, seconds: float, device=None, size=None):
    """Runs the cell once a seed with ``mode`` in place -> [(seed,
    {check: value}, correct), ...]."""
    c = harness.load_cell(cell)
    kind = c.workload["traffic"]
    device = device or torch.device("cuda", 0)
    out = []
    for seed in seeds:
        patch = (contextlib.nullcontext() if mode == "program"
                 else faults.PATCHES[kind][mode]())
        with patch:
            r = harness.Run(c, seed=seed, seconds=seconds, trace_on=False, device=device,
                            t_start=time.perf_counter(), size=size)
            res = harness.traffic(kind).run(r)
        out.append((seed, {k: v.value for k, v in res.checks.items()},
                    all(v.ok for v in res.checks.values())))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "control", "unchanged", "half", "altered"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, checks, ok in readings(args.workload, args.mode, seeds, args.seconds):
        print(json.dumps({"cell": args.workload, "mode": args.mode, "seed": seed,
                          "checks": checks, "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
