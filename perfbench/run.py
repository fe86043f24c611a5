"""Runs one cell of the benchmark once and prints its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA
devices.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, then ``checks``); the last lines of
standard error give each compared number beside its limit.  Exit codes:
0 a result was printed; 2 no usable device or no program; 3 a JAX module
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
#: Fixed cache directories inside the checkout, so that only a
#: checkout's first run builds or compiles.
CACHES = {
    "TORCH_EXTENSIONS_DIR": CHECKOUT / "build" / "perfbench" / "torch_extensions",
    "TRITON_CACHE_DIR": CHECKOUT / "build" / "perfbench" / "triton",
    "CUDA_CACHE_PATH": CHECKOUT / "build" / "perfbench" / "cuda_cache",
}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    chips = int(cell.workload["chips"])
    if torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import ascendpathtracing_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"perfbench: the program ascendpathtracing_tpu_torch is missing: {exc}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(cell, seed=args.seed, seconds=args.seconds, trace_on=bool(args.trace),
                      device=device, t_start=T_START)
    outcome = harness.traffic(cell.workload["traffic"]).run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules that must not load were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(outcome.context["memory_peak_bytes"])}
    if args.trace:
        info["power"] = harness.power_limit()
    line = harness.result(cell, run, outcome, info)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
