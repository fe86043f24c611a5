"""``trainer_torch_ms`` on a data-parallel step (``make_train_step`` with
a mesh): device milliseconds a step of the operations that no ``csrc/``
library launched, by ``trainer_torch_ms``'s frozen ``CSRC_KERNELS``,
leaving out NCCL's kernels and its ``nccl:`` annotations (names that
start with ``nccl``), which are the collectives layer's
(``all_reduce_ms.fit``).  The packing ``cat`` of the all-reduce is the
trainer's glue and counts."""

from perfbench import trace
from perfbench.harness import load_by_path

CSRC_KERNELS = load_by_path("metrics", "trainer_torch_ms").CSRC_KERNELS


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("iterations") or not tr.get("device_events"):
        return None
    torch_s = sum(b - a for n, a, b in tr["device_events"]
                  if trace.csrc_kernel(n) not in CSRC_KERNELS and not n.startswith("nccl"))
    return torch_s / tr["iterations"] * 1e3
