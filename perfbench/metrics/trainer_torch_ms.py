"""Device milliseconds a step of the operations (kernels, memsets,
copies) that no ``csrc/`` library launched: the trainer's loss, SGD and
layout copies in plain torch.  A kernel is the program's when its
function name, in the anonymous namespace, is one of ``CSRC_KERNELS``,
frozen here from the program's ``csrc/*.cu``."""

from perfbench import trace

CSRC_KERNELS = frozenset({
    "render_ref_fwd_kernel", "render_ref_bwd_replay_kernel", "render_ref_bwd_recompute_kernel",
    "reduce_partials_kernel", "render_pt_kernel", "dump_pt_alive_kernel",
    "render_pt_mesh_kernel", "kstats_kernel", "dump_mesh_pt_kernel", "wbvh_kernel",
    "dump_wbvh_tiles_kernel", "bvh_kernel", "kocc_kernel", "sum_kernel", "reduce_kernel",
    "chain_kernel", "copy_kernel", "read_kernel",
})


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("iterations") or not tr.get("device_events"):
        return None
    torch_s = sum(b - a for n, a, b in tr["device_events"]
                  if trace.csrc_kernel(n) not in CSRC_KERNELS)
    return torch_s / tr["iterations"] * 1e3
