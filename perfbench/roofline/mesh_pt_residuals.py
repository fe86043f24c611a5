"""``csrc/mesh_pt.cu`` with residuals, one step's forward: ``mesh_pt``'s
work (a floor: no traversal counted) and, written once, the replay's
residuals of every sample-bounce: the winner (int32) and seven floats
(albedo, emission, the detached weight)."""

from perfbench.harness import load_by_path


def work(ctx):
    ops, nbytes = load_by_path("roofline", "mesh_pt").work(ctx)
    c = ctx["counts"]
    return ops, nbytes + c["bounces"] * c["samples"] * (4 + 7 * 4)
