"""``csrc/render_ref.cu``'s replay backward, its kernel and the pass that
sums its blocks' partials: their share of the roofline
(``perfbench/roofline/render_ref_bwd_replay.py``)."""

from perfbench.roofline import share


def read(ctx):
    return share(ctx, "render_ref_bwd_replay",
                 {"render_ref_bwd_replay_kernel", "reduce_partials_kernel"})
