"""``csrc/segsum.cu``'s launches of a step (the replay's segment sums):
their share of the roofline (``perfbench/roofline/segsum.py``)."""

from perfbench.roofline import share


def read(ctx):
    return share(ctx, "segsum", {"sum_kernel", "reduce_kernel", "kocc_kernel"})
