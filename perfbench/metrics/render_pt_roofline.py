"""``csrc/render_pt.cu``'s share of its roofline, a frame
(``perfbench/roofline/render_pt.py``)."""

from perfbench.roofline import share


def read(ctx):
    return share(ctx, "render_pt", {"render_pt_kernel"})
