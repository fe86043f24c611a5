"""``csrc/render_ref.cu``'s forward with winners: its share of its
roofline (``perfbench/roofline/render_ref_fwd_idx.py``)."""

from perfbench.roofline import share


def read(ctx):
    return share(ctx, "render_ref_fwd_idx", {"render_ref_fwd_kernel"})
