"""``csrc/mesh_pt.cu``'s share of its roofline, a frame
(``perfbench/roofline/mesh_pt.py``: a floor, with no traversal work)."""

from perfbench.roofline import share


def read(ctx):
    return share(ctx, "mesh_pt", {"render_pt_mesh_kernel"})
