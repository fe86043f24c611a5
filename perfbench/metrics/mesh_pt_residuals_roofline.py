"""``csrc/mesh_pt.cu``'s forward with residuals: its share of its roofline
(``perfbench/roofline/mesh_pt_residuals.py``: a floor)."""

from perfbench.roofline import share


def read(ctx):
    return share(ctx, "mesh_pt_residuals", {"render_pt_mesh_kernel"})
