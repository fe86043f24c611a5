"""``csrc/mesh_pt.cu``, one frame: render_pt's work plus, for each live
sample-bounce that a triangle wins, one triangle test; reads the scene
and each triangle's 24-float row once, writes the image [3, W*H].  No
traversal work is counted, only what any traversal must do, so the
bound is a floor."""

from perfbench.roofline import CAMERA_OPS, PT_SHADE_OPS, SPHERE_OPS, TRIANGLE_OPS


def work(ctx):
    c = ctx["counts"]
    ops = (c["live_bounces"] * (SPHERE_OPS * c["spheres"] + PT_SHADE_OPS)
           + c["samples"] * CAMERA_OPS + c["triangle_hits"] * TRIANGLE_OPS)
    return ops, 12 * c["pixels"] + 44 * c["spheres"] + 96 * c["triangles"]
