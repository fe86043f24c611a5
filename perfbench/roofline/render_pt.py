"""``csrc/render_pt.cu``, one frame: each camera sample's ray, and each
live sample-bounce (the reference's count over its checked pixels,
scaled to the frame) S sphere tests and one shading; reads the scene,
writes the image [3, W*H]."""

from perfbench.roofline import CAMERA_OPS, PT_SHADE_OPS, SPHERE_OPS


def work(ctx):
    c = ctx["counts"]
    ops = c["live_bounces"] * (SPHERE_OPS * c["spheres"] + PT_SHADE_OPS) + c["samples"] * CAMERA_OPS
    return ops, 12 * c["pixels"] + 44 * c["spheres"]
