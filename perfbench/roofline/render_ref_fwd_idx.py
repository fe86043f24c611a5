"""``csrc/render_ref.cu``'s forward with winners: N rays x B bounces, each
bounce S sphere tests and one reference-mode shading; reads the rays [6,
N] and the scene [10, S], writes colours [3, N] and winners [B, N]."""

from perfbench.roofline import REF_SHADE_OPS, SPHERE_OPS


def work(ctx):
    c = ctx["counts"]
    n, b, s = c["rays"], c["bounces"], c["spheres"]
    return n * b * (SPHERE_OPS * s + REF_SHADE_OPS), n * (24 + 12 + 4 * b) + 40 * s
