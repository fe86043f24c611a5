"""``csrc/render_ref.cu``'s replay backward (its kernel and the pass that
sums its blocks): N rays x B bounces, 10 operations a bounce to rebuild
the albedo product and its derivative; reads the winners [B, N], the
cotangent [3, N] and the scene, writes the [10, S] gradient."""


def work(ctx):
    c = ctx["counts"]
    n, b, s = c["rays"], c["bounces"], c["spheres"]
    return n * b * 10, n * (4 * b + 12) + 80 * s
