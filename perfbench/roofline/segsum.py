"""``csrc/segsum.cu`` over one step's replay: every sample-bounce's row
of six gradient terms (float32) and its segment (int32) read once, six
additions a row, the [segments, 6] float64 sums written once (segments:
the spheres and the mesh's slots)."""


def work(ctx):
    c = ctx["counts"]
    rows = c["bounces"] * c["samples"]
    return rows * 6, rows * (6 * 4 + 4) + (c["spheres"] + c["slots"]) * 6 * 8
