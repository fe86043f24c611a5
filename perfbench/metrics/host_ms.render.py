"""Host milliseconds a frame inside the program's render call
(``ops/pt_kernels.render_pt`` or ``ops/mesh_pt_kernels.render_pt_mesh``)
until it returns, from perfbench's own spans; the mean over the
window's untraced frames."""


def read(ctx):
    spans = ctx.get("host_ms") or []
    return sum(spans) / len(spans) if spans else None
