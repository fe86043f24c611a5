"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: the program's name begins with the JAX package's), and
the reference loads nothing of the program either."""

import json
import subprocess
import sys

from conftest import ROOT

RUN_CELLS = """
import sys, time, torch
from perfbench import harness
size = {"fit": dict(width=8, height=8, trace_iterations=2, warmup_steps=1),
        "render": dict(width=8, height=8, spp4=4, check_pixels=8, check_frames=1,
                       trace_iterations=2, warmup_frames=1)}
for cell in ("cornell8.fit", "cornell8.render"):
    c = harness.load_cell(cell)
    for tr in (False, True):
        r = harness.Run(c, seed=3, seconds=0.1, trace_on=tr, device=torch.device("cpu"),
                        t_start=time.perf_counter(), size=size[c.workload["traffic"]])
        out = harness.traffic(c.workload["traffic"]).run(r)
        harness.result(c, r, out, {})
import perfbench.run, perfbench.control, perfbench.faults
"""

REFERENCE = """
import perfbench.inputs, perfbench.reference.pt, perfbench.reference.refmode
import perfbench.reference.philox, perfbench.roofline, perfbench.trace
"""


def _top_level_after(code):
    code += "\nimport json, sys\nprint(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runs_load_no_jax():
    mods = _top_level_after(RUN_CELLS)
    assert "ascendpathtracing_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "ascendpathtracing_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_after(REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "ascendpathtracing_tpu",
                       "ascendpathtracing_tpu_torch"}
