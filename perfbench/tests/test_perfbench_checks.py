"""The check, driven through whole runs on the CPU at a tiny size, the
harness's look for a chip skipped: the program's runs come out correct,
the control (the reference in bfloat16 in the program's place) and every
planted fault do not."""

import pytest
import torch

from perfbench import control

SIZES = {
    "fit": dict(width=16, height=16, trace_iterations=2, warmup_steps=1),
    "render": dict(width=16, height=16, spp4=8, check_pixels=64, check_frames=2,
                   trace_iterations=2, warmup_frames=1),
}
SEEDS = [12345, 2 ** 31 + 77]


def _readings(cell, mode, size, seconds=0.3):
    return control.readings(cell, mode, SEEDS, seconds, device=torch.device("cpu"), size=size)


@pytest.mark.parametrize("cell,kind", [("cornell8.fit", "fit"), ("cornell8.render", "render")])
def test_program_is_correct(cell, kind):
    assert all(ok for _, _, ok in _readings(cell, "program", SIZES[kind]))


@pytest.mark.parametrize("cell,kind", [("cornell8.fit", "fit"), ("cornell8.render", "render")])
@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
def test_control_and_faults_are_not_correct(cell, kind, mode):
    assert not any(ok for _, _, ok in _readings(cell, mode, SIZES[kind]))


@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False)])
def test_mesh_cell(mode, correct):
    size = dict(SIZES["render"], width=8, height=8, spp4=4, check_pixels=16)
    out = control.readings("smallpt9_ico4.render", mode, SEEDS[:1], 0.1,
                           device=torch.device("cpu"), size=size)
    assert [ok for _, _, ok in out] == [correct]


@pytest.mark.parametrize("mode,correct", [("program", True), ("control", False), ("half", False),
                                          ("unchanged", False), ("altered", False)])
def test_mesh_fit_cell(mode, correct):
    size = dict(width=8, height=8, spp4=8, target_spp4=8, warmup_steps=1, trace_after=1,
                trace_iterations=1, loss_every=1)
    out = control.readings("smallpt9_ico4.fit", mode, SEEDS[:1], 0.1,
                           device=torch.device("cpu"), size=size)
    assert [ok for _, _, ok in out] == [correct]
