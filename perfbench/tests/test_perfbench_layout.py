"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic kind, per-layer metric and roofline found by name
from its own files."""

import json
import re

import pytest

from perfbench import harness, inputs

BENCH = json.loads(harness.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def chips_allowed(workloads) -> bool:
    """Each cell asks for 1 card or 4, and at most max(1, cells // 4)
    cells ask for 4."""
    chips = [w["chips"] for w in workloads]
    return set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits in its 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = inputs.load_json("configs", c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        # What the configuration changed from its source: the same list of
        # names in BENCHMARK.json and in its file, empty or not.
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(isinstance(k, str) and NAME.match(k) for k in c["reduced"])
        assert cfg["reduced"] == c["reduced"]
        assert c["name"] in used


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and _line(entry["why"])
    assert entry["chips"] in (1, 4)
    c = harness.load_cell(cell)
    assert c.workload["why"] == entry["why"] and c.workload["chips"] == entry["chips"]
    assert callable(harness.traffic(entry["traffic"]).run)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_by_path("metrics", m["name"]).read)
        assert m["moves"] in names


def test_four_card_cells_within_their_share():
    assert chips_allowed(BENCH["workloads"])


def _cells(*chips):
    return [{"name": f"c{i}", "chips": c} for i, c in enumerate(chips)]


@pytest.mark.parametrize("workloads,allowed", [
    (_cells(1, 1, 1, 1, 4), True),  # one four-card cell is always allowed
    (_cells(4), True),
    (_cells(1, 1, 1, 1, 1, 1, 1, 4, 4), True),  # 9 cells: two
    (_cells(1, 1, 1, 4, 4), False),  # 5 cells: one too many
    (_cells(1, 1, 1, 1, 1, 1, 4, 4, 4), False),
    (_cells(1, 2), False),  # 1 or 4 only
])
def test_chips_rule(workloads, allowed):
    assert chips_allowed(workloads) == allowed


def test_cells_unique_and_metrics_well_formed():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) and len(set(CELLS)) == len(CELLS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("kernel", ["render_ref_fwd_idx", "render_ref_bwd_replay", "render_pt",
                                    "mesh_pt", "mesh_pt_residuals", "segsum"])
def test_roofline_found_by_name(kernel):
    assert callable(harness.load_by_path("roofline", kernel).work)


def test_missing_names_say_which_file():
    with pytest.raises(KeyError):
        harness.load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError, match="metrics"):
        harness.load_by_path("metrics", "no_such_metric")
    with pytest.raises(FileNotFoundError, match="configs"):
        inputs.load_json("configs", "no_such_config")
