"""The trace arithmetic on synthetic intervals: the union of device
operations, the idle gaps and what the host did in them."""

import pytest

from perfbench import trace


def test_union_and_busy_count_overlaps_once():
    iv = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (7.0, 8.0), (10.0, 10.5)]
    assert trace.union(iv) == [(0.0, 3.0), (5.0, 8.0), (10.0, 10.5)]
    assert trace.busy(iv) == pytest.approx(6.5)
    assert trace.busy([]) == 0


def test_gaps_cover_what_no_interval_does():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert trace.gaps(iv, 0.0, 8.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    assert trace.gaps(iv, 1.0, 6.0) == [(3.0, 5.0)]
    busy, idle = trace.busy(iv), sum(b - a for a, b in trace.gaps(iv, 0.0, 8.0))
    assert busy + idle == pytest.approx(8.0)


def test_gaps_named_by_innermost_host_event():
    gap_list = [(3.0, 5.0), (6.0, 6.5), (7.0, 7.2)]
    host = [("step", 2.5, 8.0), ("aten::mul", 3.5, 4.5), ("sync", 6.1, 6.4)]
    named = dict(map(tuple, trace.label_gaps(gap_list, host)))
    assert named == {"aten::mul": pytest.approx(2.0), "sync": pytest.approx(0.5),
                     "step": pytest.approx(0.2)}
    assert trace.label_gaps([(0.0, 1.0)], []) == [["idle", 1.0]]


def test_by_name_sums_and_ranks():
    ev = [("a", 0, 1), ("b", 1, 4), ("a", 5, 7), ("c", 8, 8.5)]
    assert trace.by_name(ev) == [["a", 3], ["b", 3], ["c", 0.5]]
    assert trace.by_name(ev, top=1) == [["a", 3]]


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::render_ref_fwd_kernel<float, true, 8>(float const*, int)",
     "render_ref_fwd_kernel"),
    ("(anonymous namespace)::render_pt_kernel<float>", "render_pt_kernel"),
    ("void _GLOBAL__N_1::sum_kernel<float>(int const*)", "sum_kernel"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)", None),
    ("void at::native::(anonymous namespace)::pow_kernel<float>()", None),
    ("Memcpy DtoH (Device -> Pinned)", None),
])
def test_csrc_kernels_told_from_torch_kernels(name, kernel):
    assert trace.csrc_kernel(name) == kernel


@pytest.mark.parametrize("metric,trace,want", [
    # Frames: the traced stretch's own busy over its own wall.
    ("idle_share.render", {"iterations": 4, "busy_s": 0.9, "window_s": 1.0,
                           "untraced_s_per_iteration": 0.2}, 10.0),
    # Fit steps: busy a traced step over the untraced wall of a step.
    ("idle_share.fit", {"iterations": 4, "busy_s": 0.6, "window_s": 1.0,
                        "untraced_s_per_iteration": 0.2}, 25.0),
    ("idle_share.render", {}, None),
    ("idle_share.fit", {"iterations": 0, "busy_s": 0.0, "window_s": 1.0,
                        "untraced_s_per_iteration": None}, None),
])
def test_idle_shares(metric, trace, want):
    from perfbench import harness

    got = harness.load_by_path("metrics", metric).read({"trace": trace})
    assert got == (None if want is None else pytest.approx(want))
