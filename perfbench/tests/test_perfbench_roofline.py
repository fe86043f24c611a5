"""Roofline counts at a tiny size, and the share read from a synthetic
trace."""

import pytest

from perfbench import harness, roofline

FIT = {"rays": 16, "bounces": 8, "spheres": 8}
FRAME = {"samples": 64, "pixels": 16, "live_bounces": 100.0, "triangle_hits": 10.0,
         "spheres": 9, "triangles": 20, "bounces": 8, "slots": 32}


def work(kernel, counts):
    return harness.load_by_path("roofline", kernel).work({"counts": counts})


def test_hand_model_counts():
    assert work("render_ref_fwd_idx", FIT) == (16 * 8 * (20 * 8 + 30), 16 * (24 + 12 + 32) + 320)
    assert work("render_ref_bwd_replay", FIT) == (16 * 8 * 10, 16 * (32 + 12) + 640)
    assert work("render_pt", FRAME) == (100 * (20 * 9 + 60) + 64 * 40, 12 * 16 + 44 * 9)
    ops, nbytes = work("mesh_pt", FRAME)
    assert ops == 100 * (20 * 9 + 60) + 64 * 40 + 10 * 30
    assert nbytes == 12 * 16 + 44 * 9 + 96 * 20
    assert work("mesh_pt_residuals", FRAME) == (ops, nbytes + 8 * 64 * 32)
    assert work("segsum", FRAME) == (8 * 64 * 6, 8 * 64 * 28 + (9 + 32) * 48)


def test_bound_takes_the_larger_term():
    pk = roofline.peaks()
    assert pk["fp32_ops_per_s"] == 67e12 and pk["hbm_bytes_per_s"] == 3.35e12
    assert roofline.bound_s(67e12, 1.0) == (pytest.approx(1.0), "operations")
    assert roofline.bound_s(1.0, 3.35e12) == (pytest.approx(1.0), "bytes")


def test_share_from_trace_events():
    name = "void (anonymous namespace)::render_pt_kernel<float>(float const*)"
    other = "void at::native::vectorized_elementwise_kernel<4>()"
    ops, nbytes = work("render_pt", FRAME)
    bound = max(ops / 67e12, nbytes / 3.35e12)
    ctx = {"counts": FRAME, "trace": {"iterations": 2, "device_events": [
        (name, 0.0, 10 * bound), (other, 0.0, 1.0), (name, 1.0, 1.0 + 30 * bound)]}}
    # 20 bounds a call: 5%.
    assert roofline.share(ctx, "render_pt", {"render_pt_kernel"}) == pytest.approx(5.0)
    assert roofline.share(ctx, "mesh_pt", {"render_pt_mesh_kernel"}) is None
    assert roofline.share({"counts": FRAME, "trace": {}}, "render_pt", {"render_pt_kernel"}) is None
