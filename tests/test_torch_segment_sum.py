"""The port's segment-sum (ascendpathtracing_tpu_torch.ops.histogram_kernels)
on the CPU: the plain twins against the Pallas kernels of
ops/pallas_histogram.py in interpret mode at the shapes of
tests/test_pallas_histogram.py (sums and the occupancy count kocc), the
out= accumulation and the wrapper's checks.  ``test_torch_cuda.py``
holds the CUDA kernel against the twin on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascendpathtracing_tpu.ops import pallas_histogram as ph
from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk


def _random(n, s, r, lo=-1, hi=None):
    rng = np.random.RandomState(n + s)
    seg = rng.randint(lo, s if hi is None else hi, size=n).astype(np.int32)
    return seg, rng.randn(r, n).astype(np.float32)


def _clustered(n, s, r):
    """tests/test_pallas_histogram.py:66-72: clustered ids (the replay
    stream's shape), 1% -1 and 1% s + 7 (both dropped)."""
    rng = np.random.RandomState(n + s)
    seg = (rng.randint(0, 20, n) * (s // 20) + rng.randint(0, s // 40, n)).astype(np.int32)
    seg[: n // 100] = -1
    seg[n // 100: n // 50] = s + 7
    return seg, rng.randn(r, n).astype(np.float32)


def _tol(exp):
    # f32 sums in another order: the JAX test's own bound.
    return 3e-5 * max(float(np.abs(exp).max()), 1.0)


@pytest.mark.parametrize("stream,n,s,r", [
    ("random", 10000, 700, 6), ("random", 4096, 513, 3), ("random", 2048, 2048, 8),
    ("backward", 1 << 16, 5121, 6),
])
def test_twin_matches_flat_kernel(stream, n, s, r):
    if stream == "backward":  # test_matches_segment_sum_on_backward_shapes
        seg, vals = _random(n, s, r, lo=0, hi=s + 200)
    else:
        seg, vals = _random(n, s, r)
    exp = np.asarray(ph.segment_rows_matmul(jnp.asarray(seg), jnp.asarray(vals),
                                            n_slots=s, interpret=True))
    got = hk.segment_rows_matmul(torch.tensor(seg), torch.tensor(vals), n_slots=s)
    assert got.shape == (s, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=_tol(exp))
    got64 = hk.segment_rows_plain(torch.tensor(seg), torch.tensor(vals, dtype=torch.float64),
                                  n_slots=s)
    np.testing.assert_allclose(got64.numpy(), exp, rtol=0, atol=_tol(exp))


@pytest.mark.parametrize("stream,n,s,r", [
    ("clustered", 20000, 20000, 6), ("clustered", 4096, 9000, 3),
    ("random", 1 << 14, 6000, 6),
])
def test_twin_matches_paged_kernel_and_its_kocc(stream, n, s, r):
    if stream == "clustered":
        seg, vals = _clustered(n, s, r)
    else:  # test_paged_matches_flat_kernel's stream
        seg, vals = _random(n, s, r, lo=-5, hi=s + 100)
    exp, exp_kocc = ph.segment_rows_paged(jnp.asarray(seg), jnp.asarray(vals), n_slots=s,
                                          interpret=True)
    exp = np.asarray(exp)
    got, kocc = hk.segment_rows_paged(torch.tensor(seg), torch.tensor(vals), n_slots=s)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=_tol(exp))
    assert kocc.dtype == torch.int32
    np.testing.assert_array_equal(kocc.numpy(), np.asarray(exp_kocc))


@pytest.mark.parametrize("slot_block,sample_block", [(128, 2048), (256, 512), (512, 1024)])
def test_kocc_matches_jax_at_other_blocks(slot_block, sample_block):
    seg, vals = _clustered(3000, 4000, 2)
    _, exp = ph.segment_rows_paged(jnp.asarray(seg), jnp.asarray(vals), n_slots=4000,
                                   slot_block=slot_block, sample_block=sample_block,
                                   interpret=True)
    got = hk.occupancy_plain(torch.tensor(seg), n_slots=4000, slot_block=slot_block,
                             sample_block=sample_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_out_of_range_ids_dropped():
    """tests/test_pallas_histogram.py::test_out_of_range_ids_dropped."""
    seg = torch.tensor([0, 5, 100, -3, 2], dtype=torch.int32)
    got = hk.segment_rows_matmul(seg, torch.ones((2, 5)), n_slots=6)
    exp = torch.zeros((6, 2))
    exp[[0, 5, 2]] = 1.0
    assert torch.equal(got, exp)


def test_out_accumulates_across_calls():
    """A chunked caller's one accumulator: two halves added into out equal
    one call on the whole stream; kocc is per call."""
    seg, vals = _clustered(8192, 3000, 6)
    seg, vals = torch.tensor(seg), torch.tensor(vals, dtype=torch.float64)
    whole, kocc = hk.segment_rows_paged(seg, vals, n_slots=3000)
    out = torch.zeros((3000, 6), dtype=torch.float64)
    for half in (slice(0, 4096), slice(4096, 8192)):
        res, k = hk.segment_rows_paged(seg[half], vals[:, half].contiguous(), n_slots=3000,
                                       out=out)
        assert res is out and k.shape == (2,)
    torch.testing.assert_close(out, whole, rtol=1e-12, atol=1e-12)
    assert hk.segment_rows_matmul(seg, vals, n_slots=3000, out=out) is out
    torch.testing.assert_close(out, 2 * whole, rtol=1e-12, atol=1e-12)
    assert kocc.shape == (4,)


def test_out_may_be_float64_for_float32_rows():
    """The replay's one float64 accumulator takes float32 rows."""
    seg, vals = _clustered(4096, 3000, 6)
    seg, vals = torch.tensor(seg), torch.tensor(vals)
    out = torch.zeros((3000, 6), dtype=torch.float64)
    assert hk.segment_rows_paged(seg, vals, n_slots=3000, out=out)[0] is out
    torch.testing.assert_close(out, hk.segment_rows_plain(seg, vals.double(), n_slots=3000),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        hk.segment_rows_matmul(seg, vals.double(), n_slots=3000,
                               out=torch.zeros((3000, 6)))


def test_cpu_tensors_run_the_twin_without_counting():
    hk.reset_launches()
    hk.segment_rows_paged(torch.zeros(64, dtype=torch.int32), torch.ones((1, 64)), n_slots=4)
    hk.segment_rows_matmul(torch.zeros(64, dtype=torch.int32), torch.ones((1, 64)), n_slots=4)
    assert hk.LAUNCHES == {"segsum": 0}


@pytest.mark.parametrize("change,exc", [
    (dict(seg=torch.zeros(8, dtype=torch.int64)), TypeError),
    (dict(vals=torch.zeros((6, 8), dtype=torch.float16)), TypeError),
    (dict(vals=torch.zeros((9, 8))), ValueError),  # R > 8
    (dict(vals=torch.zeros((6, 7))), ValueError),  # N differs
    (dict(slot_block=100), ValueError),
    (dict(sample_block=100), ValueError),
    (dict(n_slots=1 << 30), ValueError),  # more slot blocks than the flags hold
    (dict(out=torch.zeros((10, 5))), ValueError),
    (dict(out=torch.zeros((10, 6))), ValueError),  # out must be float64
    (dict(vals=torch.zeros((8, 6)).T), ValueError),  # not contiguous
])
def test_wrapper_rejects_bad_inputs(change, exc):
    kw = dict(seg=torch.zeros(8, dtype=torch.int32), vals=torch.zeros((6, 8)), n_slots=10,
              slot_block=128, sample_block=2048, out=None)
    kw.update(change)
    with pytest.raises(exc):
        hk.segment_rows_paged(kw.pop("seg"), kw.pop("vals"), **kw)


def _runs(n, s, r, run=37, seed=0):
    """Runs of `run` equal ids (straddling lane, warp and tile bounds), a
    tenth of the runs dropped (-1 or s + 3)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, s, size=-(-n // run))
    ids[rng.rand(ids.shape[0]) < 0.05] = -1
    ids[rng.rand(ids.shape[0]) < 0.05] = s + 3
    return np.repeat(ids, run)[:n].astype(np.int32), rng.randn(r, n)


@pytest.mark.parametrize("case,n,s,r,groups,sample_block", [
    ("random", 10000, 700, 6, 3, 2048),
    ("runs", 20011, 50, 8, 7, 512),
    ("runs", 4097, 9, 1, 1, 96),
    ("one_id", 5000, 3, 2, 2, 2048),
    ("dropped", 3000, 5, 3, 2, 32),
])
def test_ordered_model_matches_twin(case, n, s, r, groups, sample_block):
    """segment_rows_ordered (the kernel's order of additions) against the
    twin's index_add_ in float64: within 1e-12 of sum |vals| per segment;
    ``test_torch_cuda.py`` holds the kernel to it bit for bit."""
    if case == "random":
        seg, vals = _random(n, s, r)
    elif case == "runs":
        seg, vals = _runs(n, s, r, seed=n)
    else:
        seg = np.full(n, 1 if case == "one_id" else -2, np.int32)
        vals = np.random.RandomState(n).randn(r, n)
    seg_t, vals_t = torch.tensor(seg), torch.tensor(vals)
    ref = hk.segment_rows_plain(seg_t, vals_t.double(), n_slots=s)
    mag = hk.segment_rows_plain(seg_t, vals_t.double().abs(), n_slots=s)
    got = hk.segment_rows_ordered(seg_t, vals_t, n_slots=s, groups=groups,
                                  sample_block=sample_block)
    assert got.shape == (s, r) and got.dtype == torch.float64
    assert bool(((got - ref).abs() <= 1e-12 * mag).all())
    if case == "dropped":
        assert not bool(got.any())
    again = hk.segment_rows_ordered(seg_t, vals_t, n_slots=s, groups=groups,
                                    sample_block=sample_block, out=got.clone())
    assert torch.equal(again, got + got)
