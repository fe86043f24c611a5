"""The replay rows wrapper on the CPU (``ops/replay_kernels``): its
refusals, its dispatch to the plain twin, and the chunked replay that
calls it.  The kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py -k replay_rows``)."""

import pytest
import torch

from ascendpathtracing_tpu_torch.diff import mesh_fused as mf
from ascendpathtracing_tpu_torch.ops import replay_kernels as rpk
from tests.test_torch_cuda import _bits, _replay_residuals


def _inputs(dtype=torch.float32, bounces=3, spp4=8, pix=33):
    return _replay_residuals(bounces, spp4, pix, dtype, "cpu", seed=bounces)


@pytest.mark.parametrize("change,error,match", [
    (lambda w, r, g: (w.to(torch.int64), r, g), TypeError, "wid must be int32"),
    (lambda w, r, g: (w, r.half(), g.half()), TypeError, "float32 or float64"),
    (lambda w, r, g: (w, r, g.double()), TypeError, "g_cell must be"),
    (lambda w, r, g: (w[0], r, g), ValueError, "expected wid"),
    (lambda w, r, g: (w, r[:, :6], g), ValueError, "expected resv"),
    (lambda w, r, g: (w, r[:, :, :4], g), ValueError, "expected resv"),
    (lambda w, r, g: (w, r, g[:, :-1]), ValueError, "g_cell"),
    (lambda w, r, g: (w, r, torch.cat([g, g])), ValueError, "g_cell"),
    (lambda w, r, g: (w.transpose(1, 2).contiguous().transpose(1, 2), r, g), ValueError,
     "contiguous"),
    (lambda w, r, g: (w, r, g.T.contiguous().T), ValueError, "contiguous"),
    (lambda w, r, g: (w, r.to("meta"), g), ValueError, "different devices"),
])
def test_replay_rows_refuses_what_the_kernel_does_not_take(change, error, match):
    wid, resv, g = change(*_inputs())
    with pytest.raises(error, match=match):
        rpk.replay_rows(wid, resv, g, layer0=0, layers=4)


@pytest.mark.parametrize("layer0,layers", [(-1, 2), (0, 0), (6, 3), (8, 1)])
def test_replay_rows_refuses_layers_outside_spp4(layer0, layers):
    wid, resv, g = _inputs()
    with pytest.raises(ValueError, match="outside"):
        rpk.replay_rows(wid, resv, g, layer0=layer0, layers=layers)


@pytest.mark.parametrize("out", [
    torch.empty((6, 3, 4, 32)), torch.empty((6, 3, 4, 33), dtype=torch.float64),
    torch.empty((6, 3, 33, 4)).transpose(2, 3)])
def test_replay_rows_refuses_a_wrong_out(out):
    wid, resv, g = _inputs()
    with pytest.raises(ValueError, match="out must be"):
        rpk.replay_rows(wid, resv, g, layer0=0, layers=4, out=out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bounces", [1, 3, 8])
def test_replay_rows_on_the_cpu_is_the_twin_and_launches_nothing(dtype, bounces):
    """CPU tensors take the twin: its rows bit for bit, into ``out`` when
    given, and LAUNCHES stays at 0."""
    wid, resv, g = _inputs(dtype, bounces)
    rpk.reset_launches()
    got = rpk.replay_rows(wid, resv, g, layer0=2, layers=5)
    exp = rpk.replay_rows_plain(wid, resv, g, layer0=2, layers=5)
    assert got.shape == (6, bounces, 5, 33) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(exp))
    out = torch.full_like(got, float("nan"))
    assert rpk.replay_rows(wid, resv, g, layer0=2, layers=5, out=out) is out
    assert torch.equal(_bits(out), _bits(exp))
    assert rpk.LAUNCHES == {"replay_rows": 0}


def test_replay_rows_plain_reads_the_chunk_of_the_whole_arrays():
    """The twin on the whole arrays at a layer offset equals the twin on
    the chunk's own copy (the caller's slice before the move)."""
    wid, resv, g = _inputs(bounces=4, spp4=12)
    got = rpk.replay_rows_plain(wid, resv, g, layer0=5, layers=4)
    exp = rpk.replay_rows_plain(wid[:, 5:9].contiguous(), resv[:, :, 5:9].contiguous(), g,
                                layer0=0, layers=4)
    assert torch.equal(_bits(got), _bits(exp))


def test_replay_rows_rows_are_the_chain_s_derivatives():
    """The rows against a float64 autograd of the chain they replay, L =
    sum_b live_b tput_{b-1} e_b (weighted by g): ge = dL/de, ga = dL/da."""
    wid, resv, g = _inputs(torch.float64, bounces=4, spp4=2, pix=16)
    a = resv[:, 0:3].clone().requires_grad_(True)
    e = resv[:, 3:6].clone().requires_grad_(True)
    live = (wid >= 0).double()[:, None]
    m = torch.where(live > 0, a * resv[:, 6][:, None], 1.0)
    tput = torch.cumprod(torch.cat([torch.ones_like(m[:1]), m[:-1]]), dim=0)
    loss = (g[:, None, :] * (live * tput * e).sum(dim=0)).sum()
    da, de = torch.autograd.grad(loss, (a, e))
    rows = rpk.replay_rows(wid, resv, g, layer0=0, layers=2)
    torch.testing.assert_close(rows[3:6], de.permute(1, 0, 2, 3), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(rows[0:3], da.permute(1, 0, 2, 3), rtol=1e-12, atol=1e-14)


def test_replay_rows_at_zero_bounces_is_empty():
    wid = torch.zeros((0, 4, 5), dtype=torch.int32)
    resv, g = torch.zeros((0, 7, 4, 5)), torch.ones((3, 5))
    for fn in (rpk.replay_rows, rpk.replay_rows_plain):
        assert fn(wid, resv, g, layer0=1, layers=2).shape == (6, 0, 2, 5)


@pytest.mark.parametrize("spp4,chunk", [(16, 8), (20, 8), (7, 3)])
def test_replay_backward_default_equals_plain_on_the_cpu(spp4, chunk):
    """The default replay (the wrappers' CPU twins) equals ``plain=True``
    bit for bit, ragged last chunks too."""
    wid, resv, g = _replay_residuals(5, spp4, 40, torch.float32, "cpu", seed=spp4)
    kw = dict(n_spheres=9, n_slots=40, spp4=spp4, layer_chunk=chunk)
    got = mf.replay_backward(wid, resv, g, **kw)
    exp = mf.replay_backward(wid, resv, g, plain=True, **kw)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, exp))
    assert float(got[0][4:10].abs().max()) > 0
