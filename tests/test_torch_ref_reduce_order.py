"""The order in which csrc/render_ref.cu's replay backward sums its rays,
modelled in torch (``ordered_replay_grad``): a thread per ray; a warp's 32
lanes summed in the tree of a ``__shfl_down_sync`` warp sum (offsets 16,
8, .., 1), which ``warp_reduce_scatter`` keeps bit for bit; a block's 8
warps added in warp order; then, per row of the [3 + 3S, n_blocks]
scratch, thread t of ``reduce_partials_kernel`` adds blocks t, t + 256,
.. to a zero, and its 256 threads meet in a halving tree.

Here, on the CPU, the model holds the twin's per-ray terms
(``render_kernels.replay_terms_plain``) and sums them to the twin's
gradient within rtol.  ``tests/test_torch_cuda.py`` holds the kernel to
the model bit for bit on the card, on the same terms."""

import numpy as np
import pytest
import torch

from ascendpathtracing_tpu_torch.ops import render_kernels as rk

LANES, WARPS = 32, rk.BLOCK // 32
N = rk.BLOCK * 300 + 77  # 301 blocks: some reducing threads take two, the last block ragged
CASES = [(s, bounces) for s in (1, 3, 8, 16) for bounces in (3, 8, 11)]


def replay_case(s, bounces, dtype, device, kind="wide_range", n=N, seed=0):
    """Winners drawn at random (misses, index S, and light hits among
    them), a [10, S] scene with albedos 0.2-1.2 and the light at S - 1, and
    a cotangent: of either sign over twelve decades (``wide_range``, so
    that another order of the sums shows in their bits), with a fifth of
    its entries +0 or -0 (``signed_zeros``), or in 0.5-1.5 (``positive``,
    no cancellation)."""
    rng = np.random.RandomState(seed + 100 * s + bounces)
    light = s - 1
    ids = rng.randint(0, s + 1, (bounces, n))
    scene = rng.uniform(0.2, 1.2, (10, s))
    if kind == "positive":
        g = rng.uniform(0.5, 1.5, (3, n))
    else:
        g = rng.standard_normal((3, n)) * 10.0 ** rng.uniform(-6, 6, (3, n))
    if kind == "signed_zeros":
        g[rng.rand(3, n) < 0.1] = 0.0
        g[rng.rand(3, n) < 0.1] = -0.0
    return (torch.tensor(ids, dtype=torch.int32, device=device),
            torch.tensor(scene, dtype=dtype, device=device),
            torch.tensor(g, dtype=dtype, device=device), light)


def _lanes_then_warps(x):
    """[V, n_blocks * BLOCK] -> [V, n_blocks]: each block's sums, lane 0 of
    a shfl_down warp sum per warp, then the warps in order."""
    x = x.reshape(x.shape[0], -1, WARPS, LANES)
    for off in (16, 8, 4, 2, 1):  # lane l adds lane l + off; lane 0's result
        x = x[..., :off] + x[..., off:2 * off]
    x = x[..., 0]
    acc = x[:, :, 0]
    for w in range(1, WARPS):
        acc = acc + x[:, :, w]
    return acc


def _rows(partial):
    """[V, n_blocks] -> [V]: reduce_partials_kernel's sum of each row."""
    v, n_blocks = partial.shape
    acc = torch.zeros((v, rk.BLOCK), dtype=partial.dtype, device=partial.device)
    for b0 in range(0, n_blocks, rk.BLOCK):  # thread t adds block b0 + t
        m = min(rk.BLOCK, n_blocks - b0)
        acc[:, :m] = acc[:, :m] + partial[:, b0:b0 + m]
    w = rk.BLOCK // 2
    while w > 0:
        acc = acc[:, :w] + acc[:, w:2 * w]
        w //= 2
    return acc[:, 0]


def ordered_replay_grad(emission, albedo, light):
    """grad [10, S] from the per-ray terms of ``replay_terms_plain``
    (emission [3, N], albedo [S, 3, N]) summed in the kernel's order."""
    s, _, n = albedo.shape
    terms = torch.cat([emission, albedo.transpose(0, 1).reshape(3 * s, n)])  # row 3 + c*S + s
    n_blocks = -(-n // rk.BLOCK)
    x = torch.zeros((3 + 3 * s, n_blocks * rk.BLOCK), dtype=terms.dtype, device=terms.device)
    x[:, :n] = terms  # threads past N add +0
    sums = _rows(_lanes_then_warps(x))
    grad = torch.zeros((10, s), dtype=terms.dtype, device=terms.device)
    grad[4:7, light] = sums[:3]
    grad[7:10] = sums[3:].reshape(3, s)
    return grad


@pytest.mark.parametrize("s,bounces", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_sums_equal_the_twin(s, bounces, dtype):
    idx, sp, g, light = replay_case(s, bounces, dtype, "cpu", kind="positive")
    kw = dict(light_index=light, bounces=bounces)
    got = ordered_replay_grad(*rk.replay_terms_plain(idx, sp, g, **kw), light)
    want = rk.render_ref_bwd_replay_plain(idx, sp, g, **kw)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)
    assert bool((want[7:10] != 0).any()) and bool((want[4:7, light] != 0).all())
