"""Counter-based uniforms: Philox4x32-10 in plain torch.

The TPU kernels draw from the TPU's hardware PRNG (``pltpu.prng_seed`` /
``prng_random_bits``), which nothing else reproduces.  The port draws
from Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011) instead: a uniform is a pure function of a key and a
counter, so the CUDA kernel (``csrc/render_pt.cu``), its plain twin and
the plain estimators produce the same numbers in any order, and a
stream keyed by ray or pixel index needs no split sequence (the role
``megakernel.indexed_uniforms`` plays in the JAX package).

A 32-bit word becomes a uniform as the Pallas kernel's does
(``pallas_kernels.py:276-280``): ``(bits >> 8) * 2**-24``, exact in
float32 and float64, in [0, 1).

Words live in int64 tensors holding uint32 values.  The product of two
32-bit words overflows int64, so the multiplier is split into 16-bit
halves (each partial product < 2**48).

Streams (the fourth counter word): 0 for the fused path tracer
(counter = (pixel, sample layer, block, 0)), 1 for the plain estimators
(counter = (ray, bounce, block, 1)), 2 for the wavefront's camera jitter
(counter = (global sample index, 0, block, 2)), 3 for derived seeds
(:func:`fold_in`: counter = (data, 0, 0, 3)).  The key is (seed, 0).
The wavefront draws its bounces from stream 1 at (global sample index,
the sample's own bounce), so a sample's path is a pure function of its
index, whatever the pool size, iteration or slot that traces it.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
ROUNDS = 10
WORD_SCALE = 2.0 ** -24

STREAM_FUSED = 0
STREAM_ESTIMATOR = 1
STREAM_CAMERA = 2
STREAM_FOLD = 3


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m, a an int64 tensor of uint32 values."""
    p_hi = a * (m >> 16)
    p_lo = a * (m & 0xFFFF)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = ROUNDS):
    """Philox4x32-``rounds`` of the counter words (int64 tensors of
    uint32 values, or ints; broadcast together) under the key (k0, k1)
    -> four int64 tensors of uint32 values."""
    k0, k1 = k0 & MASK, k1 & MASK
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits, dtype):
    """uint32 words (int64 tensor) -> uniforms in [0, 1) on the 2**-24
    grid."""
    return (bits >> 8).to(dtype) * WORD_SCALE


def uniforms(seed: int, index, c1, count: int, *, stream: int, dtype):
    """``count`` uniforms for each element of ``index`` (an int64 [N]
    tensor, the first counter word) -> [count, N].  Uniform q comes from
    word q % 4 of Philox4x32-10 at counter (index, c1, q // 4, stream),
    key (seed, 0); ``c1`` is an int or an int64 [N] tensor."""
    blocks = -(-count // 4)
    c2 = torch.arange(blocks, dtype=torch.int64, device=index.device)[:, None]
    words = philox4x32(index[None, :], c1 & MASK, c2, stream & MASK, seed, 0)
    bits = torch.stack(words, dim=1).reshape(blocks * 4, index.shape[0])
    return bits_to_uniform(bits[:count], dtype)


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (``jax.random.fold_in``'s
    role, e.g. a shard's own stream): word 0 of Philox4x32-10 at counter
    (data, 0, 0, 3), key (seed, 0)."""
    return int(philox4x32(torch.tensor(data & MASK), 0, 0, STREAM_FOLD, seed, 0)[0])
