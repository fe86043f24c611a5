"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011) in plain torch, keyed as the program documents its
path tracers' stream: key (seed, 0), counter (pixel, sample layer,
block, 0); uniform q of a sample is word q % 4 of block q // 4, made
(bits >> 8) * 2^-24.

Words are int64 tensors holding uint32 values; a 32 x 32-bit product is
split into 16-bit halves so that no partial product overflows int64.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, m: int):
    p_hi = a * (m >> 16)
    p_lo = a * (m & 0xFFFF)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words under the key (k0, k1)."""
    k0, k1 = k0 & MASK, k1 & MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def sample_uniforms(seed: int, pixel, layer, count: int, dtype) -> torch.Tensor:
    """``count`` uniforms of each (pixel, layer) sample (int64 [M] each)
    -> [count, M] in ``dtype``."""
    blocks = -(-count // 4)
    b = torch.arange(blocks, dtype=torch.int64, device=pixel.device)[:, None]
    words = philox(pixel[None], layer[None], b, 0, seed, 0)
    bits = torch.stack(words, dim=1).reshape(blocks * 4, pixel.shape[0])[:count]
    return (bits >> 8).to(dtype) * 2.0 ** -24
