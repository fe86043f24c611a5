"""Ray reordering for traversal coherence (plain torch).

Counterpart of ``ascendpathtracing_tpu/ops/sort.py``: Morton keys of a
ray's direction octant and quantized origin (:func:`ray_sort_keys`), or
of its quantized direction and origin interleaved (:func:`ray_sort_keys_6d`,
the key ``models/mesh`` sorts by before a traversal kernel).  Keys are
int32, bit for bit the JAX package's; callers scatter results back with
the returned permutation.
"""

from __future__ import annotations

import torch


def _part1by2(x):
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(ix, iy, iz):
    """Interleave three 10-bit ints into a 30-bit Morton code."""
    return (_part1by2(iz) << 2) | (_part1by2(iy) << 1) | _part1by2(ix)


def _quantize(p, lo, hi, bits):
    """clip((p - lo) / max(hi - lo, 1e-20) * (2^bits - 1)) as int32
    (truncated toward zero, as ``astype(int32)``)."""
    s = (1 << bits) - 1
    span = hi - lo
    span = torch.clamp_min(span, 1e-20) if torch.is_tensor(span) else max(span, 1e-20)
    t = (p - lo) / span
    return torch.clamp(t * s, 0, s).to(torch.int32)


def ray_sort_keys(o3, d3, bounds_min, bounds_max, bits=7):
    """Coherence key per ray: 3-bit direction octant (major) + Morton code
    of the quantized origin (minor).  bounds_*: scene bbox, [3] tensors."""
    dx, dy, dz = d3
    octant = (
        (dx >= 0).to(torch.int32)
        | ((dy >= 0).to(torch.int32) << 1)
        | ((dz >= 0).to(torch.int32) << 2)
    )
    ix, iy, iz = (_quantize(o3[i], bounds_min[i], bounds_max[i], bits) for i in range(3))
    return (octant << (3 * bits)) | morton3(ix, iy, iz)


def ray_sort_keys_6d(o3, d3, bounds_min, bounds_max, obits=5, dbits=5):
    """6-D Morton key interleaving quantized direction and origin bits,
    MSB first (direction bits ahead of origin bits at each level)."""
    ix, iy, iz = (_quantize(o3[i], bounds_min[i], bounds_max[i], obits) for i in range(3))
    jx, jy, jz = (_quantize(d3[i], -1.0, 1.0, dbits) for i in range(3))
    key = torch.zeros_like(ix)
    for b in range(max(obits, dbits) - 1, -1, -1):
        for comp, bits in ((jx, dbits), (jy, dbits), (jz, dbits),
                           (ix, obits), (iy, obits), (iz, obits)):
            if b < bits:
                key = (key << 1) | ((comp >> b) & 1)
    return key


def sort_rays_for_traversal(o3, d3, bounds_min, bounds_max, bits=7):
    """Return (o3s, d3s, perm): rays permuted into coherence order by a
    stable sort of :func:`ray_sort_keys`.  Invert with ``out[perm] =
    result``."""
    perm = torch.argsort(ray_sort_keys(o3, d3, bounds_min, bounds_max, bits), stable=True)
    take = lambda t: tuple(c[perm] for c in t)  # noqa: E731
    return take(o3), take(d3), perm
