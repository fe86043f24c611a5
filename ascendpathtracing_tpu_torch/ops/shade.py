"""Shading ops of the reference mode (plain torch).

Counterpart of the reference half of ``ascendpathtracing_tpu/ops/shade.py``:
the scale-aware origin offset, vec3 helpers over SoA triples of [N]
planes, mirror reflection and the reference's specular bounce.  The
path-tracing BSDFs (diffuse, dielectric, Russian roulette) are not
ported yet.
"""

from __future__ import annotations

import torch

from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn

# Relative self-intersection offset, ~8 ulp of float32; see the JAX
# package's ops/shade.py for the measurement behind it.
REL_OFFSET = 1e-6
_REL_OFFSET_F64 = 8 * 2.0 ** -52


def rel_offset_for(dtype) -> float:
    """~8 ulp of the compute dtype: 1e-6 for float32, ~1.8e-15 for
    float64."""
    return _REL_OFFSET_F64 if dtype == torch.float64 else REL_OFFSET


def scaled_origin_offset(r2_winner, eps):
    """Per-ray origin offset max(eps, rel_offset_for(dtype) *
    sqrt(r2_winner)).  Detached: a robustness term, not part of the
    differentiable surface."""
    r2 = r2_winner.detach()
    return torch.maximum(
        torch.as_tensor(eps, dtype=r2.dtype, device=r2.device),
        rel_offset_for(r2.dtype) * torch.sqrt(r2),
    )


# ------------------------------------------------------------- vec3 SoA ----
def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def v3_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_where(m, a, b):
    return (
        torch.where(m, a[0], b[0]),
        torch.where(m, a[1], b[1]),
        torch.where(m, a[2], b[2]),
    )


def v3_normalize(a, eps=0.0):
    """Safe normalize: 0 where the squared norm is <= eps or inf (a missed
    ray's ~1e20 hit point overflows it in float32)."""
    n2 = v3_dot(a, a)
    inv = torch.where(n2 > eps, torch.rsqrt(n2), 0.0)
    return v3_scale(a, inv)


# ------------------------------------------------------------- BSDF ops ----
def reflect(d, n):
    """Mirror reflect: d' = d - 2 (d.n) n."""
    return v3_sub(d, v3_scale(n, 2.0 * v3_dot(d, n)))


def specular_bounce(o, d, tmin, center_hit):
    """The reference's bounce: hit = o + d*t; normal = normalize(hit -
    center); reflect.  SoA triples except tmin [N].  1/sqrt, not rsqrt,
    and the oracle's op order, for bitwise parity."""
    hx = o[0] + d[0] * tmin
    hy = o[1] + d[1] * tmin
    hz = o[2] + d[2] * tmin
    nx = hx - center_hit[0]
    ny = hy - center_hit[1]
    nz = hz - center_hit[2]
    n2 = nx * nx + ny * ny + nz * nz
    inv = torch.where(n2 > 0, 1.0 / sqrt_rn(n2), 0.0)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    dn = d[0] * nx + d[1] * ny + d[2] * nz
    td = 2.0 * dn
    return (hx, hy, hz), (d[0] - td * nx, d[1] - td * ny, d[2] - td * nz)
