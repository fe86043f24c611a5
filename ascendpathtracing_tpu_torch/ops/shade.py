"""Shading ops (plain torch).

Counterpart of ``ascendpathtracing_tpu/ops/shade.py``: the scale-aware
origin offset, vec3 helpers over SoA triples of [N] planes, mirror
reflection, the reference's specular bounce, and the path-tracing BSDFs
of the ``pt`` mode (cosine-weighted diffuse, Schlick dielectric, Russian
roulette), op for op as the JAX versions.
"""

from __future__ import annotations

import math

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
        torch.full((), eps, dtype=r2.dtype, device=r2.device),
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


def where_const(m, a: float, b: float, like):
    """``where(m, a, b)`` of two Python floats, in ``like``'s dtype (JAX's
    weak-typed ``jnp.where(m, 1.0, -1.0)``).  The constants are made on
    the device: a tensor copied from the host would wait for it."""
    t = lambda v: torch.full((), v, dtype=like.dtype, device=like.device)  # noqa: E731
    return torch.where(m, t(a), t(b))


def cosine_sample_hemisphere(nl, u1, u2):
    """Cosine-weighted direction about the oriented unit normal ``nl``
    (smallpt's w/u/v frame); u1, u2 uniform [N] in [0, 1)."""
    r1 = (2.0 * math.pi) * u1
    r2s = sqrt_rn(u2)
    w = nl
    flip = w[0].abs() > 0.1
    zero = torch.zeros_like(w[0])
    a = (where_const(flip, 0.0, 1.0, zero), where_const(flip, 1.0, 0.0, zero), zero)
    u = v3_normalize(v3_cross(a, w))
    v = v3_cross(w, u)
    d = v3_add(
        v3_add(v3_scale(u, torch.cos(r1) * r2s), v3_scale(v, torch.sin(r1) * r2s)),
        v3_scale(w, sqrt_rn(torch.clamp_min(1.0 - u2, 0.0))),
    )
    return v3_normalize(d)


def refract_or_reflect(d, n, into, uniform, ior=1.5):
    """smallpt REFR: dielectric with Schlick Fresnel.  d = incident
    direction, n = geometric unit normal, into = d.n < 0, uniform [N] in
    [0, 1) -> (new direction, throughput scale) with smallpt's 1/p
    weight."""
    sign = where_const(into, 1.0, -1.0, d[0])
    nl = v3_scale(n, sign)  # oriented against the ray
    nnt = where_const(into, 1.0 / ior, ior, d[0])
    ddn = v3_dot(d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0

    refl = reflect(d, n)
    sqrt_c = sqrt_rn(torch.clamp_min(cos2t, 0.0))
    tdir = v3_normalize(
        v3_sub(v3_scale(d, nnt), v3_scale(n, sign * (ddn * nnt + sqrt_c)))
    )
    a = ior - 1.0
    b = ior + 1.0
    r0 = (a * a) / (b * b)
    c = 1.0 - torch.where(into, -ddn, v3_dot(tdir, n))
    re = r0 + (1.0 - r0) * c * c * c * c * c
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    pick_refl = (uniform < p) | tir
    new_d = v3_where(pick_refl, refl, tdir)
    scale = torch.where(tir, 1.0, torch.where(pick_refl, re / p, tr / (1.0 - p)))
    return new_d, scale


def russian_roulette(throughput, u, p_min=0.1, p_max=0.95):
    """Continue with probability p = clamp(max component); survivors get
    throughput / p.  -> (new throughput, survive mask)."""
    p = torch.clamp(
        torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2]),
        p_min, p_max,
    )
    survive = u < p
    inv = 1.0 / p
    return v3_where(survive, v3_scale(throughput, inv), throughput), survive
