"""Ray-sphere intersection over SoA planes (plain torch).

Counterpart of ``ascendpathtracing_tpu/ops/intersect.py``.  Ray state is
1-D ``[N]`` component planes and the hit matrix is ``[S, N]``.  The op
order is that of ``oracle.intersect_all_numpy``, element for element, so
results compare bitwise at equal dtype.  A miss is the 1e20 sentinel,
computed branch-free with a validity mask (no NaN is made, so autograd
stays finite).
"""

from __future__ import annotations

import numpy as np
import torch

MISS_T = 1e20


# The NumPy sqrt as the op ``aptport::sqrt_rn`` (CPU only), so that
# dispatch-level tools (utils/roofline.count_ops, utils/debug's float
# guard) see it as one op.
_LIB = torch.library.Library("aptport", "DEF")
_LIB.define("sqrt_rn(Tensor x) -> Tensor")
_LIB.impl("sqrt_rn", lambda x: torch.from_numpy(np.asarray(np.sqrt(x.numpy()))), "CPU")


class _SqrtRN(torch.autograd.Function):
    """Correctly rounded sqrt of a CPU tensor, through NumPy."""

    @staticmethod
    def forward(ctx, x):
        y = torch.ops.aptport.sqrt_rn(x.detach())  # 0-d too
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (2 * y)


def sqrt_rn(x):
    """IEEE round-to-nearest square root on every device.

    torch's CPU ``sqrt`` is not correctly rounded in every build (one
    measured CPU build is one ulp off for about 0.7% of float32 and
    float64 inputs), and one ulp decides near-ties between two spheres'
    hit distances, so the CPU path takes NumPy's sqrt, as the oracle
    does.  CUDA's ``sqrt`` is IEEE, as the kernels' is."""
    if x.device.type == "cpu":
        return _SqrtRN.apply(x)
    return torch.sqrt(x)


def intersect_spheres_soa(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2, eps):
    """N rays (six [N] planes) against S spheres (four [S] planes: center
    xyz and squared radius) -> t [S, N], 1e20 where missed."""
    ocx = cx[:, None] - ox[None, :]
    ocy = cy[:, None] - oy[None, :]
    ocz = cz[:, None] - oz[None, :]
    b = ocx * dx[None, :] + ocy * dy[None, :] + ocz * dz[None, :]
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2[:, None]
    det = b * b - c
    valid = det >= 0
    sq = sqrt_rn(torch.where(valid, det, 0.0))
    t0 = b - sq
    t1 = b + sq
    # eps is rounded to the compute dtype, as the oracle's f32(eps); made
    # on the device (a tensor copied from the host would wait for it)
    eps = torch.full((), eps, dtype=t0.dtype, device=t0.device)
    return torch.where(
        valid & (t0 > eps), t0, torch.where(valid & (t1 > eps), t1, MISS_T)
    )


def reduce_hit_soa(t):
    """Per-ray nearest hit: t [S, N] -> (tmin [N], hit [N] int32, miss [N]).

    ``torch.argmin`` returns the first minimal index, the reference's
    lowest-index tie-break."""
    hit = torch.argmin(t, dim=0).to(torch.int32)
    tmin = torch.amin(t, dim=0)
    miss = tmin >= torch.full((), MISS_T, dtype=t.dtype, device=t.device)
    return tmin, hit, miss


# -------------------------------------------------------- AoS wrappers ----
def intersect_spheres(o, d, centers, r2, eps):
    """AoS wrapper: o, d [N, 3]; centers [S, 3] -> t [N, S]."""
    t = intersect_spheres_soa(
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        centers[:, 0], centers[:, 1], centers[:, 2], r2, eps,
    )
    return t.T


def reduce_hit(t):
    """AoS wrapper: t [N, S] -> (tmin, hit, miss)."""
    return reduce_hit_soa(t.T)
