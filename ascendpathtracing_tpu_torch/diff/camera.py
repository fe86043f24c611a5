"""The differentiable smallpt camera: the camera model of ``camera.py``
with its parameters as tensors and the whole ray build in torch.

Counterpart of ``ascendpathtracing_tpu/diff/camera.py``.  Square roots
go through ``ops.intersect.sqrt_rn`` (correctly rounded on the CPU, and
differentiable), and the direction is normalized with ``1 / sqrt`` where
JAX has ``rsqrt``, so the two agree to rounding.
"""

from __future__ import annotations

import torch

from ascendpathtracing_tpu_torch.camera import (
    CAMERA_POS,
    CAMERA_RAW_DIR,
    FOV_SCALE,
    ORIGIN_PUSH,
)
from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn


def CameraParams(pos=CAMERA_POS, raw_dir=CAMERA_RAW_DIR, fov=FOV_SCALE,
                 dtype=torch.float32, device="cpu"):
    """Camera parameters as a plain dict of tensors (``pos`` [3],
    ``raw_dir`` [3], ``fov`` []), which an optimizer treats like any
    other parameters."""
    return {
        "pos": torch.tensor(pos, dtype=dtype, device=device),
        "raw_dir": torch.tensor(raw_dir, dtype=dtype, device=device),
        "fov": torch.tensor(fov, dtype=dtype, device=device),
    }


def norm3(v):
    """The Euclidean norm of a [3] tensor, differentiably."""
    return sqrt_rn((v * v).sum())


def basis(params, width, height):
    """(unit direction, cx [3], cy [3]) of ``Camera.basis``
    (gen_data.py:24-29), differentiable in ``raw_dir`` and ``fov``; cx is
    axis-aligned, as in the smallpt model."""
    raw, fov = params["raw_dir"], params["fov"]
    dirn = raw / norm3(raw)
    cxx = width * fov / height
    zero = torch.zeros_like(cxx)
    cx = torch.stack([cxx, zero, zero])
    cross = torch.linalg.cross(cx, dirn)
    return dirn, cx, cross / norm3(cross) * fov


def camera_rays(params, width, height, samples, jitter=None, generator=None,
                origin_push=ORIGIN_PUSH):
    """[N, 6] rays (origin, unit direction) from the camera parameters,
    N = width * height * 4 * samples in the sample order of
    ``generate_rays_numpy`` (i, j, sy, sx, sample), differentiable in
    ``pos``, ``raw_dir`` and ``fov`` (gen_data.py:41-46: d = cx*su + cy*sv
    + dir, origin = pos + d * origin_push, direction = normalize(d)).

    ``jitter`` [N, 2] holds the tent-filter offsets in (-1, 1); when None
    they are drawn from ``generator`` (a ``torch.Generator``) as JAX draws
    them from its key, or are zeros without one."""
    w, h, s = width, height, samples
    n = w * h * 4 * s
    pos = params["pos"]
    dtype, device = pos.dtype, pos.device
    dirn, cx, cy = basis(params, w, h)

    idx = torch.arange(n, device=device)
    sx = ((idx // s) % 2).to(dtype)
    sy = ((idx // (2 * s)) % 2).to(dtype)
    j_idx = ((idx // (4 * s)) % h).to(dtype)
    i_idx = (idx // (4 * s * h)).to(dtype)

    if jitter is None:
        if generator is not None:
            r = 2.0 * torch.rand((n, 2), generator=generator, dtype=dtype, device=device)
            jitter = torch.where(r < 1, sqrt_rn(r) - 1,
                                 1 - sqrt_rn(torch.clamp_min(2 - r, 0.0)))
        else:
            jitter = torch.zeros((n, 2), dtype=dtype, device=device)

    su = ((sx + 0.5 + jitter[:, 0]) / 2.0 + i_idx) / w - 0.5
    sv = ((sy + 0.5 + jitter[:, 1]) / 2.0 + j_idx) / h - 0.5
    d = su[:, None] * cx[None, :] + sv[:, None] * cy[None, :] + dirn[None, :]
    o = pos[None, :] + d * origin_push
    dn = d * (1.0 / sqrt_rn((d * d).sum(dim=1, keepdim=True)))
    return torch.cat([o, dn], dim=1).to(dtype)
