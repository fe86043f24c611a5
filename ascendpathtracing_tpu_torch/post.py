"""Image post-processing: firefly clamping, tone mapping, edge-aware
denoising.  The port of ``ascendpathtracing_tpu/post.py``.

Plain torch on the tensor's device: the JAX package runs these in XLA,
outside any Pallas kernel, so they have no hand kernel here.  Images are
[W, H, C] tensors; the arithmetic is the JAX package's op for op, in the
input's dtype, except the denoiser, which computes in float32 as JAX's
does and returns the input's dtype.

The pipeline ``cli render --denoise --tonemap aces`` runs:

    colors  = firefly_clamp(colors, k)            # per-sample, pre-decode
    img     = io.decode_color_hdr(colors, w, h, s)
    img     = atrous_denoise(img, normal=n_img, depth=z_img, albedo=a_img)
    img     = tonemap_aces(img, exposure)
    u8      = to_u8(gamma_encode(img))
"""

from __future__ import annotations

import numpy as np
import torch


def _const(value: float, like):
    """``value`` as a 0-d tensor on ``like``'s device and dtype.  torch on
    CUDA divides by a Python scalar (or a CPU scalar tensor) as a product
    with its rounded reciprocal; a divisor on the device keeps IEEE
    division, as XLA's."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------- clamp ----
def firefly_clamp(colors, max_radiance: float = 10.0):
    """Clamp per-sample radiance to bound outlier variance ("fireflies").

    Biased (energy loss on clamped paths); apply BEFORE sub-pixel
    averaging so one hot sample cannot dominate its pixel.  ``colors``:
    [N, 3] per-ray radiance."""
    lum = 0.2126 * colors[:, 0] + 0.7152 * colors[:, 1] + 0.0722 * colors[:, 2]
    scale = torch.where(
        lum > max_radiance, _const(max_radiance, lum) / torch.clamp_min(lum, 1e-12), 1.0
    )
    return colors * scale[:, None]


# -------------------------------------------------------------- tonemap ----
def tonemap_reinhard(img, exposure: float = 1.0):
    """Reinhard global operator x/(1+x) on exposed linear radiance."""
    x = img * exposure
    return x / (1.0 + x)


def tonemap_aces(img, exposure: float = 1.0):
    """ACES filmic fit (Narkowicz 2015)."""
    x = img * exposure
    return torch.clamp(
        (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0
    )


def gamma_encode(img, gamma: float = 2.2):
    """Linear -> display-encoded (the 1/2.2 curve of smallpt)."""
    return torch.pow(torch.clamp(img, 0.0, 1.0), 1.0 / gamma)


def to_u8(img) -> np.ndarray:
    """[0,1] float image -> uint8 NumPy array with round-half-away, as
    smallpt's ``int(x*255+.5)``."""
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).cpu().numpy().astype(np.uint8)


# -------------------------------------------------------------- denoise ----
def _shift2(x, dy: int, dx: int):
    """Static 2-D shift with edge replication: result[i,j] = x[i+dy, j+dx]
    (clamped)."""
    h, w = x.shape[0], x.shape[1]
    rows = (torch.arange(h, device=x.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


# B3-spline 5-tap weights (1,4,6,4,1)/16, separable
_H5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def atrous_denoise(
    img,
    normal=None,
    depth=None,
    albedo=None,
    *,
    iterations: int = 3,
    sigma_color: float = 0.4,
    sigma_normal: float = 0.35,
    sigma_depth: float = 0.02,
):
    """Edge-aware a-trous wavelet denoiser (Dammertz et al. 2010).

    Args:
      img:    [W, H, 3] linear radiance (decoded, pre-tonemap).
      normal: optional [W, H, 3] first-hit shading normals (unit).
      depth:  optional [W, H] or [W, H, 1] first-hit depth, normalized by
              its max so ``sigma_depth`` is scene-scale-free.
      albedo: optional [W, H, 3] first-hit albedo: the filter denoises
        irradiance (img / albedo) and re-modulates at the end.
      iterations: a-trous levels; the footprint grows as 2^iterations.
      sigma_*: edge-stopping strengths (the color sigma halves each
        level).

    Per-tap weight: h_q * exp(-|c_p-c_q|^2/s_c) * max(0,n_p.n_q)^(1/s_n)
    * exp(-|z_p-z_q|^2/s_d^2), normalized over the 25 taps."""
    orig_dtype = img.dtype
    c = img.to(torch.float32)
    if albedo is not None:
        alb = torch.clamp_min(albedo.to(torch.float32), 1e-3)
        c = c / alb
    if depth is not None:
        z = depth.to(torch.float32)
        z = z[..., 0] if z.dim() == 3 else z
        z = z / torch.clamp_min(torch.max(z), 1e-12)
    if normal is not None:
        nrm = normal.to(torch.float32)

    sc = float(sigma_color)
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(c)
        wsum = torch.zeros(c.shape[:2] + (1,), dtype=torch.float32, device=c.device)
        for iy, hy in enumerate(_H5):
            for ix, hx in enumerate(_H5):
                dy, dx = (iy - 2) * step, (ix - 2) * step
                cq = _shift2(c, dy, dx)
                dc2 = torch.sum((c - cq) ** 2, dim=-1)
                w = torch.exp(-dc2 / _const(max(sc * sc, 1e-12), dc2))
                if normal is not None:
                    ndot = torch.clamp(
                        torch.sum(nrm * _shift2(nrm, dy, dx), dim=-1), 0.0, 1.0
                    )
                    w = w * ndot ** (1.0 / max(sigma_normal, 1e-3))
                if depth is not None:
                    dz = z - _shift2(z, dy, dx)
                    w = w * torch.exp(-(dz * dz) / _const(sigma_depth * sigma_depth, dz))
                w = (hy * hx) * w
                acc = acc + cq * w[..., None]
                wsum = wsum + w[..., None]
        c = acc / torch.clamp_min(wsum, 1e-12)
        sc = sc * 0.5  # tighter color gate at coarser levels

    if albedo is not None:
        c = c * alb
    return c.to(orig_dtype)
