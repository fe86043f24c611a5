"""smallpt camera model and primary-ray generation.

The reference generates rays on the host in Python (scripts/gen_data.py:21-75):
camera at (50, 52, 295.6) looking along normalize(0, -0.042612, -1)
(gen_data.py:24-26), screen basis cx = (w*0.5135/h, 0, 0) and
cy = normalize(cx x dir) * 0.5135 (gen_data.py:28-29), a 2x2 sub-pixel grid
with tent-filter jitter from sequential ``np.random.rand()`` draws
(gen_data.py:34-44), ray origin pushed 140 units along the unnormalized
direction (gen_data.py:45).

:func:`generate_rays_numpy` is vectorized NumPy, **bit-identical** to the
reference's scalar loops (same float64 math, same MT19937 draw order:
for each sample r1 then r2, loop order i(width), j(height), sy, sx, s).
The port's own copy of the JAX package's ``camera`` module, without its
``jax.random`` ray generator.

Ray layout everywhere: float array [N, 6] = (ox, oy, oz, dx, dy, dz), with
N = w*h*4*s and sample index = ((i*h + j)*2 + sy)*2*s + sx*s + k.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CAMERA_POS = (50.0, 52.0, 295.6)  # gen_data.py:24
CAMERA_RAW_DIR = (0.0, -0.042612, -1.0)  # gen_data.py:25
FOV_SCALE = 0.5135  # gen_data.py:28-29
ORIGIN_PUSH = 140.0  # gen_data.py:45


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with smallpt conventions. All fields float64 scalars/
    triples; differentiable variants lift these into a pytree (diff/)."""

    pos: tuple = CAMERA_POS
    raw_dir: tuple = CAMERA_RAW_DIR
    fov_scale: float = FOV_SCALE
    origin_push: float = ORIGIN_PUSH

    def basis(self, width: int, height: int):
        """Return (pos, dir, cx, cy) as float64 numpy arrays
        (gen_data.py:24-29)."""
        pos = np.asarray(self.pos, np.float64)
        raw = np.asarray(self.raw_dir, np.float64)
        d = raw / np.linalg.norm(raw)
        cx = np.array([width * self.fov_scale / height, 0.0, 0.0])
        cross = np.cross(cx, d)
        cy = cross / np.linalg.norm(cross) * self.fov_scale
        return pos, d, cx, cy


def tent_filter(r: np.ndarray) -> np.ndarray:
    """Tent-filter inverse CDF: r in [0,2) -> offset in (-1,1)
    (gen_data.py:38,40)."""
    return np.where(r < 1, np.sqrt(r) - 1, 1 - np.sqrt(2 - r))


def generate_rays_numpy(
    width: int,
    height: int,
    samples: int,
    *,
    camera: Camera = Camera(),
    rng: np.random.RandomState | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Vectorized, bit-faithful port of the reference's ray generation.

    Returns float64 [N, 6]; callers cast to float32 at the IO boundary
    exactly as the reference does (gen_data.py:71 ``astype(np.float32)``).

    RNG contract: the reference draws, per sample, r1 = 2*rand() then
    r2 = 2*rand() (gen_data.py:37-40) in loop order i, j, sy, sx, sample.
    A single ``rand(N*2).reshape(N, 2)`` consumes the identical MT19937
    stream, so the output matches the scalar loop bit for bit.
    """
    if rng is None:
        rng = np.random.RandomState(seed)
    pos, d0, cx, cy = camera.basis(width, height)
    w, h, s = width, height, samples
    n = w * h * 2 * 2 * s

    u = rng.rand(n * 2).reshape(n, 2)
    r1 = 2.0 * u[:, 0]
    r2 = 2.0 * u[:, 1]
    dx = tent_filter(r1)
    dy = tent_filter(r2)

    # Index grids in reference loop order: i (width) outermost, then j
    # (height), sy, sx, sample (gen_data.py:32-36).
    i_idx, j_idx, sy, sx, _ = np.meshgrid(
        np.arange(w), np.arange(h), np.arange(2), np.arange(2), np.arange(s),
        indexing="ij",
    )
    i_idx = i_idx.reshape(-1).astype(np.float64)
    j_idx = j_idx.reshape(-1).astype(np.float64)
    sy = sy.reshape(-1).astype(np.float64)
    sx = sx.reshape(-1).astype(np.float64)

    # d = cx*(((sx+.5+dx)/2 + i)/w - .5) + cy*(((sy+.5+dy)/2 + j)/h - .5) + dir
    # (gen_data.py:41-43).
    su = ((sx + 0.5 + dx) / 2.0 + i_idx) / w - 0.5
    sv = ((sy + 0.5 + dy) / 2.0 + j_idx) / h - 0.5
    d = su[:, None] * cx[None, :] + sv[:, None] * cy[None, :] + d0[None, :]

    ray_pos = pos[None, :] + d * camera.origin_push  # gen_data.py:45
    norm = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2)
    ray_dir = d / norm[:, None]  # gen_data.py:46
    return np.concatenate([ray_pos, ray_dir], axis=1)
