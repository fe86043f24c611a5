"""Binary SoA file formats + PPM codec, reference-compatible.

File contracts (so artifacts interoperate with the reference pipeline):

- ``rays.bin``    — float32, 6 SoA planes (ox oy oz dx dy dz), plane
  stride N (gen_data.py:63-71 stores the [N,6] table transposed).
- ``spheres.bin`` — float32, 10 SoA planes (r^2 x y z ex ey ez cx cy cz),
  plane stride S, zero-padded so the byte size is a multiple of 512
  (gen_data.py:113-127; the kernel DMAs it as one 512B block,
  render.cpp:76-79).
- ``color.bin``   — float32, 3 SoA planes (r g b), plane stride N
  (main.cpp:40/79 writes the kernel's SoA color planes).
- ``*.ppm``       — ASCII P3. The reference writer iterates ``for i in
  range(w): for j in range(h): write(data[j, i])`` with one text line per
  i (data_visualization.py:11-17); we reproduce that raster order exactly
  so goldens diff cleanly.

The decode path (color.bin -> uint8 image) replicates
data_visualization.py:20-58: reshape (3, w, h, 4s) -> average the four
sub-pixels (mean over each group of s, then mean of the 4 groups) with a
vertical flip u = h-1-j -> clip [0,1] -> *255 -> uint8.
"""

from __future__ import annotations

import os

import numpy as np

from ascendpathtracing_tpu_torch.accel import native as native_mod
from ascendpathtracing_tpu_torch.scenes import SphereScene

RAY_PLANES = 6
SPHERE_PLANES = 10
COLOR_PLANES = 3


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)


# ---------------------------------------------------------------- rays ----
def write_rays_bin(rays: np.ndarray, path: str) -> None:
    """rays: [N, 6] -> 6-plane SoA float32 file (gen_data.py:65-71)."""
    rays = np.asarray(rays)
    if rays.ndim != 2 or rays.shape[1] != RAY_PLANES:
        raise ValueError(f"expected [N, 6] rays, got {rays.shape}")
    _ensure_dir(path)
    rays.T.astype(np.float32).tofile(path)


def read_rays_bin(path: str) -> np.ndarray:
    """-> float32 [N, 6]."""
    flat = np.fromfile(path, dtype=np.float32)
    if flat.size % RAY_PLANES:
        raise ValueError(f"{path}: size {flat.size} not divisible by 6")
    return flat.reshape(RAY_PLANES, -1).T.copy()


# -------------------------------------------------------------- spheres ----
def write_spheres_bin(scene: SphereScene, path: str) -> None:
    """10-plane SoA float32, padded with zeros to a 512B multiple
    (gen_data.py:120-127)."""
    planes = scene.soa10().reshape(-1)
    nbytes = planes.size * 4
    # gen_data.py:122 computes padding_size = 512 - current % 512, which is
    # a full extra 512B when already aligned; keep that exact behavior.
    pad = 512 - nbytes % 512
    planes = np.append(planes, np.zeros(pad // 4, np.float32))
    _ensure_dir(path)
    planes.astype(np.float32).tofile(path)


def read_spheres_bin(path: str, n_spheres: int | None = None) -> SphereScene:
    flat = np.fromfile(path, dtype=np.float32)
    if n_spheres is None:
        # The payload is 10*S floats followed by zero padding
        # (gen_data.py:120-127); trim trailing zeros to find S.
        nz = np.nonzero(flat)[0]
        last = int(nz[-1]) + 1 if nz.size else flat.size
        n_spheres = -(-last // SPHERE_PLANES)
    planes = flat[: SPHERE_PLANES * n_spheres].reshape(SPHERE_PLANES, n_spheres)
    return SphereScene.from_soa10(planes)


# ---------------------------------------------------------------- color ----
def write_color_bin(colors: np.ndarray, path: str) -> None:
    """colors: [N, 3] -> 3-plane SoA float32 file."""
    colors = np.asarray(colors)
    if colors.ndim != 2 or colors.shape[1] != COLOR_PLANES:
        raise ValueError(f"expected [N, 3] colors, got {colors.shape}")
    _ensure_dir(path)
    colors.T.astype(np.float32).tofile(path)


def read_color_bin(path: str) -> np.ndarray:
    """-> float32 [N, 3]."""
    flat = np.fromfile(path, dtype=np.float32)
    if flat.size % COLOR_PLANES:
        raise ValueError(f"{path}: size {flat.size} not divisible by 3")
    return flat.reshape(COLOR_PLANES, -1).T.copy()


# ---------------------------------------------------------------- decode ----
def decode_color_hdr(
    colors: np.ndarray, width: int, height: int, samples: int
) -> np.ndarray:
    """SoA colors -> float64 [w, h, 3] linear-radiance image (sub-pixel
    averaging + vertical flip, NO clip/quantization) — the shared decode
    core, also used to decode per-ray AOV planes (normals, albedo) into
    guide images for post-processing.

    ``colors`` may be [N, 3] (row layout from :func:`read_color_bin`) or
    the raw [3, N] plane layout.
    """
    colors = np.asarray(colors, np.float64)
    n = width * height * 4 * samples
    if colors.shape == (n, COLOR_PLANES):
        planes = colors.T
    elif colors.shape == (COLOR_PLANES, n):
        planes = colors
    else:
        raise ValueError(f"bad color shape {colors.shape} for n_rays={n}")
    # mean over each group of s, then mean of the 4 groups, on the
    # CONTIGUOUS trailing axis (reducing after the transpose+flip walks a
    # pathologically-strided view: measured 3 s vs 20 ms at 512x512)
    # [data_visualization.py:41-45]
    img = planes.reshape(COLOR_PLANES, width, height, 4, samples)
    # np.mean over a tiny trailing axis pays ~1 us per reduction in numpy
    # 2.x (2.7 s at 512x512); explicit slice-adds are vectorized over the
    # big leading axes and keep mean's sequential summation order.
    acc = img[..., 0].astype(np.float64, copy=True)
    for t in range(1, samples):
        acc += img[..., t]
    acc /= samples
    img = (acc[..., 0] + acc[..., 1] + acc[..., 2] + acc[..., 3]) / 4.0
    # (3, w, h) -> (w, h, 3) with vertical flip u = h-1-j
    # [data_visualization.py:22-27, 40]
    return np.ascontiguousarray(img.transpose(1, 2, 0)[:, ::-1, :])


def decode_color(
    colors: np.ndarray, width: int, height: int, samples: int
) -> np.ndarray:
    """SoA colors -> uint8 [w, h, 3] image, replicating
    data_visualization.py:20-58 (sub-pixel averaging + vertical flip),
    vectorized.
    """
    img = decode_color_hdr(colors, width, height, samples)
    img = np.clip(img, 0.0, 1.0) * 255.0  # data_visualization.py:54-56
    return img.astype(np.uint8)


# ------------------------------------------------------------------ ppm ----
def encode_ppm(image_u8: np.ndarray) -> str:
    """uint8 [w, h, 3] -> ASCII P3 string in the reference's raster order
    (data_visualization.py:11-17: line i holds data[j, i] for j in 0..h)."""
    img = np.asarray(image_u8)
    w, h, _ = img.shape
    lines = [f"P3\n{w} {h}\n255\n"]
    for i in range(w):
        row = img[:, i, :].reshape(-1)  # data[j, i] over j
        lines.append(" ".join(str(int(v)) for v in row) + " \n")
    return "".join(lines)


def write_ppm(image_u8: np.ndarray, path: str) -> None:
    _ensure_dir(path)
    with open(path, "w") as f:
        f.write(encode_ppm(image_u8))


def write_render_ppm(
    colors: np.ndarray, width: int, height: int, samples: int, path: str,
    *, native: str = "auto",
) -> np.ndarray:
    """decode_color + write_ppm in one step, using the native (C++) fused
    codec (``accel/native.py``) when its library builds (``native='auto'``;
    'never' forces Python, 'always' raises if the library is unavailable).
    The native codec takes square images only, as in the JAX package.
    Returns the decoded uint8 image either way.  Both paths write
    the same bytes (the same float64 summation order)."""
    if native not in ("auto", "never", "always"):
        raise ValueError(f"bad native mode {native!r}")
    colors = np.asarray(colors)
    n = width * height * 4 * samples
    planes = colors.T if colors.shape == (n, COLOR_PLANES) else colors
    if native != "never" and width == height:
        try:
            text = native_mod.encode_ppm_native(
                np.ascontiguousarray(planes, np.float32), width, height, samples
            )
        except native_mod.NativeUnavailable:
            if native == "always":
                raise
        else:
            _ensure_dir(path)
            with open(path, "w") as f:
                f.write(text)
            return decode_color(planes, width, height, samples)
    img = decode_color(planes, width, height, samples)
    write_ppm(img, path)
    return img


def read_ppm(path: str) -> np.ndarray:
    """ASCII P3 -> uint8 [w, h, 3] (inverse of :func:`encode_ppm`)."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path}: not an ASCII P3 PPM")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.array(tokens[4:], dtype=np.int64)
    if data.size != w * h * 3:
        raise ValueError(f"{path}: expected {w*h*3} values, got {data.size}")
    if maxval != 255:
        data = (data.astype(np.float64) * 255 / maxval).round().astype(np.int64)
    # encode order: outer i in 0..w, inner j in 0..h, value data[j, i]
    arr = data.reshape(w, h, 3)  # arr[i, j] == image[j, i]
    return arr.transpose(1, 0, 2).astype(np.uint8).copy()
