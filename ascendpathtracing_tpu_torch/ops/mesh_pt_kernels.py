"""The fused sphere+mesh path tracer: CUDA wrapper, plain twin and tables.

Counterpart of ``ascendpathtracing_tpu/ops/pallas_mesh_pt.py``
(``render_pt_mesh_pallas`` and its kernel ``_mesh_pt_kernel``; forward
only: the residual, camera, stats and debug outputs are not ported).
:func:`render_pt_mesh` checks its inputs, then:

- for tensors on the CPU, runs :func:`render_pt_mesh_plain`;
- for tensors on a CUDA device, launches ``render_pt_mesh_kernel`` of
  ``csrc/mesh_pt.cu`` on the current stream, adds one to
  ``LAUNCHES["mesh_pt"]``, and raises if the launch fails.  There is no
  fallback.

The estimator is the sphere path tracer's (``ops/pt_kernels``: camera,
Philox stream keyed as ``render_pt`` keys its own, diffuse/mirror/glass,
Russian roulette, the mean over ``spp4`` layers) with a mesh: each
bounce the spheres run first, then the chunk-grid walk gated by the tmin
after the spheres (``ops/wbvh_kernels.walk_plain``); a triangle needs a
strictly smaller t.  A triangle winner shades with its row's unit
normal, albedo, emission and material one-hots and an origin offset of
eps.  A mesh that no ray reaches gives ``render_pt``'s image bit for
bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ascendpathtracing_tpu_torch.host import scenes
from ascendpathtracing_tpu_torch.ops import build, pt_kernels
from ascendpathtracing_tpu_torch.ops import chunk_grid as cg
from ascendpathtracing_tpu_torch.ops.render_kernels import MAX_S, on_cpu
from ascendpathtracing_tpu_torch.ops.wbvh_kernels import (
    check_grid,
    plain_grid,
    walk_plain,
)

TRI_PT_F = cg.TRI_ATTR_F  # 24: 13 intersection + 11 shading floats

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"mesh_pt": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = (_P,) * 8 + (_I,) * 12 + (
    ctypes.c_double, ctypes.c_uint32, ctypes.POINTER(ctypes.c_double), _P,
)


def reset_launches() -> None:
    LAUNCHES["mesh_pt"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/mesh_pt.cu`` and declares its C interface;
    checks that its sizes match this module's."""
    lib = build.load("mesh_pt")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_mesh_pt_max_spheres.argtypes = ()
    lib.apt_mesh_pt_max_spheres.restype = _I
    lib.apt_mesh_pt_error_string.argtypes = (_I,)
    lib.apt_mesh_pt_error_string.restype = ctypes.c_char_p
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"apt_render_pt_mesh_{suffix}")
        fn.argtypes = _SIGNATURE
        fn.restype = _I
    if lib.apt_mesh_pt_max_spheres() != MAX_S:
        raise RuntimeError(f"library MAX_S {lib.apt_mesh_pt_max_spheres()} != {MAX_S}")
    lib._apt_declared = True
    return lib


# ------------------------------------------------------------ tables ----
def pack_mesh_for_pt(grid: cg.ChunkGrid, ms) -> np.ndarray:
    """ChunkGrid + MeshScene -> [C*T, 24] slot-ordered rows
    (``chunk_grid.attr_triangle_rows``)."""
    return cg.attr_triangle_rows(
        grid, ms.face_albedo, ms.face_emission, ms.face_material,
        diff_code=scenes.DIFF, refr_code=scenes.REFR,
    )


def mesh_pt_tables(ms, *, tris_per_chunk: int = 16, supers_per: int | None = None,
                   supers2_per: int | None = None, device="cpu",
                   dtype=torch.float32):
    """MeshScene -> (scene_planes [10, S] in ``dtype``, cboxes [C, 6],
    sboxes [Cs, 6], tris24 [C*T, 24] (float32 tensors on ``device``),
    materials [S] int32, grid (the NumPy ChunkGrid)).

    ``supers_per`` defaults to 16 once the chunk count reaches 128 and
    ``supers2_per`` to 16 once the super count reaches 256, as the JAX
    package's ``mesh_pt_tables``.  :func:`pt_tables_kwargs` gives the
    grid's keyword arguments for :func:`render_pt_mesh`."""
    faces = np.asarray(ms.faces)
    supers_per, auto2 = cg.auto_levels(faces.shape[0], tris_per_chunk, supers_per)
    if supers2_per is None:
        supers2_per = auto2
    grid = cg.build_chunk_grid(
        ms.vertices, faces, tris_per_chunk=tris_per_chunk,
        supers_per=supers_per, supers2_per=supers2_per,
    )
    tensor = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return (
        torch.tensor(ms.spheres.soa10(np.float64), dtype=dtype, device=device),
        tensor(grid.cboxes), tensor(grid.sboxes), tensor(pack_mesh_for_pt(grid, ms)),
        torch.tensor(ms.spheres.material, dtype=torch.int32, device=device),
        grid,
    )


def pt_tables_kwargs(grid: cg.ChunkGrid, device="cpu") -> dict:
    """The grid's keyword arguments for :func:`render_pt_mesh` (and
    ``wbvh_kernels.intersect_chunks``): one place, so no call site
    forgets the third level."""
    kw = dict(tris_per_chunk=grid.tris_per_chunk, supers_per=grid.supers_per)
    if grid.n_supers2:
        kw["ssboxes"] = torch.tensor(grid.ssboxes, device=device)
        kw["supers2_per"] = grid.supers2_per
    return kw


def camera_vector(cam, width, height) -> tuple:
    """The 11-float camera (px py pz, unit direction, cx.x, cy xyz,
    origin push) as Python floats; ``None`` is the default smallpt camera,
    as ``pt_kernels.camera_constants`` builds it."""
    if cam is None:
        return pt_kernels.camera_constants(width, height)
    vals = (cam.detach().cpu().double().reshape(-1).tolist()
            if isinstance(cam, torch.Tensor) else [float(x) for x in cam])
    if len(vals) != 11:
        raise ValueError(f"cam must be an 11-float camera vector, got {len(vals)}")
    return tuple(vals)


def _check(scene_planes, materials, cboxes, sboxes, ssboxes, tris24, *, width,
           height, spp4, bounces, rr_depth, uniforms, tris_per_chunk,
           supers_per, supers2_per):
    # The sphere-side checks are render_pt's.
    s_count, _ = pt_kernels.check_inputs(scene_planes, materials, width, height,
                                         spp4, bounces, rr_depth, uniforms)
    grid = check_grid(cboxes, sboxes, ssboxes, tris24,
                      tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                      supers2_per=supers2_per, widths=(TRI_PT_F,))
    tensors = [scene_planes, materials, cboxes, sboxes, grid[3], tris24]
    if uniforms is not None:
        tensors.append(uniforms)
    return s_count, grid, on_cpu(*tensors)


# ------------------------------------------------------- plain twin ----
def render_pt_mesh_plain(scene_planes, cboxes, sboxes, tris24, ssboxes=None, *,
                         materials, width, height, spp4, tris_per_chunk,
                         supers_per=0, supers2_per=0, bounces=8, rr_depth=5,
                         eps=1e-4, seed=0, cam=None, uniforms=None):
    """Plain twin of :func:`render_pt_mesh`: the kernel's arithmetic and
    random stream as torch ops, one sample layer at a time; the mesh is
    walked for the live paths only."""
    *_, ssboxes = check_grid(cboxes, sboxes, ssboxes, tris24,
                             tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                             supers2_per=supers2_per, widths=(TRI_PT_F,))
    dtype = scene_planes.dtype
    planes_pad, mat_pad = pt_kernels.pad_scene(scene_planes, materials)
    grid = plain_grid(cboxes, sboxes, ssboxes, tris24, dtype,
                      tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                      supers2_per=supers2_per)

    def hit_fn(o3, d3, alive):
        tmin, win = pt_kernels.sphere_hits(planes_pad, *o3, *d3, eps)
        slot = torch.full(tmin.shape, -1, dtype=torch.int64, device=tmin.device)
        ids = alive.nonzero()[:, 0]
        if ids.numel():
            tsub = tmin[ids]
            gate = tsub.clone()  # the tmin after the spheres, before the triangles
            slot[ids] = walk_plain(grid, tuple(c[ids] for c in o3),
                                   tuple(c[ids] for c in d3), tsub, eps=eps, gate=gate)
            tmin = tmin.index_put((ids,), tsub)
        return tmin, pt_kernels.surface(planes_pad, mat_pad, win, tmin, o3, d3,
                                        grid.rows, slot)

    return pt_kernels.render_layers(
        hit_fn, dtype=dtype, device=scene_planes.device, width=width,
        height=height, spp4=spp4, bounces=bounces, rr_depth=rr_depth, eps=eps,
        seed=seed, uniforms=uniforms, cam=camera_vector(cam, width, height),
    )


# ---------------------------------------------------------- wrapper ----
def render_pt_mesh(scene_planes, cboxes, sboxes, tris24, ssboxes=None, *,
                   materials, width, height, spp4, tris_per_chunk,
                   supers_per=0, supers2_per=0, bounces=8, rr_depth=5,
                   eps=1e-4, seed=0, cam=None, uniforms=None):
    """Fully fused sphere+mesh path trace: scene [10, S] (float32 or
    float64; the compute dtype), materials [S] int32, a chunk grid of
    float32 boxes and [C*T, 24] rows (``mesh_pt_tables``) -> per-pixel
    means [3, W*H] in the scene's dtype.  ``cam`` is the 11-float camera
    vector (None: the default smallpt camera); ``uniforms`` [spp4, 2 + 3 *
    bounces, W*H] replaces the Philox stream.  Pixel p is column p //
    height, row p % height; sample layer a is (sy, sx, k) = (a // (2s),
    (a // s) % 2, a % s) with s = spp4 / 4."""
    s_count, (c, cs, css, ssboxes), cpu = _check(
        scene_planes, materials, cboxes, sboxes, ssboxes, tris24, width=width,
        height=height, spp4=spp4, bounces=bounces, rr_depth=rr_depth,
        uniforms=uniforms, tris_per_chunk=tris_per_chunk, supers_per=supers_per,
        supers2_per=supers2_per,
    )
    cam_vals = camera_vector(cam, width, height)
    kw = dict(materials=materials, width=width, height=height, spp4=spp4,
              tris_per_chunk=tris_per_chunk, supers_per=supers_per,
              supers2_per=supers2_per, bounces=bounces, rr_depth=rr_depth,
              eps=eps, seed=seed, cam=cam_vals, uniforms=uniforms)
    if cpu:
        return render_pt_mesh_plain(scene_planes, cboxes, sboxes, tris24, ssboxes, **kw)
    out = torch.empty((3, width * height), dtype=scene_planes.dtype,
                      device=scene_planes.device)
    lib = load_library()

    def ptr(t):
        return None if t.numel() == 0 else t.data_ptr()

    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, f"apt_render_pt_mesh_{_DTYPES[out.dtype]}")(
            scene_planes.data_ptr(), materials.data_ptr(), cboxes.data_ptr(),
            ptr(sboxes), ptr(ssboxes), tris24.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(), out.data_ptr(),
            width, height, spp4, s_count, c, cs, css, tris_per_chunk,
            supers_per, supers2_per, bounces, rr_depth, eps, seed & 0xFFFFFFFF,
            (ctypes.c_double * 11)(*cam_vals), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"apt_render_pt_mesh: CUDA error {err} "
            f"({lib.apt_mesh_pt_error_string(err).decode()})"
        )
    LAUNCHES["mesh_pt"] += 1
    return out
