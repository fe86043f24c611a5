"""The fused sphere path tracer: CUDA wrapper and plain twin.

Counterpart of the path-tracing part of
``ascendpathtracing_tpu/ops/pallas_kernels.py`` (``render_pt_pallas``).
:func:`render_pt` checks its inputs, then:

- for tensors on the CPU, runs :func:`render_pt_plain` (plain torch ops
  written from the TPU kernel's semantics);
- for tensors on a CUDA device, launches ``render_pt_kernel`` of
  ``csrc/render_pt.cu`` on the current stream, adds one to
  ``LAUNCHES["pt"]``, and raises if the launch fails.  There is no
  fallback.

Either way the call runs inside the span ``apt.kernel.pt``
(``utils/profiling.span``).

Both follow the Pallas kernel's arithmetic (not the XLA estimator's): the
camera ray is made from the sample's own uniforms, the diffuse sample is
not renormalized, glass uses Schlick with a 1e-20 floor on the
normalisation, Russian roulette runs from ``rr_depth``, and the image is
the mean over the ``spp4`` sample layers, accumulated layer by layer.
Random numbers come from Philox4x32-10 (``ops/rng``) in place of the
TPU's hardware PRNG, so the port's images match the TPU's only
statistically; ``uniforms`` [spp4, 2 + 3 * bounces, W*H] replaces the
stream in parity tests (zeros give the Pallas interpreter's u = 0
estimator).

``debug=True`` is the Pallas kernel's debug dump: after each bounce, one
line ``pt_pallas alive: <n>.0`` on stdout, n the paths of grid cell (0,
0) (pixels [0, debug_tile) of sample layer 0; ``debug_tile`` is the
Pallas wrapper's ``tile``) that are still alive: their ray hit something
and Russian roulette kept them.  The kernel prints it with device printf
from its debug instantiation, the twin from torch; the image is the same.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ascendpathtracing_tpu_torch import camera
from ascendpathtracing_tpu_torch.ops import build, rng
from ascendpathtracing_tpu_torch.ops.intersect import (
    MISS_T,
    intersect_spheres_soa,
    reduce_hit_soa,
)
from ascendpathtracing_tpu_torch.ops.render_kernels import MAX_S, on_cpu
from ascendpathtracing_tpu_torch.ops.shade import REL_OFFSET, sqrt_rn, where_const
from ascendpathtracing_tpu_torch.utils.profiling import spanned

DIFF, REFR = 0, 2  # scenes.DIFF, scenes.REFR; any other code is a mirror
TWO_PI = 2.0 * 3.14159265358979  # the Pallas kernel's constant
IOR = 1.5
R0 = ((IOR - 1.0) * (IOR - 1.0)) / ((IOR + 1.0) * (IOR + 1.0))  # Schlick

#: Kernel launches, counted where the launch succeeded.
LAUNCHES = {"pt": 0}

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = (
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_double, ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_double), _P, ctypes.c_longlong, _P,
)

#: The Pallas wrappers' default ``tile``: pixels of a grid cell.
DEBUG_TILE = 2048


def reset_launches() -> None:
    LAUNCHES["pt"] = 0


def load_library() -> ctypes.CDLL:
    """Builds and loads ``csrc/render_pt.cu`` and declares its C
    interface; checks that its sizes match this module's."""
    lib = build.load("render_pt")
    if getattr(lib, "_apt_declared", False):
        return lib
    lib.apt_pt_max_spheres.argtypes = ()
    lib.apt_pt_max_spheres.restype = _I
    lib.apt_pt_error_string.argtypes = (_I,)
    lib.apt_pt_error_string.restype = ctypes.c_char_p
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"apt_render_pt_{suffix}")
        fn.argtypes = _SIGNATURE
        fn.restype = _I
    if lib.apt_pt_max_spheres() != MAX_S:
        raise RuntimeError(f"library MAX_S {lib.apt_pt_max_spheres()} != {MAX_S}")
    lib._apt_declared = True
    return lib


def camera_constants(width: int, height: int) -> tuple:
    """(px py pz dx0 dy0 dz0 cxx cyx cyy cyz push): ``Camera().basis`` and
    the origin push as Python floats, as ``render_pt_pallas`` passes them
    (each is rounded to the compute dtype where it is used)."""
    cam = camera.Camera()
    pos, d0, cx, cy = cam.basis(width, height)
    return (
        float(pos[0]), float(pos[1]), float(pos[2]),
        float(d0[0]), float(d0[1]), float(d0[2]),
        float(cx[0]), float(cy[0]), float(cy[1]), float(cy[2]),
        float(cam.origin_push),
    )


def n_uniforms(bounces: int) -> int:
    """Uniforms per sample: 2 for the camera, 3 per bounce."""
    return 2 + 3 * bounces


def check_inputs(scene_planes, materials, width, height, spp4, bounces, rr_depth, uniforms):
    """Checks render_pt's inputs -> (S, whether they lie on the CPU)."""
    if scene_planes.dtype not in _DTYPES:
        raise TypeError(f"scene planes must be float32 or float64, got {scene_planes.dtype}")
    if scene_planes.dim() != 2 or scene_planes.shape[0] != 10:
        raise ValueError(f"expected [10, S] scene planes, got {tuple(scene_planes.shape)}")
    s = scene_planes.shape[1]
    if not 1 <= s <= MAX_S:
        raise ValueError(f"scene has {s} spheres; the kernel takes 1..{MAX_S}")
    if materials.dtype != torch.int32:
        raise TypeError(f"materials must be int32, got {materials.dtype}")
    if tuple(materials.shape) != (s,):
        raise ValueError(f"expected materials [{s}], got {tuple(materials.shape)}")
    if width < 1 or height < 1 or width * height > 0xFFFFFFFF:
        raise ValueError(f"bad image size {width}x{height}")
    if spp4 < 4 or spp4 % 4:
        raise ValueError(f"spp4 must be a positive multiple of 4, got {spp4}")
    if bounces < 0 or rr_depth < 0:
        raise ValueError(f"bounces and rr_depth must be >= 0, got {bounces}, {rr_depth}")
    tensors = [scene_planes, materials]
    if uniforms is not None:
        want = (spp4, n_uniforms(bounces), width * height)
        if uniforms.dtype != scene_planes.dtype:
            raise TypeError(f"uniforms must be {scene_planes.dtype}, got {uniforms.dtype}")
        if tuple(uniforms.shape) != want:
            raise ValueError(f"expected uniforms {list(want)}, got {tuple(uniforms.shape)}")
        tensors.append(uniforms)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("scene planes, materials and uniforms must be contiguous")
    return s, on_cpu(*tensors)


# ------------------------------------------------------- plain twin ----
def sphere_hits(planes_pad, ox, oy, oz, dx, dy, dz, eps):
    """Nearest sphere of each ray -> (tmin, win): win is the sphere
    index, or S (the zero column of ``planes_pad`` [10, S + 1]) on a
    miss."""
    s_count = planes_pad.shape[1] - 1
    r2s, cx, cy, cz = planes_pad[0:4, :s_count]
    tmin, hit, miss = reduce_hit_soa(
        intersect_spheres_soa(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2s, eps)
    )
    return tmin, torch.where(miss, s_count, hit.long())


def surface(planes_pad, mat_pad, win, tmin, o3, d3, rows=None, slot=None):
    """What the shading needs from each ray's winner at distance tmin ->
    (hit point, unit normal, emission, albedo, r2, is_diff, is_refr), the
    kernels' ``Surface``.  Sphere ``win`` (``mat_pad[S]`` is -1); with
    ``rows`` [C*T, 24] and ``slot`` [N] (-1: no triangle), a triangle slot
    takes its row's unit normal, albedo, emission and one-hots and r2 = 0."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    hx, hy, hz = ox + dx * tmin, oy + dy * tmin, oz + dz * tmin
    w = planes_pad[:, win]
    m = mat_pad[win]
    nx, ny, nz = hx - w[1], hy - w[2], hz - w[3]
    n2 = nx * nx + ny * ny + nz * nz
    ninv = torch.where(n2 > 0, 1.0 / sqrt_rn(n2), 0.0)
    n = [nx * ninv, ny * ninv, nz * ninv]
    e = [w[4], w[5], w[6]]
    a = [w[7], w[8], w[9]]
    r2, is_diff, is_refr = w[0], m == DIFF, m == REFR
    if rows is not None:
        is_tri = slot >= 0
        row = rows[slot.clamp_min(0)].T  # [24, N]
        n = [torch.where(is_tri, row[13 + i], n[i]) for i in range(3)]
        a = [torch.where(is_tri, row[16 + i], a[i]) for i in range(3)]
        e = [torch.where(is_tri, row[19 + i], e[i]) for i in range(3)]
        r2 = torch.where(is_tri, 0.0, r2)
        is_diff = torch.where(is_tri, row[22] > 0.5, is_diff)
        is_refr = torch.where(is_tri, row[23] > 0.5, is_refr)
    return (hx, hy, hz), n, e, a, r2, is_diff, is_refr


def pad_scene(scene_planes, materials):
    """[10, S] planes and [S] materials -> [10, S + 1] planes with a zero
    column and int64 materials with -1 there (a miss's winner S)."""
    dtype, device = scene_planes.dtype, scene_planes.device
    planes_pad = torch.cat(
        [scene_planes, torch.zeros((10, 1), dtype=dtype, device=device)], dim=1
    )
    mat_pad = torch.cat(
        [materials.long(), torch.full((1,), -1, dtype=torch.long, device=device)]
    )
    return planes_pad, mat_pad


def alive_dump(label: str, tile: int):
    """The debug dump's alive line of a bounce as the twins print it:
    ``dump(k, alive)`` prints "<label>: <n>.0", n the paths of ``alive``
    [P] among the pixels [0, tile) (the Pallas kernel's float32 sum of its
    lanes)."""

    def dump(k, alive):
        print(f"{label}: {float(int(alive[:tile].sum()))}", flush=True)

    return dump


def _trace_layer(hit_fn, u, layer, i_idx, j_idx, *, width, height, spp4,
                 bounces, rr_depth, eps, cam, res=None, suv=None, dump=None):
    """One sample layer of every pixel -> radiance (lr, lg, lb), the
    kernels' ``camera_path`` and ``bounce_path`` as [P]-wide tensor ops.
    ``hit_fn(o3, d3, alive, layer, k)`` -> (tmin, ``surface(...)``, winner
    code) finds each ray's winner at bounce k.  A path that has ended
    keeps computing, masked (the Pallas kernel's lanes).  ``res`` = (wid
    [bounces, P], resv [bounces, 7, P]) views take the replay residuals:
    the winner code, albedo, emission and s = scl x RR weight on live
    bounces, -1 and zeros on dead ones; the ``suv`` [2, P] view the screen
    coordinates (su, sv) of the primary rays.  ``dump(k, alive)`` hears
    of the paths alive after each bounce (the debug dump)."""
    px, py, pz, dx0, dy0, dz0, cxx, cyx, cyy, cyz, push = cam
    s = spp4 // 4
    sy, sx = layer // (2 * s), (layer // s) % 2

    r1 = 2.0 * u[0]
    r2 = 2.0 * u[1]
    jx = torch.where(r1 < 1, sqrt_rn(r1) - 1.0, 1.0 - sqrt_rn(torch.clamp_min(2.0 - r1, 0.0)))
    jy = torch.where(r2 < 1, sqrt_rn(r2) - 1.0, 1.0 - sqrt_rn(torch.clamp_min(2.0 - r2, 0.0)))
    # Divide by tensors: torch on CUDA divides by a Python scalar as a
    # product with its rounded reciprocal, not the kernels' IEEE division,
    # which differs in the last bit where W or H is no power of two.
    w_t, h_t = (torch.tensor(float(n), dtype=i_idx.dtype, device=i_idx.device)
                for n in (width, height))
    su = (((sx + 0.5) + jx) / 2.0 + i_idx) / w_t - 0.5
    sv = (((sy + 0.5) + jy) / 2.0 + j_idx) / h_t - 0.5
    if suv is not None:
        suv[0] = su
        suv[1] = sv
    ddx = su * cxx + sv * cyx + dx0
    ddy = sv * cyy + dy0
    ddz = sv * cyz + dz0
    ox, oy, oz = px + ddx * push, py + ddy * push, pz + ddz * push
    inv = 1.0 / sqrt_rn(ddx * ddx + ddy * ddy + ddz * ddz)
    dx, dy, dz = ddx * inv, ddy * inv, ddz * inv

    zero = torch.zeros_like(dx)
    tr = tg = tb = torch.ones_like(dx)
    lr = lg = lb = zero
    alive = torch.ones(dx.shape, dtype=torch.bool, device=dx.device)
    for k in range(bounces):
        tmin, ((hx, hy, hz), (nx, ny, nz), (er, eg, eb), (ar, ag, ab), r2w,
               is_diff, is_refr), code = hit_fn((ox, oy, oz), (dx, dy, dz), alive, layer, k)
        miss = tmin >= MISS_T
        live = alive & ~miss

        dn = dx * nx + dy * ny + dz * nz
        into = dn < 0
        sgn = where_const(into, 1.0, -1.0, dx)
        nlx, nly, nlz = nx * sgn, ny * sgn, nz * sgn

        lr = torch.where(live, lr + tr * er, lr)
        lg = torch.where(live, lg + tg * eg, lg)
        lb = torch.where(live, lb + tb * eb, lb)

        uq = u[2 + 3 * k: 5 + 3 * k]
        # Diffuse: cosine hemisphere sample, not renormalized.
        phi = TWO_PI * uq[0]
        r2sq = sqrt_rn(uq[1])
        flip = nlx.abs() > 0.1
        axx = torch.where(flip, zero, 1.0)
        axy = torch.where(flip, 1.0, zero)
        ux, uy, uz = axy * nlz, (-axx) * nlz, axx * nly - axy * nlx
        un = 1.0 / sqrt_rn(torch.clamp_min(ux * ux + uy * uy + uz * uz, 1e-20))
        ux, uy, uz = ux * un, uy * un, uz * un
        vx, vy, vz = nly * uz - nlz * uy, nlz * ux - nlx * uz, nlx * uy - nly * ux
        cw = sqrt_rn(torch.clamp_min(1.0 - uq[1], 0.0))
        cphi = torch.cos(phi) * r2sq
        sphi = torch.sin(phi) * r2sq
        dfx = ux * cphi + vx * sphi + nlx * cw
        dfy = uy * cphi + vy * sphi + nly * cw
        dfz = uz * cphi + vz * sphi + nlz * cw

        # Mirror.
        td = 2.0 * dn
        dsx, dsy, dsz = dx - td * nx, dy - td * ny, dz - td * nz

        # Glass: IOR 1.5, Schlick.
        nnt = where_const(into, 1.0 / IOR, IOR, dx)
        ddn = dx * nlx + dy * nly + dz * nlz
        cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
        tir = cos2t < 0
        sqc = sqrt_rn(torch.clamp_min(cos2t, 0.0))
        coef = sgn * (ddn * nnt + sqc)
        tdx, tdy, tdz = dx * nnt - nx * coef, dy * nnt - ny * coef, dz * nnt - nz * coef
        tinv = 1.0 / sqrt_rn(torch.clamp_min(tdx * tdx + tdy * tdy + tdz * tdz, 1e-20))
        tdx, tdy, tdz = tdx * tinv, tdy * tinv, tdz * tinv
        cth = 1.0 - torch.where(into, -ddn, tdx * nx + tdy * ny + tdz * nz)
        re = R0 + (1.0 - R0) * cth * cth * cth * cth * cth
        pp = 0.25 + 0.5 * re
        pick = (uq[0] < pp) | tir
        rscale = torch.where(tir, 1.0, torch.where(pick, re / pp, (1.0 - re) / (1.0 - pp)))

        refr_pick = is_refr & ~pick
        ndx = torch.where(is_diff, dfx, torch.where(refr_pick, tdx, dsx))
        ndy = torch.where(is_diff, dfy, torch.where(refr_pick, tdy, dsy))
        ndz = torch.where(is_diff, dfz, torch.where(refr_pick, tdz, dsz))
        scl = torch.where(is_refr, rscale, 1.0)
        tr = torch.where(live, tr * ar * scl, tr)
        tg = torch.where(live, tg * ag * scl, tg)
        tb = torch.where(live, tb * ab * scl, tb)

        alive = live
        s_res = scl
        if k >= rr_depth:  # Russian roulette
            pmax = torch.clamp(torch.maximum(torch.maximum(tr, tg), tb), 0.1, 0.95)
            survive = uq[2] < pmax
            pinv = 1.0 / pmax
            tr = torch.where(survive, tr * pinv, tr)
            tg = torch.where(survive, tg * pinv, tg)
            tb = torch.where(survive, tb * pinv, tb)
            alive = live & survive
            s_res = scl * torch.where(survive, pinv, 1.0)
        if dump is not None:
            dump(k, alive)
        if res is not None:
            res[0][k] = torch.where(live, code, -1)
            for j, v in enumerate((ar, ag, ab, er, eg, eb, s_res)):
                res[1][k, j] = torch.where(live, v, 0.0)

        off = torch.where(is_refr, 0.0, torch.clamp_min(REL_OFFSET * sqrt_rn(r2w), eps))
        ox = torch.where(live, hx + nlx * off, ox)
        oy = torch.where(live, hy + nly * off, oy)
        oz = torch.where(live, hz + nlz * off, oz)
        dx = torch.where(live, ndx, dx)
        dy = torch.where(live, ndy, dy)
        dz = torch.where(live, ndz, dz)
    return lr, lg, lb


def render_layers(hit_fn, *, dtype, device, width, height, spp4, bounces,
                  rr_depth, eps, seed, uniforms, cam, res=None, suv=None, dump=None):
    """The per-pixel mean over ``spp4`` sample layers, accumulated layer
    by layer (memory stays at one layer's [W*H] planes) -> [3, W*H].
    ``res`` = (wid [bounces, spp4, W*H], resv [bounces, 7, spp4, W*H])
    takes the replay residuals of every layer, ``suv`` [2, spp4, W*H] the
    screen coordinates of its primary rays; ``dump(k, alive)`` hears of
    sample layer 0's paths alive after each bounce."""
    n_pix = width * height
    pix = torch.arange(n_pix, device=device)
    i_idx, j_idx = (pix // height).to(dtype), (pix % height).to(dtype)
    kw = dict(width=width, height=height, spp4=spp4, bounces=bounces,
              rr_depth=rr_depth, eps=eps, cam=cam)
    inv_spp = 1.0 / spp4
    acc = torch.zeros((3, n_pix), dtype=dtype, device=device)
    for a in range(spp4):
        u = uniforms[a] if uniforms is not None else rng.uniforms(
            seed, pix, a, n_uniforms(bounces), stream=rng.STREAM_FUSED, dtype=dtype
        )
        res_a = None if res is None else (res[0][:, a], res[1][:, :, a])
        lr, lg, lb = _trace_layer(hit_fn, u, a, i_idx, j_idx, res=res_a,
                                  suv=None if suv is None else suv[:, a],
                                  dump=dump if a == 0 else None, **kw)
        acc = acc + torch.stack((lr, lg, lb)) * inv_spp
    return acc


def render_pt_plain(scene_planes, materials, *, width, height, spp4, bounces=8,
                    rr_depth=5, eps=1e-4, seed=0, uniforms=None, debug=False,
                    debug_tile=DEBUG_TILE):
    """Plain twin of :func:`render_pt`: the kernel's arithmetic and
    random stream as torch ops, one sample layer at a time; ``debug``
    prints the dump's lines from torch."""
    planes_pad, mat_pad = pad_scene(scene_planes, materials)

    def hit_fn(o3, d3, alive, layer, k):
        tmin, win = sphere_hits(planes_pad, *o3, *d3, eps)
        return tmin, surface(planes_pad, mat_pad, win, tmin, o3, d3), win

    return render_layers(
        hit_fn, dtype=scene_planes.dtype, device=scene_planes.device,
        width=width, height=height, spp4=spp4, bounces=bounces,
        rr_depth=rr_depth, eps=eps, seed=seed, uniforms=uniforms,
        cam=camera_constants(width, height),
        dump=alive_dump("pt_pallas alive", debug_tile) if debug else None,
    )


def path_record_plain(scene_planes, materials, *, width, height, spp4, bounces=8,
                      rr_depth=5, eps=1e-4, seed=0, uniforms=None):
    """:func:`render_pt_plain`'s image with a record of its paths ->
    (image, queried, live, zero), each record [spp4, bounces, W*H] bool:
    ``queried`` where the path is still going at bounce k (its ray is
    traced), ``live`` where that ray hits a sphere (the bounce is taken),
    ``zero`` where the path is going with a throughput that is zero in all
    three channels, so that it adds exactly +0 to its radiance from there
    on: ``render_pt.cu``'s kernel ends it before that query.  Throughput
    counts as zero once each channel has met a zero albedo on a taken
    bounce (the glass and RR weights are finite), so ``zero`` is a lower
    bound of what the kernel's exit skips."""
    planes_pad, mat_pad = pad_scene(scene_planes, materials)
    shape = (spp4, bounces, width * height)
    device = scene_planes.device
    queried, live, zero = (torch.zeros(shape, dtype=torch.bool, device=device)
                           for _ in range(3))
    zeroed = {}

    def hit_fn(o3, d3, alive, layer, k):
        tmin, win = sphere_hits(planes_pad, *o3, *d3, eps)
        srf = surface(planes_pad, mat_pad, win, tmin, o3, d3)
        if k == 0:
            zeroed["rgb"] = torch.zeros((3,) + alive.shape, dtype=torch.bool, device=device)
        hit = alive & (tmin < MISS_T)
        queried[layer, k], live[layer, k] = alive, hit
        zero[layer, k] = alive & zeroed["rgb"].all(dim=0)
        zeroed["rgb"] |= hit & (torch.stack(srf[3]) == 0)
        return tmin, srf, win

    image = render_layers(
        hit_fn, dtype=scene_planes.dtype, device=device, width=width, height=height,
        spp4=spp4, bounces=bounces, rr_depth=rr_depth, eps=eps, seed=seed,
        uniforms=uniforms, cam=camera_constants(width, height),
    )
    return image, queried, live, zero


# ---------------------------------------------------------- wrapper ----
@spanned("apt.kernel.pt")
def render_pt(scene_planes, materials, *, width, height, spp4, bounces=8,
              rr_depth=5, eps=1e-4, seed=0, uniforms=None, debug=False,
              debug_tile=DEBUG_TILE):
    """Fully fused path trace: scene [10, S] (float32 or float64) and
    materials [S] int32 -> per-pixel means [3, W*H] in the scene's dtype.
    No ray input: each sample's camera ray is made from its uniforms.
    Pixel p is column p // height, row p % height; sample layer a is
    (sy, sx, k) = (a // (2s), (a // s) % 2, a % s) with s = spp4 / 4.
    ``debug`` prints the dump of the module's head (on a card the call
    returns once the lines are out)."""
    s_count, cpu = check_inputs(
        scene_planes, materials, width, height, spp4, bounces, rr_depth, uniforms
    )
    if debug_tile < 1:
        raise ValueError(f"debug_tile must be >= 1, got {debug_tile}")
    kw = dict(width=width, height=height, spp4=spp4, bounces=bounces,
              rr_depth=rr_depth, eps=eps, seed=seed, uniforms=uniforms,
              debug=debug, debug_tile=debug_tile)
    if cpu:
        return render_pt_plain(scene_planes, materials, **kw)
    out = torch.empty((3, width * height), dtype=scene_planes.dtype,
                      device=scene_planes.device)
    alive = torch.zeros((bounces,), dtype=torch.int32, device=out.device) if debug else None
    cam = (ctypes.c_double * 11)(*camera_constants(width, height))
    lib = load_library()
    if debug:
        sys.stdout.flush()  # Python's lines before the kernel's
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, f"apt_render_pt_{_DTYPES[out.dtype]}")(
            scene_planes.data_ptr(), materials.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(), out.data_ptr(),
            width, height, spp4, s_count, bounces, rr_depth, eps,
            seed & 0xFFFFFFFF, cam, None if alive is None or bounces == 0 else alive.data_ptr(),
            debug_tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"apt_render_pt: CUDA error {err} ({lib.apt_pt_error_string(err).decode()})"
        )
    LAUNCHES["pt"] += 1
    return out
