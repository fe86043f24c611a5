"""Wavefront path tracers: a fixed pool of rays streams the sample set.

Counterpart of ``ascendpathtracing_tpu/models/wavefront.py``.  A pool of
``pool`` rays traces the frame's width x height x spp4 samples one bounce
per iteration: after each bounce the rays that end add their radiance to
the image, one stable sort packs the live rays to the front of the pool
(the compaction), and fresh camera samples, numbered from a global
sample counter, refill the empty slots (the regeneration).  The pool's
memory does not grow with the sample count.

- :func:`render_wavefront`: spheres, through ``models/megakernel``'s
  bounce (:func:`~ascendpathtracing_tpu_torch.models.megakernel.pt_bounce`).
- :func:`render_wavefront_mesh`: spheres + a triangle mesh, through
  ``models/mesh.pt_mesh_bounce``, whose nearest-triangle query launches
  ``csrc/wbvh.cu`` (``chunks`` tables) or ``csrc/bvh.cu`` (``lockstep``)
  on a card, one launch per iteration; the compaction key may lead with
  a 6-D Morton code of the rays (``coherence_sort``) and the compaction
  may run every ``sort_every``-th iteration only.

The image scatter is ``ops/histogram_kernels.segment_rows_matmul`` into a
float64 [W*H, 3] accumulator: ``csrc/segsum.cu`` on a card, one launch
per iteration, whose sums repeat bit for bit (no float atomics), so the
image does too (``segment_rows_paged`` sums with the same kernel and
adds an occupancy count, which the image does not need).
:data:`STATS` holds the last render's pool iterations.  The pool lives on the device of the scene's tensors, in
float32 as in the JAX package (float64 is taken for tests).

Random numbers: the camera jitter of sample k comes from the camera
stream of ``ops/rng`` at (seed, k), its bounce b from the estimator
stream at (seed, k, b), b counting the sample's own live bounces.  So
every sample's path is a pure function of its index, the same as
``megakernel.render_pt_impl`` (``models/mesh.render_pt_mesh_impl``) traces
for ray k of the wavefront's camera rays, and the image depends on
neither pool size, iteration order, compaction order, ``coherence_sort``
nor ``sort_every``, up to the order of the image's additions.  The JAX
package draws its bounce uniforms per pool slot and iteration; a caller
may pass those draws (``uniforms=``) to trace the JAX schedule.
"""

from __future__ import annotations

import torch

from ascendpathtracing_tpu_torch.camera import Camera
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.models import mesh as mesh_mod
from ascendpathtracing_tpu_torch.ops import histogram_kernels, rng, shade
from ascendpathtracing_tpu_torch.ops import sort as sort_mod
from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn

# The Cornell box's extent: the Morton key's bounds where the tables
# carry none (wavefront.py:279-283 of the JAX package).
CORNELL_LO, CORNELL_HI = (0.0, 0.0, 0.0), (100.0, 82.0, 180.0)
_DEAD = 1 << 30  # the compaction key's dead flag, above a 30-bit Morton code

#: The pool's iterations in the last render (of either renderer).
STATS = {"iterations": 0}


def _sample_camera_rays(sample_idx, width, height, spp4, seed, cam: Camera, dtype,
                        uniforms=None):
    """Camera rays of global sample indices [P] (int64) -> (o3, d3, pixel,
    sample_in_pixel), in the layout of ``camera.generate_rays_numpy``:
    index = ((i*h + j)*2 + sy)*2*s + sx*s + k, so pixel = i*h + j and a
    pixel's samples are contiguous.  The tent-filter jitter takes
    ``uniforms`` [P, 2] in [0, 1), or else the camera stream of
    ``ops/rng`` at (``seed``, index)."""
    # the basis as Python floats: each op rounds them to dtype, as a tensor
    # of dtype would be, without a copy from the host that waits for it
    pos, d0, cx, cy = (v.tolist() for v in cam.basis(width, height))
    s = spp4 // 4
    idx = sample_idx
    sx = (idx // s) % 2
    sy = (idx // (2 * s)) % 2
    j_idx = (idx // (4 * s)) % height
    i_idx = idx // (4 * s * height)
    if uniforms is None:
        u = rng.uniforms(seed, idx, 0, 2, stream=rng.STREAM_CAMERA, dtype=dtype)
    else:
        u = uniforms.T.to(dtype)
    r1 = 2.0 * u[0]
    r2 = 2.0 * u[1]
    dx = torch.where(r1 < 1, sqrt_rn(r1) - 1, 1 - sqrt_rn(torch.clamp_min(2 - r1, 0.0)))
    dy = torch.where(r2 < 1, sqrt_rn(r2) - 1, 1 - sqrt_rn(torch.clamp_min(2 - r2, 0.0)))

    su = ((sx.to(dtype) + 0.5 + dx) / 2.0 + i_idx.to(dtype)) / width - 0.5
    sv = ((sy.to(dtype) + 0.5 + dy) / 2.0 + j_idx.to(dtype)) / height - 0.5
    d = tuple(su * cx[c] + sv * cy[c] + d0[c] for c in range(3))
    o3 = tuple(pos[c] + d[c] * cam.origin_push for c in range(3))
    inv = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    pixel = (i_idx * height + j_idx).to(torch.int32)
    sample_in_pixel = (idx % (4 * s)).to(torch.int32)
    return o3, tuple(c * inv for c in d), pixel, sample_in_pixel


def _trace_pool(bounce, sort_key, *, width, height, spp4, pool, bounces, rr_depth, seed,
                dtype, device, uniforms, compact_every):
    """The pool loop of both renderers -> per-pixel means [W*H, 3].

    ``bounce(o3, d3, tput, rad, alive, u)`` -> (o3, d3, tput, rad, live)
    traces one bounce; ``sort_key(o3, d3)`` gives the int32 compaction
    key below the dead flag (or None); the compaction runs after every
    ``compact_every``-th iteration (0: never).  The pool is one float
    tensor [12, P] (origin, direction, throughput, radiance) and one int64
    tensor [3, P] (pixel, depth, sample index), so compaction is a stable
    sort and one gather of each.  ``uniforms`` = (camera [total, 2], bounce
    draws [iterations, 3, P]) in the JAX package's layout, each or both
    None for the port's streams."""
    total = width * height * spp4
    n_pix = width * height
    cam = Camera()
    cam_u, draws = (None, None) if uniforms is None else uniforms
    slot = torch.arange(pool, device=device)

    def jitter(sidx):  # the caller's camera uniforms of these samples, or None
        return None if cam_u is None else cam_u[sidx.clamp(max=total - 1)]

    def fresh(sidx, u):
        o3, d3, pixel, _ = _sample_camera_rays(sidx, width, height, spp4, seed, cam, dtype,
                                               uniforms=u)
        one, zero = torch.ones_like(o3[0]), torch.zeros_like(o3[0])
        return (torch.stack([*o3, *d3, one, one, one, zero, zero, zero]),
                torch.stack([pixel.long(), torch.zeros_like(sidx), sidx]))

    f, i = fresh(slot, jitter(slot))
    alive = slot < total
    next_sample = torch.full((), pool, device=device)  # stays on the device
    acc = torch.zeros((n_pix, 3), dtype=torch.float64, device=device)
    it = 0
    # one read of the device a loop: samples left to seed, or rays in flight
    while bool(alive.any() | (next_sample < total)):
        o3, d3, tput, rad = (tuple(f[k:k + 3]) for k in (0, 3, 6, 9))
        pixel, depth, sidx = i
        if draws is not None:
            if it >= draws.shape[0]:
                raise ValueError(f"uniforms: {draws.shape[0]} iterations of draws, the "
                                 "render needs more")
            u = draws[it].to(dtype)
        else:
            u = rng.uniforms(seed, sidx, depth, 3, stream=rng.STREAM_ESTIMATOR, dtype=dtype)
        o3, d3, tput, rad, live = bounce(o3, d3, tput, rad, alive, u)
        # depth counts live bounces: depth > rr_depth after the increment is
        # the bounce loop's depth >= rr_depth before it
        depth = depth + live
        tput_rr, survive = shade.russian_roulette(tput, u[2])
        do_rr = depth > rr_depth
        tput = shade.v3_where(do_rr, tput_rr, tput)
        cont = live & (depth < bounces) & (survive | ~do_rr)
        f = torch.stack([*o3, *d3, *tput, *rad])
        i = torch.stack([pixel, depth, sidx])

        # ---- retire the rays that ended into the image (the one scatter)
        seg = torch.where(alive & ~cont, pixel, -1).to(torch.int32)
        histogram_kernels.segment_rows_matmul(seg, f[9:12], n_slots=n_pix, out=acc)
        alive = cont

        # ---- compaction and regeneration ------------------------------
        if compact_every and it % compact_every == compact_every - 1:
            key = sort_key(f[0:3], f[3:6])
            dead = (~alive).to(torch.int32) * _DEAD
            order = torch.sort(dead if key is None else key | dead, stable=True).indices
            f, i = f[:, order], i[:, order]
            n_alive = alive.sum()
            alive = slot < n_alive
            sidx = next_sample + (slot - n_alive)
            new_f, new_i = fresh(sidx, jitter(sidx))
            f = torch.where(alive, f, new_f)
            i = torch.where(alive, i, new_i)
            seeded = ~alive & (sidx < total)
            alive = alive | seeded
            next_sample = next_sample + seeded.sum()
        it += 1
    STATS["iterations"] = it
    return (acc / torch.full((), spp4, dtype=torch.float64, device=device)).to(dtype)


@torch.no_grad()
def render_wavefront(
    seed: int,
    scene: dict,
    *,
    width: int,
    height: int,
    spp4: int,
    pool: int = 1 << 18,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    compact: bool = True,
    uniforms=None,
    dtype=torch.float32,
):
    """Full-frame wavefront render of a sphere scene (``megakernel.
    scene_to_device``'s dict) -> per-pixel means [W*H, 3] over each
    pixel's ``spp4`` samples (the reference counts 4 x samples).

    ``compact=False`` never compacts: the pool must hold every sample.
    ``uniforms``: None (the port's streams, keyed by ``seed``), or a pair
    of the JAX package's draws (camera jitter [W*H*spp4, 2] by sample
    index, bounce draws [iterations, 3, pool] by iteration and slot),
    either of which may be None for the port's stream."""
    total = width * height * spp4
    if total > pool and not compact:
        raise ValueError("compact=False requires pool >= total samples")

    def bounce(o3, d3, tput, rad, alive, u):
        return megakernel.pt_bounce(o3, d3, tput, rad, alive, u, scene, eps)

    return _trace_pool(
        bounce, lambda o3, d3: None, width=width, height=height, spp4=spp4, pool=pool,
        bounces=bounces, rr_depth=rr_depth, seed=seed, dtype=dtype,
        device=scene["r2"].device, uniforms=uniforms, compact_every=int(compact))


@torch.no_grad()
def _render_wavefront_mesh_impl(
    seed: int,
    dev: dict,
    *,
    width: int,
    height: int,
    spp4: int,
    pool: int,
    bounces: int,
    rr_depth: int,
    eps: float,
    static: mesh_mod.StaticConf,
    coherence_sort: bool,
    sort_every: int,
    uniforms=None,
    dtype=torch.float32,
):
    """:func:`render_wavefront_mesh` over the tables ``dev`` and their
    traversal configuration ``static``."""
    device = dev["spheres"]["r2"].device
    if static.traversal == "chunks":
        lo, hi = dev["wbvh_bounds"]
    else:
        lo, hi = (torch.tensor(v, dtype=dtype, device=device) for v in (CORNELL_LO, CORNELL_HI))

    def bounce(o3, d3, tput, rad, alive, u):
        # dead lanes must not drag chunks through the traversal: park them
        # on a ray that misses every box at once (origin far outside,
        # direction away)
        park = (tuple(torch.where(alive, c, 1e7) for c in o3),
                tuple(torch.where(alive, c, 1.0) for c in d3))
        return mesh_mod.pt_mesh_bounce(o3, d3, tput, rad, alive, u, dev, eps, static,
                                       query=park)

    def sort_key(o3, d3):
        return sort_mod.ray_sort_keys_6d(o3, d3, lo, hi) if coherence_sort else None

    return _trace_pool(
        bounce, sort_key, width=width, height=height, spp4=spp4, pool=pool,
        bounces=bounces, rr_depth=rr_depth, seed=seed, dtype=dtype, device=device,
        uniforms=uniforms, compact_every=sort_every)


def render_wavefront_mesh(
    seed: int,
    mdev: dict,
    *,
    width: int,
    height: int,
    spp4: int,
    pool: int = 1 << 18,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    coherence_sort: bool = True,
    sort_every: int = 1,
    uniforms=None,
    dtype=torch.float32,
):
    """Wavefront render of a sphere + mesh scene -> per-pixel means [W*H,
    3].  ``mdev`` comes from ``models/mesh.mesh_scene_to_device`` in any
    traversal mode: ``chunks`` launches ``csrc/wbvh.cu`` (with the
    winners' shading planes) and ``lockstep`` ``csrc/bvh.cu`` once per
    iteration on a card.  ``coherence_sort`` orders the live rays by a 6-D
    Morton code of their direction and origin (bounds: the chunk grid's
    live boxes in chunks mode, else the Cornell box); the compaction runs
    after every ``sort_every``-th iteration, and between two the dead
    lanes idle, parked on a ray that misses at once.  Any pool size.
    ``uniforms`` as in :func:`render_wavefront`."""
    if sort_every < 1:
        raise ValueError(f"sort_every must be >= 1, got {sort_every}")
    return _render_wavefront_mesh_impl(
        seed, mdev, width=width, height=height, spp4=spp4, pool=pool, bounces=bounces,
        rr_depth=rr_depth, eps=eps, static=mdev["static"], coherence_sort=coherence_sort,
        sort_every=sort_every, uniforms=uniforms, dtype=dtype)
