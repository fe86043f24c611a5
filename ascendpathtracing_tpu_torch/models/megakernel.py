"""The renderers in plain torch.

Counterpart of ``ascendpathtracing_tpu/models/megakernel.py``, written as
tensor ops.  Its backward is torch autograd.

- Reference semantics (``render_reference_impl``): every bounce
  intersects all spheres, takes the first-minimum winner, reflects as a
  mirror, and multiplies the throughput by the winner's albedo until the
  ray hits the light.  A miss takes the last sphere's shading but is not
  a light hit.  The hand-written kernels in ``ops/render_kernels.py``
  are held against it.
- Path tracing (``render_pt_impl``, ``render_pt_nee_impl``): the smallpt
  estimator with diffuse, mirror and glass and Russian roulette.  Where
  the JAX version draws from a ``jax.random`` key, these take
  ``uniforms`` ([bounces, 3, N], or [bounces, 5, N] with NEE); without
  them they draw from ``ops/rng`` keyed by (seed, ray index, bounce).
- First-hit AOVs (``render_depth_impl``, ``render_gbuffer_impl``).

Ray state is SoA (``[N]`` planes); ``[N, 6]`` rays and ``[N, 3]`` colors
appear only at the API boundary.  The JAX version checkpoints each bounce
to save device memory; eager autograd here saves only what the
differentiable path (the float scene leaves that require grad) needs.
"""

from __future__ import annotations

import math

import torch

from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch import scenes
from ascendpathtracing_tpu_torch.ops import rng, shade
from ascendpathtracing_tpu_torch.ops.intersect import (
    intersect_spheres_soa,
    reduce_hit_soa,
)


def scene_to_device(
    scene: scenes.SphereScene, *, device="cpu", dtype=torch.float32
) -> dict:
    """SphereScene -> dict of tensors: ``r2 center emission albedo`` in
    ``dtype`` (``r2``, not the radius, is the stored parameter), plus
    ``material`` int32 and ``light_index``."""
    return convert.scene_dict_from_numpy(
        {
            "r2": scene.r2,
            "center": scene.center,
            "emission": scene.emission,
            "albedo": scene.color,
            "material": scene.material,
            "light_index": scene.light_index,
        },
        device=device,
        dtype=dtype,
    )


def rays_to_soa(rays):
    """[N, 6] -> (o3, d3) component tuples (the boundary transpose)."""
    return (
        (rays[:, 0], rays[:, 1], rays[:, 2]),
        (rays[:, 3], rays[:, 4], rays[:, 5]),
    )


def _scene_planes(scene, key):
    arr = scene[key]
    return (arr[:, 0], arr[:, 1], arr[:, 2])


def select_by_id(gid, plane):
    """``plane[gid]`` as a select chain over the small sphere axis; its
    backward is a masked sum per sphere.  ``gid`` must be in range."""
    acc = torch.zeros(gid.shape, dtype=plane.dtype, device=gid.device)
    for i in range(plane.shape[0]):
        acc = torch.where(gid == i, plane[i], acc)
    return acc


def default_hit_fn(o3, d3, scene: dict, eps: float):
    """Nearest hit over all spheres -> (tmin, hit, miss)."""
    cx, cy, cz = _scene_planes(scene, "center")
    t = intersect_spheres_soa(*o3, *d3, cx, cy, cz, scene["r2"], eps)
    return reduce_hit_soa(t)


def scene_from_planes(scene_planes, light_index) -> dict:
    """[10, S] scene planes (r2 x y z ex ey ez cr cg cb) -> the scene dict
    that the bounce loop reads, as views of the planes."""
    return {
        "r2": scene_planes[0],
        "center": scene_planes[1:4].T,
        "emission": scene_planes[4:7].T,
        "albedo": scene_planes[7:10].T,
        "light_index": light_index,
    }


def trace_reference(o3, d3, scene: dict, *, bounces, eps):
    """The reference bounce loop over SoA ray state (see the oracle for
    the semantics contract) -> (tput, idx): the throughput as three [N]
    planes, and each bounce's winner, idx [bounces, N] int32 with S on a
    miss.  This is the one plain loop: the colors, the hit trails and the
    hand-written kernels' plain twins are all built from it."""
    n = o3[0].shape[0]
    s = scene["r2"].shape[0]
    light = scene["light_index"]
    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")

    ones = torch.ones((n,), dtype=o3[0].dtype, device=o3[0].device)
    tput = (ones, ones, ones)
    alive = torch.ones((n,), dtype=torch.bool, device=o3[0].device)
    idx = torch.empty((bounces, n), dtype=torch.int32, device=o3[0].device)
    for k in range(bounces):
        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        idx[k] = torch.where(miss, s, hit)
        # A miss takes the last sphere's shading (the oracle's -1 index
        # wraps to the last sphere).
        gid = torch.where(miss, s - 1, hit)
        center_hit = (
            select_by_id(gid, cx),
            select_by_id(gid, cy),
            select_by_id(gid, cz),
        )
        o3, d3 = shade.specular_bounce(o3, d3, tmin, center_hit)
        # The mask is updated BEFORE the throughput multiply, so the
        # light's own albedo is never multiplied in.
        alive = alive & ~((hit == light) & ~miss)
        mult = (select_by_id(gid, ax), select_by_id(gid, ay), select_by_id(gid, az))
        tput = shade.v3_where(
            alive, (tput[0] * mult[0], tput[1] * mult[1], tput[2] * mult[2]), tput
        )
    return tput, idx


def reference_bounce_loop(o3, d3, scene: dict, *, bounces, eps):
    """The reference bounce loop's colors, [N, 3] = throughput * light
    emission."""
    tput, _ = trace_reference(o3, d3, scene, bounces=bounces, eps=eps)
    emi = scene["emission"][scene["light_index"]]
    return torch.stack(
        [tput[0] * emi[0], tput[1] * emi[1], tput[2] * emi[2]], dim=1
    )


def render_reference_impl(rays, scene: dict, *, bounces: int = 5, eps: float = 1e-4):
    """Render with reference semantics: rays [N, 6] -> colors [N, 3] =
    throughput * light emission."""
    o3, d3 = rays_to_soa(rays)
    return reference_bounce_loop(o3, d3, scene, bounces=bounces, eps=eps)


def render_reference_hits_impl(
    rays, scene: dict, *, bounces: int = 5, eps: float = 1e-4
):
    """Per-bounce hit decisions: [bounces, N] int32, -1 on a miss, -2 once
    the ray has ended on the light.  Two renders whose trails agree on a
    ray give the same ordered albedo product on it."""
    o3, d3 = rays_to_soa(rays)
    s = scene["r2"].shape[0]
    light = scene["light_index"]
    with torch.no_grad():
        _, idx = trace_reference(o3, d3, scene, bounces=bounces, eps=eps)
    trail = torch.empty_like(idx)
    alive = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for k in range(bounces):
        trail[k] = torch.where(alive, torch.where(idx[k] == s, -1, idx[k]), -2)
        alive = alive & (idx[k] != light)  # idx == S (a miss) is never the light
    return trail


# ------------------------------------------------------------ AOVs ----
def render_depth_impl(rays, scene: dict, *, eps: float = 1e-4):
    """First-hit depth AOV: t per ray, 0 on a miss."""
    o3, d3 = rays_to_soa(rays)
    tmin, _, miss = default_hit_fn(o3, d3, scene, eps)
    return torch.where(miss, 0.0, tmin)


def render_gbuffer_impl(rays, scene: dict, *, eps: float = 1e-4):
    """First-hit G-buffer -> dict: ``depth`` [N] (0 on a miss), ``normal``
    [N, 3] (oriented against the ray; 0 on a miss), ``albedo`` [N, 3] (0
    on a miss), ``hit_id`` [N] int32 (-1 on a miss)."""
    o3, d3 = rays_to_soa(rays)
    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")
    tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
    gid = torch.where(miss, 0, hit)
    hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
    chit = (select_by_id(gid, cx), select_by_id(gid, cy), select_by_id(gid, cz))
    nrm = shade.v3_normalize(shade.v3_sub(hp, chit))
    flip = shade.where_const(shade.v3_dot(d3, nrm) < 0, 1.0, -1.0, tmin)
    nrm = shade.v3_scale(nrm, flip)
    live = ~miss
    zero3 = (torch.zeros_like(tmin),) * 3
    nrm = shade.v3_where(live, nrm, zero3)
    alb = shade.v3_where(
        live,
        (select_by_id(gid, ax), select_by_id(gid, ay), select_by_id(gid, az)),
        zero3,
    )
    return {
        "depth": torch.where(miss, 0.0, tmin),
        "normal": torch.stack(nrm, dim=1),
        "albedo": torch.stack(alb, dim=1),
        "hit_id": torch.where(miss, -1, hit).to(torch.int32),
    }


# ------------------------------------------------ path tracing (pt) ----
def _bounce_uniforms(uniforms, seed, depth, count, ray_index, dtype):
    """This bounce's [count, N] uniforms: the caller's, or the estimator
    stream of ``ops/rng`` at (seed, ray index, bounce)."""
    if uniforms is not None:
        return uniforms[depth]
    return rng.uniforms(
        seed, ray_index, depth, count, stream=rng.STREAM_ESTIMATOR, dtype=dtype
    )


def _check_uniforms(uniforms, bounces, count, n):
    if uniforms is not None and tuple(uniforms.shape) != (bounces, count, n):
        raise ValueError(
            f"expected uniforms [{bounces}, {count}, {n}], got {tuple(uniforms.shape)}"
        )


def _first_hit_frame(o3, d3, tmin, hit, cx, cy, cz):
    """Hit point, unit normal, d.n, the entering mask and the normal
    oriented against the ray."""
    hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
    chit = (select_by_id(hit, cx), select_by_id(hit, cy), select_by_id(hit, cz))
    nrm = shade.v3_normalize(shade.v3_sub(hp, chit))
    dn = shade.v3_dot(d3, nrm)
    into = dn < 0
    nl = shade.v3_scale(nrm, shade.where_const(into, 1.0, -1.0, dn))
    return hp, nrm, into, nl


def render_pt_impl(
    rays,
    scene: dict,
    *,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    materials_static: tuple | None = None,
    uniforms=None,
    seed: int = 0,
):
    """The smallpt estimator: L = sum over bounces of throughput x
    emission(hit), with cosine-weighted diffuse, mirror and dielectric
    BSDFs and Russian roulette from ``rr_depth`` -> colors [N, 3].

    ``uniforms``: [bounces, 3, N] in [0, 1) (the JAX version's per-bounce
    ``jax.random.uniform(k1, (3, n))`` draws), or None to draw from the
    estimator stream of ``ops/rng`` keyed by (``seed``, ray index,
    bounce).  ``materials_static``: the scene's material codes; BSDF
    branches absent from it are skipped.
    """
    o3, d3 = rays_to_soa(rays)
    n = o3[0].shape[0]
    dtype, device = o3[0].dtype, o3[0].device
    _check_uniforms(uniforms, bounces, 3, n)
    ray_index = torch.arange(n, device=device) if uniforms is None else None

    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")
    ex, ey, ez = _scene_planes(scene, "emission")
    material = scene["material"]
    has_diff = materials_static is None or scenes.DIFF in materials_static
    has_refr = materials_static is None or scenes.REFR in materials_static

    zeros = torch.zeros((n,), dtype=dtype, device=device)
    ones = torch.ones((n,), dtype=dtype, device=device)
    rad = (zeros, zeros, zeros)
    tput = (ones, ones, ones)
    alive = torch.ones((n,), dtype=torch.bool, device=device)

    for depth in range(bounces):
        u = _bounce_uniforms(uniforms, seed, depth, 3, ray_index, dtype)
        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        live = alive & ~miss
        hit = torch.where(miss, 0, hit)  # clamp for gathers; masked by live
        hp, nrm, into, nl = _first_hit_frame(o3, d3, tmin, hit, cx, cy, cz)

        emit = (select_by_id(hit, ex), select_by_id(hit, ey), select_by_id(hit, ez))
        rad = shade.v3_where(
            live,
            shade.v3_add(rad, (tput[0] * emit[0], tput[1] * emit[1], tput[2] * emit[2])),
            rad,
        )

        alb = (select_by_id(hit, ax), select_by_id(hit, ay), select_by_id(hit, az))
        mat = select_by_id(hit, material)
        is_diff = mat == scenes.DIFF
        is_refr = mat == scenes.REFR

        d_spec = shade.reflect(d3, nrm)
        d_diff = (
            shade.cosine_sample_hemisphere(nl, u[0], u[1]) if has_diff else d_spec
        )
        if has_refr:
            d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])
        else:
            d_refr, refr_scale = d_spec, 1.0
        new_d = shade.v3_where(is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec))
        scale = torch.where(is_refr, refr_scale, 1.0) if has_refr else 1.0
        tput = shade.v3_where(
            live,
            (tput[0] * alb[0] * scale, tput[1] * alb[1] * scale, tput[2] * alb[2] * scale),
            tput,
        )

        if depth >= rr_depth:  # Russian roulette (unbiased)
            tput, survive = shade.russian_roulette(tput, u[2])
            alive = live & survive
        else:
            alive = live

        # Next origin: offset along the oriented normal, scale-aware (see
        # shade.scaled_origin_offset); refracted rays keep the hit point.
        r2w = select_by_id(hit, scene["r2"])
        off = torch.where(is_refr, 0.0, shade.scaled_origin_offset(r2w, eps))
        o3 = shade.v3_where(live, shade.v3_add(hp, shade.v3_scale(nl, off)), o3)
        d3 = shade.v3_where(live, new_d, d3)
    return torch.stack(rad, dim=1)


def render_pt_nee_impl(
    rays,
    scene: dict,
    *,
    bounces: int = 8,
    rr_depth: int = 5,
    eps: float = 1e-4,
    uniforms=None,
    seed: int = 0,
):
    """Path tracing with next-event estimation: at every diffuse hit a
    direction toward the light sphere is sampled over its cone and a
    shadow ray tests visibility; BSDF continuations then skip the light's
    emission at the next vertex.  ``uniforms``: [bounces, 5, N] or None
    (see :func:`render_pt_impl`) -> colors [N, 3]."""
    o3, d3 = rays_to_soa(rays)
    n = o3[0].shape[0]
    dtype, device = o3[0].dtype, o3[0].device
    _check_uniforms(uniforms, bounces, 5, n)
    ray_index = torch.arange(n, device=device) if uniforms is None else None
    light = scene["light_index"]

    cx, cy, cz = _scene_planes(scene, "center")
    ax, ay, az = _scene_planes(scene, "albedo")
    ex, ey, ez = _scene_planes(scene, "emission")
    material = scene["material"]
    lcx, lcy, lcz = cx[light], cy[light], cz[light]
    ler, leg, leb = ex[light], ey[light], ez[light]
    lr2 = scene["r2"][light]

    zeros = torch.zeros((n,), dtype=dtype, device=device)
    ones = torch.ones((n,), dtype=dtype, device=device)
    rad = (zeros, zeros, zeros)
    tput = (ones, ones, ones)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    # Emission gate: 1 on the first vertex and after specular bounces, 0
    # after a diffuse vertex (its light came through NEE).
    egate = ones

    for depth in range(bounces):
        u = _bounce_uniforms(uniforms, seed, depth, 5, ray_index, dtype)
        tmin, hit, miss = default_hit_fn(o3, d3, scene, eps)
        live = alive & ~miss
        hit = torch.where(miss, 0, hit)
        hp, nrm, into, nl = _first_hit_frame(o3, d3, tmin, hit, cx, cy, cz)

        emit = (select_by_id(hit, ex), select_by_id(hit, ey), select_by_id(hit, ez))
        g = torch.where(live, egate, 0.0)
        rad = shade.v3_add(
            rad, (g * tput[0] * emit[0], g * tput[1] * emit[1], g * tput[2] * emit[2])
        )

        alb = (select_by_id(hit, ax), select_by_id(hit, ay), select_by_id(hit, az))
        mat = select_by_id(hit, material)
        is_diff = mat == scenes.DIFF
        is_refr = mat == scenes.REFR

        # ---- NEE: sample the light sphere's cone from the hit point ----
        swx, swy, swz = lcx - hp[0], lcy - hp[1], lcz - hp[2]
        dist2 = swx * swx + swy * swy + swz * swz
        sw = shade.v3_normalize((swx, swy, swz))
        cos_a_max = shade.sqrt_rn(
            torch.clamp_min(1.0 - lr2 / torch.clamp_min(dist2, 1e-12), 0.0)
        )
        cos_a = 1.0 - u[3] + u[3] * cos_a_max
        sin_a = shade.sqrt_rn(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
        phi = (2.0 * math.pi) * u[4]
        flip = sw[0].abs() > 0.1
        aux_v = (
            shade.where_const(flip, 0.0, 1.0, zeros),
            shade.where_const(flip, 1.0, 0.0, zeros),
            zeros,
        )
        su_ = shade.v3_normalize(shade.v3_cross(aux_v, sw))
        sv_ = shade.v3_cross(sw, su_)
        ldir = shade.v3_normalize(
            shade.v3_add(
                shade.v3_add(
                    shade.v3_scale(su_, torch.cos(phi) * sin_a),
                    shade.v3_scale(sv_, torch.sin(phi) * sin_a),
                ),
                shade.v3_scale(sw, cos_a),
            )
        )
        # Scale-aware offset for the shadow ray too: a shadow origin inside
        # the wall it sits on self-occludes.
        r2w = select_by_id(hit, scene["r2"])
        soff = shade.scaled_origin_offset(r2w, eps)
        shadow_o = shade.v3_add(hp, shade.v3_scale(nl, soff))
        _, shit, smiss = default_hit_fn(shadow_o, ldir, scene, eps)
        lit = ~smiss & (shit == light)
        ldot = torch.clamp_min(shade.v3_dot(ldir, nl), 0.0)
        omega_w = 2.0 * (1.0 - cos_a_max)  # * (1/pi) * pi cancels
        w = torch.where(live & is_diff & lit, ldot * omega_w, 0.0)
        rad = shade.v3_add(
            rad,
            (
                tput[0] * alb[0] * ler * w,
                tput[1] * alb[1] * leg * w,
                tput[2] * alb[2] * leb * w,
            ),
        )

        # ---- BSDF continuation (as render_pt_impl) ---------------------
        d_diff = shade.cosine_sample_hemisphere(nl, u[0], u[1])
        d_spec = shade.reflect(d3, nrm)
        d_refr, refr_scale = shade.refract_or_reflect(d3, nrm, into, u[0])
        new_d = shade.v3_where(is_diff, d_diff, shade.v3_where(is_refr, d_refr, d_spec))
        scale = torch.where(is_refr, refr_scale, 1.0)
        tput = shade.v3_where(
            live,
            (tput[0] * alb[0] * scale, tput[1] * alb[1] * scale, tput[2] * alb[2] * scale),
            tput,
        )
        egate = shade.where_const(live & is_diff, 0.0, 1.0, zeros)

        if depth >= rr_depth:
            tput, survive = shade.russian_roulette(tput, u[2])
            alive = live & survive
        else:
            alive = live

        off = torch.where(is_refr, 0.0, soff)
        o3 = shade.v3_where(live, shade.v3_add(hp, shade.v3_scale(nl, off)), o3)
        d3 = shade.v3_where(live, new_d, d3)
    return torch.stack(rad, dim=1)
