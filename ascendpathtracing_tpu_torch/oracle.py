"""NumPy reference renderers (oracles) for correctness gates.

Formalizes the reference's oracle strategy (SURVEY §4): the reference ships
``test_scene`` (first-hit scalar oracle, gen_data.py:134-188) and
``test_soa`` (a bit-faithful NumPy simulation of the kernel's 5-bounce
loop, gen_data.py:246-429) but never wires them into tests.  Here they are
first-class, vectorized, and exercised by pytest.

Semantics replicated from the reference kernel/oracle:

- Ray-sphere quadratic per (ray, sphere): oc = center - o, b = oc.d,
  c = oc.oc - r^2, det = b^2 - c; miss (det<0) flows through
  sqrt->NaN->sentinel in the kernel (rt_helper.h:324-364); we compute the
  identical *values* branch-free without manufacturing NaNs.
- t = t0 if t0 > eps else t1; anything <= eps (or NaN) -> 1e20 sentinel
  (rt_helper.h:346-364, gen_data.py:239-241).
- Per-ray argmin over spheres with lowest-index tie-break
  (gen_data.py:313-321 strict '<' scan; rt_helper.h:183-193
  ConvertBitToValue lowest-set-bit).
- A miss (min stays exactly 1e20) yields sphere_id -1, which NumPy
  wrap-indexes to the LAST sphere (the light) in the shading gathers
  (gen_data.py:343,390) — replicated explicitly.
- New ray: hitPos = o + d*minT; normal = normalize(hitPos - center);
  pure specular reflect d' = d - 2(d.n)n (gen_data.py:336-349,
  rt_helper.h:504-709). Missed rays still "reflect" — masking happens
  only on color (rt_helper.h:787-810).
- Termination mask: hitting the light sphere (index 7, rt_helper.h:776)
  zeroes the mask BEFORE the throughput multiply of that bounce, so the
  light's albedo (0) is never multiplied in (gen_data.py:379-390).
- Finalize: color = throughput * light emission (the hardcoded x12 of
  render.cpp:194-196 / gen_data.py:414).
"""

from __future__ import annotations

import numpy as np

from ascendpathtracing_tpu_torch.scenes import SphereScene

MISS_T = np.float32(1e20)


def intersect_all_numpy(
    o: np.ndarray, d: np.ndarray, scene: SphereScene, eps: float, dtype=np.float32
) -> np.ndarray:
    """Vectorized ray-vs-all-spheres: [N,3],[N,3] -> t [N,S].

    Op order matches ops/intersect.py:intersect_spheres exactly so the
    results are comparable bit-for-bit at matching dtype (SURVEY §7
    hard-part 1; float64 is the stable-parity gate — see
    tests/test_reference_parity.py docstring on float32 chaos).
    """
    f32 = dtype
    o = o.astype(f32, copy=False)
    d = d.astype(f32, copy=False)
    cen = scene.center.astype(f32, copy=False)  # [S,3]
    r2 = (scene.radius.astype(f32, copy=False)) * (scene.radius.astype(f32, copy=False))

    ocx = cen[None, :, 0] - o[:, None, 0]
    ocy = cen[None, :, 1] - o[:, None, 1]
    ocz = cen[None, :, 2] - o[:, None, 2]
    b = ocx * d[:, None, 0] + ocy * d[:, None, 1] + ocz * d[:, None, 2]
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2[None, :]
    det = b * b - c
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(np.where(det >= 0, det, f32(0)))
    t0 = b - sq
    t1 = b + sq
    valid = det >= 0
    eps = f32(eps)
    t = np.where(
        valid & (t0 > eps), t0, np.where(valid & (t1 > eps), t1, f32(MISS_T))
    )
    return t.astype(f32, copy=False)


def render_reference_numpy(
    rays: np.ndarray,
    scene: SphereScene,
    *,
    bounces: int = 5,
    eps: float = 1e-4,
    return_aux: bool = False,
    dtype=np.float32,
):
    """Vectorized oracle for ``mode="reference"``.

    rays: [N, 6] (any float dtype; cast to ``dtype`` as the kernel casts
    to float32, gen_data.py:247-248). Returns colors [N, 3] ``dtype``.
    """
    f32 = dtype
    o = rays[:, 0:3].astype(f32)
    d = rays[:, 3:6].astype(f32)
    n = o.shape[0]
    s = scene.n_spheres
    light = scene.light_index

    cen = scene.center.astype(f32)
    albedo = scene.color.astype(f32)
    emission = scene.emission.astype(f32)

    throughput = np.ones((n, 3), f32)
    alive = np.ones((n,), bool)

    for _ in range(bounces):
        t = intersect_all_numpy(o, d, scene, eps, f32)  # [N,S]
        hit = np.argmin(t, axis=1)  # lowest-index tie-break
        tmin = t[np.arange(n), hit]
        miss = tmin >= f32(MISS_T)
        # Oracle semantics: a miss has sphere_id == -1, and -1 wrap-indexes
        # to the last sphere in every gather (gen_data.py:343,390).
        gather_id = np.where(miss, s - 1, hit)

        # hitPos = o + d * tmin (gen_data.py:340); done for ALL rays.
        hx = o[:, 0] + d[:, 0] * tmin
        hy = o[:, 1] + d[:, 1] * tmin
        hz = o[:, 2] + d[:, 2] * tmin

        cg = cen[gather_id]  # [N,3]
        nx = hx - cg[:, 0]
        ny = hy - cg[:, 1]
        nz = hz - cg[:, 2]
        norm2 = nx * nx + ny * ny + nz * nz
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            inv = np.where(norm2 > 0, f32(1) / np.sqrt(norm2), f32(0))
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        dn = d[:, 0] * nx + d[:, 1] * ny + d[:, 2] * nz
        two_dn = f32(2) * dn
        d = np.stack(
            [d[:, 0] - two_dn * nx, d[:, 1] - two_dn * ny, d[:, 2] - two_dn * nz],
            axis=1,
        )
        o = np.stack([hx, hy, hz], axis=1)

        # Mask update BEFORE the throughput multiply (gen_data.py:379-390):
        # an actual light hit freezes throughput at its pre-hit value.
        hit_light = (hit == light) & ~miss
        alive = alive & ~hit_light
        mult = albedo[gather_id]
        throughput = np.where(alive[:, None], throughput * mult, throughput)

    color = throughput * emission[light][None, :]  # x12 (render.cpp:194-196)
    if return_aux:
        return color, {"alive": alive, "o": o, "d": d}
    return color


def render_reference_hits_numpy(
    rays: np.ndarray,
    scene: SphereScene,
    *,
    bounces: int = 5,
    eps: float = 1e-4,
    dtype=np.float32,
):
    """Per-bounce hit-decision trail of :func:`render_reference_numpy`.

    Returns [bounces, N] i32: sphere id, -1 on miss, -2 once the ray has
    terminated on the light (later decisions no longer affect color).
    The render's color is EXACTLY determined by this trail — throughput
    is the same ordered f32 product of albedo constants in every
    implementation — so two renderers whose trails agree on a ray are
    bitwise-equal on it.  This is the precise f32 chaos envelope
    (decision-flip counter) used by the golden/parity gates."""
    f32 = dtype
    o = rays[:, 0:3].astype(f32)
    d = rays[:, 3:6].astype(f32)
    n = o.shape[0]
    s = scene.n_spheres
    light = scene.light_index
    cen = scene.center.astype(f32)

    alive = np.ones((n,), bool)
    trail = np.empty((bounces, n), np.int32)
    for k in range(bounces):
        t = intersect_all_numpy(o, d, scene, eps, f32)
        hit = np.argmin(t, axis=1)
        tmin = t[np.arange(n), hit]
        miss = tmin >= f32(MISS_T)
        decision = np.where(miss, -1, hit).astype(np.int32)
        trail[k] = np.where(alive, decision, -2)
        gather_id = np.where(miss, s - 1, hit)

        hx = o[:, 0] + d[:, 0] * tmin
        hy = o[:, 1] + d[:, 1] * tmin
        hz = o[:, 2] + d[:, 2] * tmin
        cg = cen[gather_id]
        nx, ny, nz = hx - cg[:, 0], hy - cg[:, 1], hz - cg[:, 2]
        norm2 = nx * nx + ny * ny + nz * nz
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            inv = np.where(norm2 > 0, f32(1) / np.sqrt(norm2), f32(0))
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        dn = d[:, 0] * nx + d[:, 1] * ny + d[:, 2] * nz
        two_dn = f32(2) * dn
        d = np.stack(
            [d[:, 0] - two_dn * nx, d[:, 1] - two_dn * ny, d[:, 2] - two_dn * nz],
            axis=1,
        )
        o = np.stack([hx, hy, hz], axis=1)
        alive = alive & ~((hit == light) & ~miss)
    return trail


def render_first_hit_numpy(
    rays: np.ndarray, scene: SphereScene, *, eps: float = 1e-4
) -> np.ndarray:
    """First-hit debug oracle: emission for the light, albedo otherwise,
    black on miss (mirrors reference ``test_scene``, gen_data.py:134-188)."""
    f32 = np.float32
    o = rays[:, 0:3].astype(f32)
    d = rays[:, 3:6].astype(f32)
    t = intersect_all_numpy(o, d, scene, eps, f32)
    hit = np.argmin(t, axis=1)
    tmin = t[np.arange(o.shape[0]), hit]
    miss = tmin >= MISS_T
    albedo = scene.color.astype(f32)[hit]
    emis = scene.emission.astype(f32)[hit]
    is_light = hit == scene.light_index
    out = np.where(is_light[:, None], emis, albedo)
    return np.where(miss[:, None], np.zeros_like(out), out)
