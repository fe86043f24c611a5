"""The reference-semantics render in plain torch.

Counterpart of the reference half of
``ascendpathtracing_tpu/models/megakernel.py``.  This is the whole path
written as tensor ops: every bounce intersects all spheres, takes the
first-minimum winner, reflects as a mirror, and multiplies the throughput
by the winner's albedo until the ray hits the light.  A miss takes the
last sphere's shading but is not a light hit.  Its backward is torch
autograd; the hand-written kernels in ``ops/render_kernels.py`` are held
against it.

Ray state is SoA (``[N]`` planes); ``[N, 6]`` rays and ``[N, 3]`` colors
appear only at the API boundary.  The JAX version checkpoints each bounce
to save device memory; eager autograd here saves only what the
differentiable path (the float scene leaves that require grad) needs.
"""

from __future__ import annotations

import torch

from ascendpathtracing_tpu_torch import convert
from ascendpathtracing_tpu_torch.host import scenes
from ascendpathtracing_tpu_torch.ops import shade
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
