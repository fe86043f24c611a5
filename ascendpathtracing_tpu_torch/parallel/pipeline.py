"""Ring parallelism over a 1-D ``("stage",)`` mesh: two decompositions.

Counterpart of ``ascendpathtracing_tpu/parallel/pipeline.py``; every
function runs in each rank on that rank's ray shard (``shard_rays``) and
returns that shard's colors.  Tensors move between neighbours with
``mesh.ppermute`` (rank i sends to i + 1).

1. :func:`render_reference_pipelined`: a pipeline over the bounces.  The
   ray state rotates around the ring: at step s every rank applies its
   ``bounces/S`` bounces to whichever shard it holds, and after S steps
   each shard has passed every stage once and is home.  The scene is
   replicated; the ray working set a rank holds is N/S.
2. :func:`render_reference_ring_scene` and :func:`render_pt_ring_scene`:
   a ring over the scene.  Each rank keeps its rays and 1/S of the sphere
   tables; every bounce the scene chunks rotate while per-ray winner
   carriers (t, global id, the winner's attributes) stay home and fold in
   each visiting chunk with the reference's combine (the lowest global
   index on a tie; a miss wraps to the last sphere, here the highest
   index at the miss sentinel).  The combine does not depend on the
   order of the visits, so the colors equal the single-device render's
   bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ascendpathtracing_tpu_torch import scenes
from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import rng, shade
from ascendpathtracing_tpu_torch.ops.intersect import MISS_T, intersect_spheres_soa
from ascendpathtracing_tpu_torch.parallel import mesh as pmesh


def _ring(mesh, axis, bounces=None):
    """(stage count, the axis's group, this rank's stage), with the
    JAX package's divisibility checks."""
    n_stages = pmesh.axis_size(mesh, axis)
    if bounces is not None and bounces % n_stages:
        raise ValueError(f"{bounces=} not divisible by {n_stages=} stages")
    return n_stages, mesh.get_group(axis), mesh.get_local_rank(axis)


def _colors(tput, emi):
    return torch.stack([tput[0] * emi[0], tput[1] * emi[1], tput[2] * emi[2]], dim=1)


def render_reference_pipelined(rays, scene: dict, mesh, *, bounces: int = 8,
                               eps: float = 1e-4, axis: str = "stage",
                               microbatches: int | None = None):
    """Reference-mode render ring-pipelined over the bounces: this rank's
    rays [m, 6] and the replicated scene -> this rank's colors [m, 3].
    ``bounces`` must divide by the stage count.  ``microbatches`` is
    accepted and unused, as in the JAX package."""
    n_stages, group, _ = _ring(mesh, axis, bounces)
    per_stage = bounces // n_stages
    o3, d3 = megakernel.rays_to_soa(rays)
    m = rays.shape[0]
    ones = torch.ones((m,), dtype=rays.dtype, device=rays.device)
    state = (*o3, *d3, ones, ones, ones, torch.ones((m,), dtype=torch.bool, device=rays.device))
    for _ in range(n_stages):
        o3, d3, tput, alive = state[0:3], state[3:6], state[6:9], state[9]
        for _ in range(per_stage):
            o3, d3, tput, alive, _ = megakernel.reference_bounce(o3, d3, tput, alive, scene, eps)
        # hand the state to the next stage; after n_stages turns it is home
        state = pmesh.ppermute((*o3, *d3, *tput, alive), group)
    return _colors(state[6:9], scene["emission"][scene["light_index"]])


def _chunk(scene: dict, keys, me: int, s_local: int) -> tuple:
    """This stage's rows of the scene tables (copies, so that the full
    tables need not stay alive)."""
    return tuple(scene[k][me * s_local:(me + 1) * s_local].clone() for k in keys)


def _scene_ring(mesh, axis, scene):
    n_stages, group, me = _ring(mesh, axis)
    s = scene["r2"].shape[0]
    if s % n_stages:
        raise ValueError(f"{s=} spheres not divisible by {n_stages=} stages")
    return n_stages, group, me, s // n_stages


def _visit(o3, d3, chunk, eps):
    """One visiting chunk's nearest hit -> (tmin_l, hit_l local, miss_l)."""
    r2c, cenc = chunk[0], chunk[1]
    t = intersect_spheres_soa(*o3, *d3, cenc[:, 0], cenc[:, 1], cenc[:, 2], r2c, eps)
    hit_l = torch.argmin(t, dim=0)
    tmin_l = torch.amin(t, dim=0)
    return tmin_l, hit_l, tmin_l >= torch.full((), MISS_T, dtype=t.dtype, device=t.device)


def render_reference_ring_scene(rays, scene: dict, mesh, *, bounces: int = 8,
                                eps: float = 1e-4, axis: str = "stage"):
    """Reference-mode render with the scene 1/S a stage, rotated around
    the ring: this rank's rays [m, 6] and the scene dict (this rank keeps
    its chunk of the sphere tables) -> its colors [m, 3], bit-equal to
    the single-device render.  The sphere count must divide by the stage
    count."""
    n_stages, group, me, s_local = _scene_ring(mesh, axis, scene)
    light = int(scene["light_index"])
    home = _chunk(scene, ("r2", "center", "albedo"), me, s_local)
    emission_l = scene["emission"][me * s_local:(me + 1) * s_local]
    dtype, device, m = rays.dtype, rays.device, rays.shape[0]

    # the light's emission, from the stage that holds it
    emi = torch.zeros(3, dtype=dtype, device=device)
    if me * s_local <= light < (me + 1) * s_local:
        emi += emission_l[light - me * s_local]
    dist.all_reduce(emi, group=group)

    o3, d3 = megakernel.rays_to_soa(rays)
    ones = torch.ones((m,), dtype=dtype, device=device)
    tput, alive = (ones, ones, ones), torch.ones((m,), dtype=torch.bool, device=device)
    miss_t = torch.full((), MISS_T, dtype=dtype, device=device)
    for _ in range(bounces):
        # resident carriers: t, global id, the winner's centre and albedo
        tmin = torch.full((m,), torch.inf, dtype=dtype, device=device)
        wgid = torch.full((m,), -1, dtype=torch.int64, device=device)
        wc = torch.zeros((m, 3), dtype=dtype, device=device)
        wa = torch.zeros((m, 3), dtype=dtype, device=device)
        chunk = home
        for r in range(n_stages):
            # at turn r this rank holds stage (me - r)'s chunk
            base = (me - r) % n_stages * s_local
            tmin_l, hit_l, miss_l = _visit(o3, d3, chunk, eps)
            # the miss wraps to the last sphere: the chunk's last row here,
            # and the at-miss tie-break below keeps the highest global id
            gid_attr = torch.where(miss_l, s_local - 1, hit_l)
            gid_g = base + gid_attr
            better = (tmin_l < tmin) | ((tmin_l == tmin) & torch.where(
                miss_l, gid_g > wgid, gid_g < wgid))
            tmin = torch.where(better, tmin_l, tmin)
            wgid = torch.where(better, gid_g, wgid)
            wc = torch.where(better[:, None], chunk[1][gid_attr], wc)
            wa = torch.where(better[:, None], chunk[2][gid_attr], wa)
            if r + 1 < n_stages:  # the last turn would only bring the chunk home
                chunk = pmesh.ppermute(chunk, group)
        miss = tmin >= miss_t
        # the miss sentinel flows through the specular bounce unclamped,
        # as in the single-device loop
        tmin_b = torch.where(miss, miss_t, tmin)
        o3, d3 = shade.specular_bounce(o3, d3, tmin_b, wc.unbind(1))
        alive = alive & ~((wgid == light) & ~miss)
        tput = shade.v3_where(
            alive, (tput[0] * wa[:, 0], tput[1] * wa[:, 1], tput[2] * wa[:, 2]), tput)
    return _colors(tput, emi)


def render_pt_ring_scene(seed: int, rays, scene: dict, mesh, *, bounces: int = 8,
                         rr_depth: int = 5, eps: float = 1e-4, axis: str = "stage",
                         uniforms=None):
    """The path-tracing estimator (``megakernel.render_pt_impl``) with the
    scene 1/S a stage, rotated around the ring: this rank's rays [m, 6]
    -> its colors [m, 3].  The carriers also hold the winner's emission,
    material and r², and shading runs where the rays are.  The draws are
    the single-device render's: the Philox stream at the rays' global
    indices (shard * m + arange(m)), or ``uniforms`` ([bounces, 3, N] for
    all N rays) sliced to this shard; so the colors equal
    ``render_pt_impl``'s bit for bit.  Miss lanes' carriers are immaterial:
    every consumer is gated by ``live``."""
    n_stages, group, me, s_local = _scene_ring(mesh, axis, scene)
    dtype, device, m = rays.dtype, rays.device, rays.shape[0]
    first = me * m  # a stage's shard is its rank's: rays[me m, (me + 1) m)
    if uniforms is not None:
        uniforms = uniforms[:, :, first:first + m].to(device)
    gidx = first + torch.arange(m, device=device)
    home = _chunk(scene, ("r2", "center", "albedo", "emission", "material"), me, s_local)

    o3, d3 = megakernel.rays_to_soa(rays)
    zeros = torch.zeros((m,), dtype=dtype, device=device)
    ones = torch.ones((m,), dtype=dtype, device=device)
    rad, tput = (zeros, zeros, zeros), (ones, ones, ones)
    alive = torch.ones((m,), dtype=torch.bool, device=device)
    miss_t = torch.full((), MISS_T, dtype=dtype, device=device)
    for depth in range(bounces):
        u = (uniforms[depth] if uniforms is not None else
             rng.uniforms(seed, gidx, depth, 3, stream=rng.STREAM_ESTIMATOR, dtype=dtype))
        tmin = torch.full((m,), torch.inf, dtype=dtype, device=device)
        wgid = torch.full((m,), -1, dtype=torch.int64, device=device)
        w = torch.zeros((m, 10), dtype=dtype, device=device)  # centre, albedo, emission, r2
        wmat = torch.zeros((m,), dtype=home[4].dtype, device=device)
        chunk = home
        for r in range(n_stages):
            base = (me - r) % n_stages * s_local
            tmin_l, hit_l, _ = _visit(o3, d3, chunk, eps)
            gid_l = base + hit_l
            # the lowest global index on exact ties (as argmin)
            better = (tmin_l < tmin) | ((tmin_l == tmin) & (gid_l < wgid))
            attrs = torch.cat([chunk[1][hit_l], chunk[2][hit_l], chunk[3][hit_l],
                               chunk[0][hit_l][:, None]], dim=1)
            tmin = torch.where(better, tmin_l, tmin)
            wgid = torch.where(better, gid_l, wgid)
            w = torch.where(better[:, None], attrs, w)
            wmat = torch.where(better, chunk[4][hit_l], wmat)
            if r + 1 < n_stages:
                chunk = pmesh.ppermute(chunk, group)
        live = alive & ~(tmin >= miss_t)
        # megakernel.pt_bounce's frame and surface, from the carriers
        hp = (o3[0] + d3[0] * tmin, o3[1] + d3[1] * tmin, o3[2] + d3[2] * tmin)
        nrm = shade.v3_normalize(shade.v3_sub(hp, w[:, 0:3].unbind(1)))
        dn = shade.v3_dot(d3, nrm)
        into = dn < 0
        nl = shade.v3_scale(nrm, shade.where_const(into, 1.0, -1.0, dn))
        surface = (w[:, 6:9].unbind(1), w[:, 3:6].unbind(1), wmat == scenes.DIFF,
                   wmat == scenes.REFR, w[:, 9])
        o3, d3, tput, rad = megakernel.pt_scatter(o3, d3, tput, rad, live, u,
                                                  (hp, nrm, into, nl), surface, eps)
        if depth >= rr_depth:  # Russian roulette (unbiased)
            tput, survive = shade.russian_roulette(tput, u[2])
            alive = live & survive
        else:
            alive = live
    return torch.stack(rad, dim=1)
