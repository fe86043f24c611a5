"""The fused mesh renderer's backward: replay of the residuals and the
autograd function.

Counterpart of ``ascendpathtracing_tpu/diff/mesh_fused.py``
(``replay_backward``, ``slot_grads_to_face``,
``make_render_pt_mesh_pallas_diff``).  The forward
(``ops/mesh_pt_kernels.render_pt_mesh(with_residuals=True)``) stores each
bounce's winner code and its albedo a, emission e and detached scalar s
(glass rscale x RR weight); the backward replays the product chain

    L_c = sum_b [live_b] tput_{b-1,c} e_{b,c},
    tput_{b,c} = tput_{b-1,c} m_{b,c},  m_{b,c} = live_b ? a_{b,c} s_b : 1,

from them with no intersection:

    dL/de_{b,c} = g_c live_b tput_{b-1,c}
    dL/da_{b,c} = g_c live_b s_b tput_{b-1,c} T_{b,c},
    T_{b,c} = live_{b+1} e_{b+1,c} + m_{b+1,c} T_{b+1,c},  T_{B-1,c} = 0.

Winner ids, RR survival and the glass picks are detached (exact for
bounces <= rr_depth; the standard detached-RR estimator beyond).  The
replay is plain torch in the JAX op order (JAX leaves it to XLA), chunked
over sample layers so that its temporaries stay at one chunk's scale, and
each chunk's per-winner rows [ga | ge] go through one segment-sum
(``ops/histogram_kernels.segment_rows_paged``: the CUDA kernel on a card,
its plain twin on the CPU) keyed by the winner code itself: spheres land
in segments [0, S), triangle slots in [S, S + CT).  So one call gives the
[10, S] scene-plane gradients (rows 7-9 albedo, 4-6 emission, 0-3 exactly
zero) and the slot gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from ascendpathtracing_tpu_torch.ops import histogram_kernels as hk
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt

#: Sample layers per replay chunk: at 1024 x 1024 x 8 bounces a chunk's
#: [bounces, 3, layers, W*H] temporaries are 268 MB each in float32.
LAYER_CHUNK = 8


def replay_rows(widc, resvc, g_cell):
    """One chunk's rows: residuals ``widc`` [B, L, P] and ``resvc`` [B, 7,
    L, P], per-sample cotangent ``g_cell`` [3, 1, P] -> [6, B, L, P], the
    albedo gradients ``ga`` (rows 0-2) and emission gradients ``ge`` (rows
    3-5) of each sample-bounce, in the order of ``widc.reshape(-1)``."""
    bounces = widc.shape[0]
    a3 = resvc[:, 0:3]
    e3 = resvc[:, 3:6]
    s = resvc[:, 6]
    livef = (widc >= 0).to(resvc.dtype)[:, None]  # [B, 1, L, P]
    m = torch.where(livef > 0, a3 * s[:, None], 1.0)
    e_live = e3 * livef

    tput_prev = []
    t = torch.ones_like(m[0])
    for b in range(bounces):
        tput_prev.append(t)
        t = t * m[b]
    suffix = [None] * bounces
    suffix[bounces - 1] = torch.zeros_like(m[0])
    for b in range(bounces - 2, -1, -1):
        suffix[b] = e_live[b + 1] + m[b + 1] * suffix[b + 1]

    rows = torch.empty((6,) + tuple(widc.shape), dtype=resvc.dtype, device=resvc.device)
    for b in range(bounces):
        rows[3:6, b] = g_cell * livef[b] * tput_prev[b]
        rows[0:3, b] = g_cell * livef[b] * s[b][None] * tput_prev[b] * suffix[b]
    return rows


def replay_backward(wid, resv, g, *, n_spheres, n_slots, spp4, with_slots=True,
                    layer_chunk=LAYER_CHUNK, plain=False):
    """Replays the product chain from the residuals (``wid`` int32
    [bounces, spp4, W*H], ``resv`` [bounces, 7, spp4, W*H]) for the
    cotangent ``g`` [3, W*H] of the per-pixel mean image -> (d_scene_planes
    [10, S], d_slot_albedo [CT, 3], d_slot_emission [CT, 3]) in the dtype
    of ``resv``; the slot gradients are [0, 3] when ``with_slots`` is
    False.  One segment-sum launch per chunk of ``layer_chunk`` layers.
    The sums accumulate in one float64 accumulator across the chunks.
    ``plain=True`` is the replay's twin on any device: the segment-sum's
    plain twin, which the card's checks hold the kernel against."""
    dtype, device = resv.dtype, resv.device
    s_count = n_spheres
    n_seg = s_count + n_slots if with_slots else s_count
    acc = torch.zeros((n_seg, 6), dtype=torch.float64, device=device)
    # Per-sample cotangent: out = sum over layers of contrib / spp4.
    g_cell = (g.to(dtype) * (1.0 / spp4))[:, None, :]  # [3, 1, W*H]
    for a0 in range(0, spp4, layer_chunk):
        widc = wid[:, a0:a0 + layer_chunk]  # [B, L, P]
        rows = replay_rows(widc, resv[:, :, a0:a0 + layer_chunk], g_cell).reshape(6, -1)
        seg = widc.reshape(-1)
        if plain:
            hk.segment_rows_plain(seg, rows, n_slots=n_seg, out=acc)
        else:
            hk.segment_rows_paged(seg, rows, n_slots=n_seg, out=acc)
        del rows
    acc = acc.to(dtype)
    d_planes = torch.zeros((10, s_count), dtype=dtype, device=device)
    d_planes[4:7] = acc[:s_count, 3:6].T
    d_planes[7:10] = acc[:s_count, 0:3].T
    if not with_slots:
        z = torch.zeros((0, 3), dtype=dtype, device=device)
        return d_planes, z, z
    return d_planes, acc[s_count:, 0:3].contiguous(), acc[s_count:, 3:6].contiguous()


def slot_grads_to_face(grid, d_slot):
    """Slot-ordered gradient rows [CT, 3] -> per-face [F, 3] via
    ChunkGrid.face_of_slot (each face occupies exactly one slot; pad
    slots are dropped)."""
    d_slot = np.asarray(d_slot)
    fos = np.asarray(grid.face_of_slot)
    n_faces = int(fos.max()) + 1 if (fos >= 0).any() else 0
    out = np.zeros((n_faces, 3), d_slot.dtype)
    liv = fos >= 0
    out[fos[liv]] = d_slot[liv]
    return out


class _RenderMeshFn(torch.autograd.Function):
    """Forward with residuals; backward by replay."""

    @staticmethod
    def forward(ctx, scene_planes, slot_albedo, slot_emission, cfg):
        tris24 = torch.cat([cfg["geom16"], slot_albedo.to(torch.float32),
                            slot_emission.to(torch.float32), cfg["mat2"]], dim=1)
        img, wid, resv = mpt.render_pt_mesh(
            scene_planes, cfg["cboxes"], cfg["sboxes"], tris24,
            cfg["ssboxes"], with_residuals=True, **cfg["kw"])
        ctx.res = (wid, resv)
        ctx.cfg = cfg
        ctx.leaf_dtypes = (slot_albedo.dtype, slot_emission.dtype)
        return img

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        wid, resv = ctx.res
        with_slots = cfg["grads"] == "scene+slots"
        d_planes, d_sa, d_se = replay_backward(
            wid, resv, g.contiguous(), n_spheres=cfg["n_spheres"],
            n_slots=cfg["n_slots"], spp4=cfg["kw"]["spp4"], with_slots=with_slots)
        ctx.res = None
        if not with_slots:
            d_sa = torch.zeros((cfg["n_slots"], 3), dtype=d_planes.dtype,
                               device=d_planes.device)
            d_se = d_sa.clone()
        return (d_planes, d_sa.to(ctx.leaf_dtypes[0]), d_se.to(ctx.leaf_dtypes[1]),
                None)


def make_render_pt_mesh_diff(cboxes, sboxes, geom16, mat2, *, width, height, spp4,
                             materials, tris_per_chunk, supers_per=0, ssboxes=None,
                             supers2_per=0, bounces=8, rr_depth=5, eps=1e-4, seed=0,
                             grads="scene+slots", uniforms=None):
    """Differentiable fused mesh render: ``fn(scene_planes [10, S],
    slot_albedo [CT, 3], slot_emission [CT, 3]) -> image [3, W*H]``, the
    residual forward and the replay backward.  ``geom16`` [CT, 16] (the
    13 intersection floats and the unit normal) and ``mat2`` [CT, 2] (the
    material one-hots) are float32 constants, as are the boxes; the
    scene's dtype is the compute dtype.  ``materials`` is the [S] int32
    tensor of sphere materials.  ``grads="scene"`` skips the slot rows of
    the segment-sum: the slot gradients are zeros.  ``uniforms`` replaces
    the Philox stream, as in ``render_pt_mesh``.  CPU tensors take the
    plain twins, CUDA tensors the kernels."""
    if grads not in ("scene+slots", "scene"):
        raise ValueError(f"unknown grads={grads!r}")
    if ssboxes is None:
        ssboxes = torch.zeros((0, 6), dtype=torch.float32, device=cboxes.device)
    cfg = dict(
        cboxes=cboxes, sboxes=sboxes, ssboxes=ssboxes, geom16=geom16, mat2=mat2,
        n_spheres=int(materials.shape[0]), n_slots=int(geom16.shape[0]), grads=grads,
        kw=dict(materials=materials, width=width, height=height, spp4=spp4,
                tris_per_chunk=tris_per_chunk, supers_per=supers_per,
                supers2_per=supers2_per, bounces=bounces, rr_depth=rr_depth, eps=eps,
                seed=seed, uniforms=uniforms),
    )

    def render(scene_planes, slot_albedo, slot_emission):
        return _RenderMeshFn.apply(scene_planes, slot_albedo, slot_emission, cfg)
    return render
