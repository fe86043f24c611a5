"""Camera gradients through the fused mesh renderer.

Counterpart of ``ascendpathtracing_tpu/diff/camera_fused.py``.  The
fused kernel (``ops/mesh_pt_kernels.render_pt_mesh``) makes its primary
rays inside the kernel from an 11-float camera vector, so the image
carries no camera gradient.  Gradients follow the port's detach-discrete,
differentiate-continuous rule, as the vertex gradients of ``diff/mesh``
do:

- the kernel stores each sample's bounce-0 winner code (``wid[0]`` of the
  replay residuals) and the screen coordinates (su, sv) its primary ray
  was made from (``with_camera=True``);
- :func:`primary_depth` rebuilds the primary ray in torch from (su, sv)
  and the camera parameters (the chain of ``diff/camera.camera_rays``)
  and recomputes the bounce-0 depth from the detached winner: the plane
  equation for a triangle, the sphere quadratic with its root frozen;
- camera losses go through that depth (continuous in the camera away from
  silhouettes); the radiance is piecewise constant in the camera under
  detached decisions, as in ``tests/test_grad.py``'s camera gate.

Memory: at 1024 x 1024 x 64 samples each float32 intermediate of
:func:`primary_depth` is 268 MB and autograd keeps about forty of them.
The gathers of the winners' geometry take ``models/mesh._gather``: plain
indexing, or, where the table requires grad, ``_GatherPlanes``, whose
backward is the segment-sum kernel (autograd's own backward of a gather
serializes the tens of millions of sphere samples that share slot 0).
"""

from __future__ import annotations

import torch

from ascendpathtracing_tpu_torch.camera import ORIGIN_PUSH
from ascendpathtracing_tpu_torch.diff.camera import basis
from ascendpathtracing_tpu_torch.models.mesh import _gather
from ascendpathtracing_tpu_torch.ops import mesh_pt_kernels as mpt
from ascendpathtracing_tpu_torch.ops.intersect import sqrt_rn


def cam_vector(params, width: int, height: int, origin_push=ORIGIN_PUSH,
               dtype=torch.float32):
    """Camera parameters (``diff/camera.CameraParams``) -> the fused
    kernel's 11-float camera vector (pos, unit direction, cx.x, cy,
    origin push) in ``dtype``, differentiably (``Camera.basis``; the
    kernel takes cx.y = cx.z = 0, so only cx.x is in the vector)."""
    p = {k: params[k].to(dtype) for k in ("pos", "raw_dir", "fov")}
    dirn, cx, cy = basis(p, width, height)
    push = torch.tensor([origin_push], dtype=dtype, device=dirn.device)
    return torch.cat([p["pos"], dirn, cx[0:1], cy, push])


def primary_depth(params, wid0, suv, geom16, scene_planes, *, n_spheres: int,
                  width: int, height: int, eps=1e-4, origin_push=ORIGIN_PUSH):
    """The bounce-0 depth of each sample, differentiable in the camera
    parameters (and in ``geom16`` and ``scene_planes``).

    ``wid0`` [spp4, W*H] int32 is the bounce-0 winner code of the fused
    forward (sphere index, n_spheres + slot, -1 for a primary miss), a
    detached decision; ``suv`` [2, spp4, W*H] the screen coordinates of
    the same forward; ``geom16`` [CT, 16] the slot rows (normal 3:6 and
    d0 12 are read); ``scene_planes`` [10, S].  Returns [spp4, W*H] depth
    along the unit primary direction in the parameters' dtype, 0 on a
    primary miss.  The t formulas are the kernel's; the winner and the
    sphere's root pick are frozen."""
    dtype = params["pos"].dtype
    cam = cam_vector(params, width, height, origin_push, dtype=dtype)
    su = suv[0].to(dtype)
    sv = suv[1].to(dtype)
    ddx = su * cam[6] + sv * cam[7] + cam[3]
    ddy = sv * cam[8] + cam[4]
    ddz = sv * cam[9] + cam[5]
    ox = cam[0] + ddx * cam[10]
    oy = cam[1] + ddy * cam[10]
    oz = cam[2] + ddz * cam[10]
    inv = 1.0 / sqrt_rn(ddx * ddx + ddy * ddy + ddz * ddz)
    dx, dy, dz = ddx * inv, ddy * inv, ddz * inv

    code = wid0.detach().long()
    miss = code < 0
    is_tri = code >= n_spheres
    idx = code.clamp_min(0)
    slot = torch.where(is_tri, idx - n_spheres, 0).reshape(-1)
    si = torch.where(is_tri, 0, idx).reshape(-1)
    shape = code.shape

    # Triangle winners: t = (d0 - n.o) / (n.d), with the double where of
    # the models/mesh recompute so that no NaN reaches the gradients.
    g = geom16.to(dtype)
    nx, ny, nz, d0 = (x.reshape(shape) for x in _gather((g[:, 3], g[:, 4], g[:, 5],
                                                         g[:, 12]), slot))
    nd = nx * dx + ny * dy + nz * dz
    nd = torch.where(is_tri & ~miss, nd, 1.0)
    t_tri = (d0 - (nx * ox + ny * oy + nz * oz)) / nd

    # Sphere winners: the kernel's quadratic with the root pick frozen.
    sp = scene_planes.to(dtype)
    r2, cx_, cy_, cz_ = (x.reshape(shape) for x in _gather((sp[0], sp[1], sp[2], sp[3]), si))
    ocx = cx_ - ox
    ocy = cy_ - oy
    ocz = cz_ - oz
    bq = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    det = bq * bq - c
    det = torch.where(is_tri | miss, 1.0, det)
    # sqrt(max(det, 0)) with a double where: at det = 0 (a ray that grazes
    # the sphere, which float32 meets among tens of millions of samples)
    # the root's derivative is infinite, and JAX's form then gives NaN
    # for the whole gradient; here that sample contributes 0.
    pos_det = det > 0
    sq = torch.where(pos_det, sqrt_rn(torch.where(pos_det, det, 1.0)), 0.0)
    t0 = bq - sq
    t1 = bq + sq
    pick_t0 = (t0 > eps).detach()
    t_sph = torch.where(pick_t0, t0, t1)

    t = torch.where(is_tri, t_tri, t_sph)
    return torch.where(miss, 0.0, t)


def render_with_camera(params, scene_planes, cboxes, sboxes, tris24, ssboxes=None,
                       **kw):
    """The fused mesh render with a differentiable camera -> (image [3,
    W*H], depth [spp4, W*H], (wid, resv, suv)).  The image carries no
    camera gradient (the kernel's forward is detached); the depth is
    differentiable in ``params`` through :func:`primary_depth`.  Camera
    losses combine the two, e.g. ``mean((depth - target) ** 2)``.  ``kw``
    are ``render_pt_mesh``'s keyword arguments (width, height, spp4,
    materials, ...): one kernel launch with residuals and screen
    coordinates.  The camera vector is built in float32, as the JAX
    version hands it to its kernel."""
    width, height = kw["width"], kw["height"]
    with torch.no_grad():
        cam = cam_vector(params, width, height, dtype=torch.float32)
    out, wid, resv, suv = mpt.render_pt_mesh(
        scene_planes, cboxes, sboxes, tris24, ssboxes, cam=cam, with_residuals=True,
        with_camera=True, **kw)
    depth = primary_depth(
        params, wid[0], suv, tris24[:, :16], scene_planes,
        n_spheres=int(kw["materials"].shape[0]), width=width, height=height,
        eps=kw.get("eps", 1e-4))
    return out, depth, (wid, resv, suv)
