"""The differentiable bounce-loop mesh render: vertices and per-face albedo
and emission as leaves, hit decisions detached, every continuous quantity
(hit distance, normals, attribute products) recomputed under autograd.

Counterpart of ``ascendpathtracing_tpu/diff/mesh.py``.  How gradients
flow per traversal mode:

- ``brute``: differentiable as it is (min over the faces' t, gathers).
  The float64 finite-difference reference.
- ``chunks``: the kernel's winning slot is detached;
  ``models/mesh._mesh_hit`` recomputes t from the winner's plane equation
  (``diff=True``), so d(depth)/d(vertices) and the attribute gradients
  flow.  The kernel's tables are a detached copy of the geometry: when the
  vertices move far (:func:`table_drift`), rebuild the device scene with
  ``mesh_scene_to_device``.
- ``jnp`` and ``lockstep``: refused (:func:`build_traced_dev` raises).
  Their tables are in the BVH's leaf order, and the JAX version writes
  face-ordered planes into them, so it tests and shades the wrong
  triangles; the port does not compute that.

:func:`build_traced_dev` mirrors ``mesh_scene_to_device`` but builds the
geometry and attribute planes from the parameter tensors, so autograd
reaches them.
"""

from __future__ import annotations

import numpy as np
import torch

from ascendpathtracing_tpu_torch.models import mesh as mesh_mod


def mesh_params(ms: mesh_mod.MeshScene, dtype=torch.float32, device="cpu"):
    """MeshScene -> the differentiable leaves: ``vertices`` [V, 3],
    ``face_albedo`` and ``face_emission`` [F, 3], in ``dtype``."""
    return {
        "vertices": torch.tensor(np.asarray(ms.vertices), dtype=dtype, device=device),
        "face_albedo": torch.tensor(np.asarray(ms.face_albedo), dtype=dtype, device=device),
        "face_emission": torch.tensor(np.asarray(ms.face_emission), dtype=dtype,
                                      device=device),
    }


def build_traced_dev(params, dev0, faces, static: mesh_mod.StaticConf | None = None):
    """The device scene with its geometry and attribute planes rebuilt from
    ``params`` (differentiably), keeping dev0's other tables (spheres,
    kernel tables, materials).

    ``faces``: [F, 3] integer tensor; ``dev0``: ``mesh_scene_to_device``'s
    dict (same traversal mode).  Raises ValueError for the ``jnp`` and
    ``lockstep`` modes."""
    static = dev0["static"] if static is None else static
    if static.traversal in ("jnp", "lockstep"):
        raise ValueError(
            f"build_traced_dev: the {static.traversal} traversal indexes its triangles in "
            "BVH leaf order, but the traced planes are built in face (or slot) order, so "
            "the render would test and shade the wrong triangles; use the brute or "
            "chunks mode"
        )
    v = params["vertices"]
    tri = v[faces.long()]  # [F, 3, 3]
    v0f = tri[:, 0]
    e1f = tri[:, 1] - tri[:, 0]
    e2f = tri[:, 2] - tri[:, 0]
    albf = params["face_albedo"]
    emif = params["face_emission"]

    if static.traversal == "chunks":
        fos = dev0["face_of_slot"]
        live = (fos >= 0)[:, None]
        idx = fos.clamp_min(0).long()

        def sel(a):
            g = a[idx]
            return torch.where(live, g, torch.zeros_like(g))

        v0s, e1s, e2s = sel(v0f), sel(e1f), sel(e2f)
        alb, emi = sel(albf), sel(emif)
    else:  # brute: face order
        v0s, e1s, e2s, alb, emi = v0f, e1f, e2f, albf, emif

    fn = torch.linalg.cross(e1s, e2s)
    fn = fn / torch.clamp_min(torch.linalg.vector_norm(fn, dim=1, keepdim=True), 1e-30)
    dev = dict(dev0)

    def planes(a):
        return tuple(a[:, i] for i in range(3))

    dev["v0"] = planes(v0s)
    dev["e1"] = planes(e1s)
    dev["e2"] = planes(e2s)
    dev["fnormal"] = planes(fn)
    dev["f_albedo"] = planes(alb)
    dev["f_emission"] = planes(emi)
    return dev


def render_pt_mesh_params_impl(rays, params, dev0, faces, *, bounces=4, rr_depth=5,
                               eps=1e-4, static=None, uniforms=None, seed=0):
    """Radiance [N, 3] of ``models/mesh.render_pt_mesh_impl`` as a
    function of the ``params`` leaves."""
    dev = build_traced_dev(params, dev0, faces, static)
    return mesh_mod.render_pt_mesh_impl(
        rays, dev, bounces=bounces, rr_depth=rr_depth, eps=eps, static=static,
        uniforms=uniforms, seed=seed,
    )


def depth_aov_params_impl(rays, params, dev0, faces, *, eps=1e-4, static=None):
    """First-hit depth [N] (1e20 where nothing is hit), differentiable
    with respect to the vertices."""
    dev = build_traced_dev(params, dev0, faces, static)
    tmin, _kind, _hid = mesh_mod.first_hit_mesh_impl(rays, dev, eps=eps, static=static)
    return tmin


def _diff_static(dev):
    # gradients need the recompute/gather path whatever the device scene
    # was built for
    return dev["static"]._replace(diff=True)


def render_pt_mesh_params(rays, params, dev, faces, **kw):
    """Differentiable render: radiance [N, 3] as a function of ``params``
    (``diff`` switched on for the traversal)."""
    return render_pt_mesh_params_impl(rays, params, dev, faces, static=_diff_static(dev),
                                      **kw)


def depth_aov_params(rays, params, dev, faces, **kw):
    """Differentiable first-hit depth (see :func:`depth_aov_params_impl`)."""
    return depth_aov_params_impl(rays, params, dev, faces, static=_diff_static(dev), **kw)


class StaleKernelTablesError(RuntimeError):
    """The vertices have moved too far from the traversal kernel's frozen
    chunk tables: hit decisions come from stale geometry."""


def table_drift(params, dev, faces) -> float:
    """Max vertex displacement (a fraction of the scene diagonal) between
    ``params["vertices"]`` and the geometry frozen into the chunk tables
    by ``mesh_scene_to_device``.  All three vertices of each triangle are
    compared.  0.0 for the other traversals (their geometry is the traced
    planes)."""
    if dev["static"].traversal != "chunks":
        return 0.0

    def host(x):
        return np.asarray(torch.as_tensor(x).detach().cpu(), np.float64)

    tri = host(params["vertices"])[host(faces).astype(np.int64)]  # [F, 3, 3]
    fos = host(dev["face_of_slot"]).astype(np.int64)
    live = fos >= 0
    v0_f, e1_f, e2_f = (np.stack([host(p) for p in dev[k]], 1) for k in ("v0", "e1", "e2"))
    if live.any():
        frozen = np.stack([v0_f[live], v0_f[live] + e1_f[live], v0_f[live] + e2_f[live]], 1)
        delta = np.abs(frozen - tri[fos[live]]).max()
    else:
        delta = 0.0
    lo, hi = (host(x) for x in dev["wbvh_bounds"])
    return float(delta / max(float(np.linalg.norm(hi - lo)), 1e-30))


def assert_tables_fresh(params, dev, faces, *, tol: float = 0.01):
    """Raises :class:`StaleKernelTablesError` once :func:`table_drift`
    exceeds ``tol`` (default 1% of the scene diagonal): rebuild the device
    scene with ``mesh_scene_to_device`` and continue.  Returns the drift."""
    d = table_drift(params, dev, faces)
    if d > tol:
        raise StaleKernelTablesError(
            f"vertices drifted {d:.4f} of scene diagonal from the frozen "
            f"kernel tables (tol={tol}); rebuild the device scene with "
            "mesh_scene_to_device before continuing"
        )
    return d
