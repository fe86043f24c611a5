"""Sharded rendering and the data-parallel training step.

Counterpart of ``ascendpathtracing_tpu/parallel/sharded.py``.  Every
function runs in each rank of a mesh (``parallel/mesh.make_mesh``) on
that rank's shard, as the body of a ``shard_map`` does; see the package's
docstring for the convention.

- :func:`render_reference_sharded`: rays DP over the whole mesh, spheres
  TP over its ``model`` axis.  With ``model`` = 1 a rank renders its
  shard through the reference kernel (``render_ref.cu``'s forward on a
  card, its twin on the CPU); with ``model`` > 1 the bounce loop runs in
  plain torch with a hit function that intersects the rank's slice of
  the spheres and combines the slices' nearest hits with an
  ``all_gather`` over the model group, keeping the reference's
  lowest-index tie-break (rt_helper.h:183-193).  A kernel cannot hold a
  collective in mid-bounce, and the JAX package runs that combine in XLA
  too.
- :func:`render_pt_mesh_sharded`: the bounce-loop mesh path tracer DP
  over rays, the scene tables replicated, in three random-number modes.
- :func:`make_train_step`: SGD on the scene parameters.  With a mesh,
  each rank runs the forward with winners and the replay backward
  (``render_ref.cu``) on its shard; the loss (the global mean) and the
  [10, S] gradient are summed over every rank by one all-reduce, and the
  replicated parameters take the same update on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ascendpathtracing_tpu_torch.models import megakernel
from ascendpathtracing_tpu_torch.ops import render_kernels, rng
from ascendpathtracing_tpu_torch.ops.intersect import MISS_T, intersect_spheres_soa
from ascendpathtracing_tpu_torch.ops.render_kernels import RenderReferenceFn
from ascendpathtracing_tpu_torch.parallel import mesh as pmesh
from ascendpathtracing_tpu_torch.utils.profiling import span

PARAM_KEYS = ("albedo", "emission", "center", "r2")


def shard_rays(rays, mesh) -> torch.Tensor:
    """This rank's contiguous shard of rays [N, ...] over every mesh axis,
    in ``P(("data", "model"))``'s order: rank r of the row-major mesh
    takes rows [r m, (r + 1) m), m = N / mesh size."""
    n, n_sh = rays.shape[0], mesh.size()
    if n % n_sh:
        raise ValueError(f"{n=} rays not divisible by the mesh's {n_sh} shards")
    m = n // n_sh
    k = pmesh.shard_index(mesh)
    return rays[k * m:(k + 1) * m]


# ------------------------------------------------------------ render ----
def _tp_hit_fn(o3, d3, scene, eps, *, group, mp: int, midx: int):
    """Tensor-parallel nearest hit: this rank intersects its slice of the
    spheres, then the model group's ranks combine.

    Tie-break: global index = slice * s_local + local index; within a
    slice ``argmin`` picks the lowest local index, and across slices the
    ``argmin`` over the gathered [mp, n] picks the first (lowest-index)
    slice, so the winner is the global lowest-index argmin."""
    s_local = scene["r2"].shape[0] // mp
    lo, hi = midx * s_local, (midx + 1) * s_local
    c = scene["center"][lo:hi]
    t = intersect_spheres_soa(*o3, *d3, c[:, 0], c[:, 1], c[:, 2], scene["r2"][lo:hi], eps)
    hit_l = torch.argmin(t, dim=0).to(torch.int32) + lo
    tmin_l = torch.amin(t, dim=0)
    t_all = torch.stack(pmesh.all_gather(tmin_l, group))  # [mp, n]
    h_all = torch.stack(pmesh.all_gather(hit_l, group))
    best = torch.argmin(t_all, dim=0)[None]
    tmin = torch.take_along_dim(t_all, best, dim=0)[0]
    hit = torch.take_along_dim(h_all, best, dim=0)[0]
    miss = tmin >= torch.full((), MISS_T, dtype=tmin.dtype, device=tmin.device)
    return tmin, hit, miss


def render_reference_sharded(rays, scene: dict, mesh, *, bounces: int = 5,
                             eps: float = 1e-4) -> torch.Tensor:
    """Reference-mode render, DP over rays x TP over spheres: this rank's
    rays [m, 6] (:func:`shard_rays`) and the replicated scene dict
    (``megakernel.scene_to_device``) -> this rank's colors [m, 3].

    The sphere count must divide by the model axis.  The model group's
    ranks render their data row's rays together: each gathers the row's
    rays, traces them with the tensor-parallel hit and keeps its own
    shard's colors."""
    mp = pmesh.axis_size(mesh, "model")
    s = scene["r2"].shape[0]
    if s % mp:
        raise ValueError(f"sphere count {s} not divisible by model axis {mp}")
    if mp == 1:
        return render_kernels.render_reference(
            rays, params_to_planes(scene), light_index=int(scene["light_index"]),
            bounces=bounces, eps=eps)
    group = mesh.get_group("model")
    midx = mesh.get_local_rank("model")
    m = rays.shape[0]
    row = torch.cat(pmesh.all_gather(rays, group))
    o3, d3 = megakernel.rays_to_soa(row)

    def hit_fn(o, d, sc, e):
        return _tp_hit_fn(o, d, sc, e, group=group, mp=mp, midx=midx)

    colors = megakernel.reference_bounce_loop(o3, d3, scene, bounces=bounces, eps=eps,
                                              hit_fn=hit_fn)
    return colors[midx * m:(midx + 1) * m]


def render_pt_mesh_sharded(seed: int, rays, mdev: dict, mesh, *, bounces: int = 8,
                           rr_depth: int = 5, eps: float = 1e-4, bit_equal=True,
                           uniforms=None) -> torch.Tensor:
    """Mesh-scene PT render DP over rays, the scene tables (``mdev``, any
    traversal mode; chunks runs ``wbvh.cu`` on a card) replicated: this
    rank's rays [m, 6] -> its colors [m, 3], no gradient.

    ``bit_equal``:

    - ``"indexed"`` or ``True``: each shard draws from the Philox stream
      at its rays' global indices (``global_idx`` = shard * m +
      arange(m)), no extra memory; equal bit for bit to the one-device
      render of all the rays.  The JAX package's ``True`` draws the
      global stream and slices it; the port's stream is keyed by the
      ray index, so the slice is the indexed draw and ``True`` is kept
      as a name only.
    - ``False``: a seed of the shard's own (``rng.fold_in(seed, shard)``);
      independent streams, statistical agreement only.

    ``uniforms``: the draws of all N rays, [bounces, 3, N], sliced to this
    shard in place of the stream (tests pass the JAX package's)."""
    from ascendpathtracing_tpu_torch.models import mesh as mesh_mod

    m = rays.shape[0]
    sh = pmesh.shard_index(mesh)
    kw = dict(bounces=bounces, rr_depth=rr_depth, eps=eps)
    if uniforms is not None:
        uniforms = uniforms[:, :, sh * m:(sh + 1) * m].to(rays.device)
    if bit_equal in ("indexed", True):
        gidx = sh * m + torch.arange(m, device=rays.device)
        return mesh_mod.render_pt_mesh(rays, mdev, seed=seed, global_idx=gidx,
                                       uniforms=uniforms, **kw)
    return mesh_mod.render_pt_mesh(rays, mdev, seed=rng.fold_in(seed, sh),
                                   uniforms=uniforms, **kw)


# -------------------------------------------------------- train step ----
def split_scene_params(scene: dict):
    """Split the scene dict into (differentiable params, static aux)."""
    params = {k: scene[k] for k in PARAM_KEYS}
    aux = {k: scene[k] for k in scene if k not in params}
    return params, aux


def params_to_planes(params: dict) -> torch.Tensor:
    """{albedo [S, 3], emission [S, 3], center [S, 3], r2 [S]} -> the
    kernels' [10, S] planes (r2 x y z ex ey ez cr cg cb)."""
    return torch.cat([params["r2"][None], params["center"].T, params["emission"].T,
                      params["albedo"].T]).contiguous()


def planes_to_params(planes: torch.Tensor) -> dict:
    """The inverse of :func:`params_to_planes` (a [10, S] gradient ->
    the parameter dict's layout)."""
    return {"albedo": planes[7:10].T, "emission": planes[4:7].T,
            "center": planes[1:4].T, "r2": planes[0]}


def make_train_step(mesh, *, bounces: int = 5, eps: float = 1e-4,
                    learning_rate: float = 1e-3):
    """The SGD step of inverse rendering: fit the scene parameters
    (albedo/emission/center/r^2) so that the rendered image matches a
    target.  Returns ``step(params, aux, rays [N, 6], target [N, 3],
    return_colors=False) -> (loss, new_params[, colors [N, 3]])``, ``loss``
    a 0-d tensor.  Rays and target that are transposed views of contiguous
    [6, N] and [3, N] planes (the kernels' layout, as ``cli.train_problem``
    makes them) are read in place; others are copied into that layout.

    ``mesh=None``: one device, the tensors' own; the loss is
    ``mean((colors - target)²)``.  With a mesh, ``rays`` and ``target``
    are this rank's shards (:func:`shard_rays`) and the parameters are
    replicated: the loss is the global mean (the shards' sums of squares,
    summed over the world, over 3 N_global), the [10, S] gradient is the
    sum of the shards' gradients, and every rank returns the same loss
    and parameters.  The replay backward's rows r2, x, y, z are exactly
    zero (the colors depend on the geometry only through the discrete
    winners), so ``center`` and ``r2`` keep their values, as under
    ``jax.value_and_grad`` of the XLA bounce loop.

    A step runs inside the span ``apt.train_step``
    (``utils/profiling.span``), its parts inside ``apt.train_step.forward``,
    ``.loss``, ``.backward``, ``.all_reduce`` (with a mesh) and ``.update``."""

    def step(params, aux, rays, target, return_colors=False):
        with span("apt.train_step"):
            with span("apt.train_step.forward"):
                planes = params_to_planes(params).detach().requires_grad_(True)
                colors = RenderReferenceFn.apply(rays.T.contiguous(), planes,
                                                 aux["light_index"], bounces, eps, True)
            with span("apt.train_step.loss"):
                if mesh is None:
                    loss = torch.mean((colors.T - target) ** 2)
                else:
                    n_global = rays.shape[0] * mesh.size()
                    loss = torch.sum((colors.T - target) ** 2) / (3 * n_global)
            with span("apt.train_step.backward"):
                (grad,) = torch.autograd.grad(loss, [planes])
            loss = loss.detach()
            if mesh is not None:
                with span("apt.train_step.all_reduce"):
                    # one all-reduce carries the loss and the gradient
                    buf = torch.cat([loss.reshape(1), grad.reshape(-1)])
                    dist.all_reduce(buf)
                    loss, grad = buf[0], buf[1:].reshape(grad.shape)
            with span("apt.train_step.update"):
                grads = planes_to_params(grad)
                new_params = {k: params[k] - learning_rate * grads[k] for k in PARAM_KEYS}
        if return_colors:
            return loss, new_params, colors.detach().T
        return loss, new_params

    return step
