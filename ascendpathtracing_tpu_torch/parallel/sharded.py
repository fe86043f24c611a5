"""Inverse rendering's training step: the single-device part of
``ascendpathtracing_tpu/parallel/sharded.py``.

:func:`make_train_step` with ``mesh=None`` returns the JAX package's SGD
step: loss ``mean((colors - target)²)`` of the reference render, then
``p - lr·g`` on ``albedo``, ``emission``, ``center`` and ``r2``.  The
render and its gradient go through the hand kernels
(``ops/render_kernels.RenderReferenceFn`` with ``replay=True``:
``render_ref.cu``'s forward with winners, its replay backward and
reduce) on a card, and through their plain twins on CPU tensors.  The
replay backward gives the [10, S] plane gradient; its rows r2, x, y, z
are exactly zero (the colors depend on the geometry only through the
discrete winners), so ``center`` and ``r2`` keep their values, as under
``jax.value_and_grad`` of the XLA bounce loop.  The data-parallel and
model-parallel steps over a device mesh are not ported yet.
"""

from __future__ import annotations

import torch

from ascendpathtracing_tpu_torch.ops.render_kernels import RenderReferenceFn

PARAM_KEYS = ("albedo", "emission", "center", "r2")


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
    target.  Returns ``step(params, aux, rays [N, 6], target [N, 3]) ->
    (loss, new_params)``, ``loss`` a 0-d tensor.  Rays and target that are
    transposed views of contiguous [6, N] and [3, N] planes (the kernels'
    layout, as ``cli.train_problem`` makes them) are read in place; others
    are copied into that layout each step.  Only ``mesh=None`` (one
    device, the tensors' own) is ported."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step over a device mesh is not ported yet "
            "(ROADMAP.md, queue 1 item 6: parallel/ to torch.distributed)")

    def step(params, aux, rays, target):
        planes = params_to_planes(params).detach().requires_grad_(True)
        colors = RenderReferenceFn.apply(rays.T.contiguous(), planes,
                                         aux["light_index"], bounces, eps, True)
        loss = torch.mean((colors.T - target) ** 2)
        (grad,) = torch.autograd.grad(loss, [planes])
        grads = planes_to_params(grad)
        new_params = {k: params[k] - learning_rate * grads[k] for k in PARAM_KEYS}
        return loss.detach(), new_params

    return step
