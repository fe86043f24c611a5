"""The data-parallel fit's step swapped for the check's control or a
planted fault, by the workload key ``fault`` (set by
``perfbench.control_dp`` and the tests, never by a cell's file), on
every rank alike unless said otherwise:

- ``control``: the plain reference put in the program's place in
  bfloat16, the precision below the configuration's float32: each rank's
  loss and gradients on its share, one all-reduce over the program's
  group, the mean, the update;
- ``unchanged``: a step that returns its state as it got it;
- ``half``: a step on the first half of each rank's rays (the loss their
  mean);
- ``altered``: the step's loss x 1.5;
- ``exchange``: the last rank leaves out the exchange: it joins the
  all-reduce but keeps its own loss and gradient;
- ``crash``, ``hang``: the last rank fails, or stops, as its run begins;
- ``jax``: the last rank puts an empty module named ``jax`` into
  ``sys.modules`` as its run begins, which the guard against JAX has to
  catch (``crash`` to ``jax``: the launcher's tests).
"""

from __future__ import annotations

import sys
import time
import types

import torch
import torch.distributed as dist

from perfbench.faults import _swap
from perfbench.reference import refmode

NAMES = ("control", "unchanged", "half", "altered", "exchange", "crash", "hang", "jax")
#: Faults that leave the step as it is.
AT_START = (None, "crash", "hang", "jax")


def at_start(fault, rank) -> None:
    """``crash``, ``hang`` and ``jax`` on the last rank."""
    if fault not in (None, *NAMES):
        raise ValueError(f"unknown fault {fault!r}; expected one of {NAMES}")
    if rank.index != rank.size - 1:
        return
    if fault == "crash":
        raise RuntimeError("planted fault: this rank fails as its run begins")
    if fault == "hang":
        while True:
            time.sleep(1.0)
    if fault == "jax":
        sys.modules.setdefault("jax", types.ModuleType("jax"))


class _OwnValues:
    """``torch.distributed`` whose ``all_reduce`` joins the collective on a
    copy and leaves the tensor as this rank had it."""

    def __getattr__(self, name):
        return getattr(dist, name)

    @staticmethod
    def all_reduce(tensor, *args, **kwargs):
        return dist.all_reduce(tensor.clone(), *args, **kwargs)


def _control(dtype=torch.bfloat16):
    def make(mesh, *, bounces, eps, learning_rate):
        size = mesh.size()

        def step(params, aux, rays, target):
            p = {k: v.to(dtype) for k, v in params.items()}
            loss, grads = refmode.loss_and_grads(p, rays.T, target.T, light=aux["light_index"],
                                                 bounces=bounces, eps=eps)
            buf = torch.cat([loss.float().reshape(1)]
                            + [grads[k].float().reshape(-1) for k in refmode.KEYS])
            dist.all_reduce(buf)
            buf /= size
            new, at = {}, 1
            for k in refmode.KEYS:
                g = buf[at:at + p[k].numel()].reshape(p[k].shape).to(dtype)
                new[k] = (p[k] - learning_rate * g).to(params[k].dtype)
                at += p[k].numel()
            return buf[0], new
        return step

    return make


def factory(fault, make_train_step, rank):
    """The step factory the run uses: the program's, or ``fault`` in its
    place."""
    if fault in AT_START:
        return make_train_step
    if fault == "control":
        return _control()

    def make(mesh, **kw):
        step = make_train_step(mesh, **kw)

        def unchanged(params, aux, rays, target):
            return step(params, aux, rays, target)[0], params

        def half(params, aux, rays, target):
            n = rays.shape[0] // 2
            return step(params, aux, rays[:n], target[:n])

        def altered(params, aux, rays, target):
            loss, new = step(params, aux, rays, target)
            return loss * 1.5, new

        def exchange(params, aux, rays, target):
            if rank.index != rank.size - 1:
                return step(params, aux, rays, target)
            from ascendpathtracing_tpu_torch.parallel import sharded

            with _swap(sharded, "dist", _OwnValues()):
                return step(params, aux, rays, target)

        return {"unchanged": unchanged, "half": half, "altered": altered,
                "exchange": exchange}[fault]

    return make
