"""Device meshes over the ranks of a ``torch.distributed`` world, and the
collectives the sharded renderers use.

Counterpart of ``ascendpathtracing_tpu/parallel/mesh.py``: a rank is one
process with one device, and a mesh lays the world's ranks out row-major
over named axes, as the JAX package lays ``jax.devices()`` out with
``np.asarray(devices).reshape(dp, mp)``.

On NCCL every collective takes CUDA tensors.  On gloo (ranks that share
one card, or the CPU) ``all_reduce``, ``all_gather`` and ``broadcast``
take CUDA tensors as they are too (a card test, ``tests/test_torch_cuda.py
-k gloo``, holds each against its result), but send and receive take CPU
tensors only: :func:`ppermute` stages its buffer through the host there,
so that no call site copies.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def mesh_shape_for(n_devices: int, model_parallel: int | None = None):
    """Pick a (data, model) split for ``n_devices``.

    The model axis shards the scene-primitive axis of the intersection
    test; it only pays off when primitives >> devices, so default small:
    2 when the device count is even and > 2, else 1.
    """
    if model_parallel is None:
        model_parallel = 2 if (n_devices > 2 and n_devices % 2 == 0) else 1
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices=} not divisible by {model_parallel=}")
    return n_devices // model_parallel, model_parallel


def make_mesh(n_devices: int | None = None, *, model_parallel: int | None = None,
              axis_names=("data", "model")):
    """A ``DeviceMesh`` over the world's ranks: (data, model) by
    :func:`mesh_shape_for` for two axis names, the whole world along one
    axis for one name (the rings' ``("stage",)``).  Ranks are laid out
    row-major, so rank r holds mesh coordinate divmod(r, model) and the
    r-th contiguous shard of :func:`~.sharded.shard_rays`.

    The mesh spans the world: ``n_devices`` (default: the world size)
    must equal it.  Needs a process group (``distributed.initialize``
    under torchrun, or ``distributed.run_local_world``); the mesh's device
    type is this rank's device's."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under torchrun "
                           "(distributed.initialize) or in distributed.run_local_world")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks; "
                         "the mesh spans the world")
    if len(axis_names) == 1:
        shape = (n,)
    elif len(axis_names) == 2:
        shape = mesh_shape_for(n, model_parallel)
    else:
        raise ValueError(f"expected one or two axis names, got {axis_names!r}")
    from ascendpathtracing_tpu_torch.parallel.distributed import rank_device

    return DeviceMesh(rank_device().type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def shard_index(mesh) -> int:
    """This rank's place in the row-major order of all the mesh's axes
    (the shard that ``P(("data", "model"))`` gives it)."""
    idx = 0
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        idx = idx * size + mesh.get_local_rank(name)
    return idx


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` (the same shape and dtype on each), in group rank
    order (``lax.all_gather``, unstacked)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _pack(tensors) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, like) -> tuple:
    out, at = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        # a copy starts at offset 0, so any dtype may view it
        out.append(buf[at:at + nbytes].clone().view(t.dtype).reshape(t.shape))
        at += nbytes
    return tuple(out)


def ppermute(tensors, group, shift: int = 1) -> tuple:
    """``lax.ppermute`` over a ring: every rank sends ``tensors`` to the
    group rank ``shift`` ahead and receives the same shapes and dtypes
    from the rank ``shift`` behind.  The tensors travel as one byte
    buffer (``batch_isend_irecv``); on gloo, CUDA tensors go through a
    host copy.  Returns the received tensors on the tensors' device."""
    tensors = tuple(tensors)
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return tensors
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)  # group rank -> global
    me = dist.get_rank(group)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    buf = _pack(tensors)
    device = buf.device
    if device.type == "cuda" and dist.get_backend(group) == "gloo":
        buf = buf.cpu()
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _unpack(recv.to(device), tensors)
