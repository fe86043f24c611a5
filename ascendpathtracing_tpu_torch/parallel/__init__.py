"""The port of ``ascendpathtracing_tpu/parallel`` over ``torch.distributed``.

A rank is one process with one device.  A world is one rank a card over
NCCL, or several ranks sharing one card (or the CPU) over gloo
(``distributed.choose_backend``); ``distributed.initialize`` joins the
world torchrun describes, and ``distributed.run_local_world`` spawns one
on this machine (the counterpart of the JAX package's virtual devices).

The functions follow ``shard_map``'s body, not GSPMD's global arrays:
each takes this rank's shard as a plain tensor on the rank's device,
together with the mesh (``make_mesh``, a ``DeviceMesh`` laid out
row-major over (data, model), or ``("stage",)`` for the rings), and
returns this rank's shard.  :func:`shard_rays` cuts this rank's
contiguous slice in ``P(("data", "model"))``'s order, and
:func:`gather_colors` puts the shards back together.  There is no
DTensor: the hand kernels take plain tensors through ctypes, and one
convention throughout is easier to read.

- DP over rays: each rank renders a contiguous shard (the reference's
  8-core block split, render.cpp:24, over processes).
- TP over spheres (the ``model`` axis): each rank intersects its slice of
  the spheres, and the slices' nearest hits combine by an ``all_gather``
  with the lowest-index tie-break.
- The training step sums the shards' loss and gradient with one
  all-reduce; the parameters stay replicated.
- Rings (``pipeline``): the ray state over bounce stages, or the scene's
  chunks over the ranks, moved with ``mesh.ppermute``.
"""

from ascendpathtracing_tpu_torch.parallel.assembly import (
    assemble_ppm_host0,
    gather_colors,
)
from ascendpathtracing_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from ascendpathtracing_tpu_torch.parallel.sharded import (
    make_train_step,
    render_pt_mesh_sharded,
    render_reference_sharded,
    shard_rays,
    split_scene_params,
)

__all__ = [
    "assemble_ppm_host0",
    "gather_colors",
    "make_mesh",
    "mesh_shape_for",
    "make_train_step",
    "render_pt_mesh_sharded",
    "render_reference_sharded",
    "shard_rays",
    "split_scene_params",
]
