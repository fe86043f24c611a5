"""Host-0 image assembly.

Counterpart of ``ascendpathtracing_tpu/parallel/assembly.py``: a sharded
render leaves each rank with its shard's colors; the PPM is a host
artifact.  :func:`gather_colors` brings the full color array to every
rank (one ``all_gather``; a plain fetch in a single process), and
:func:`assemble_ppm_host0` decodes and writes the PPM on rank 0 only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def gather_colors(colors, group=None) -> np.ndarray:
    """This rank's colors [m, 3] -> the whole array [N, 3] as a NumPy
    array on every rank of ``group`` (default: the world), shards in rank
    order, which is :func:`~.sharded.shard_rays`' order.  Without a
    process group, a plain fetch."""
    if not dist.is_initialized():
        return torch.as_tensor(colors).cpu().numpy()
    from ascendpathtracing_tpu_torch.parallel.mesh import all_gather

    return torch.cat(all_gather(torch.as_tensor(colors).contiguous(), group)).cpu().numpy()


def assemble_ppm_host0(colors, width, height, samples, path, group=None):
    """Gather a sharded render and write the PPM on rank 0.

    Returns the path on rank 0 and None on the other ranks, which still
    take part in the gather (a collective).  The bytes equal the
    single-device pipeline's: the same ``decode_color`` and ``write_ppm``
    of the port's ``utils/io`` run on the gathered array."""
    from ascendpathtracing_tpu_torch.utils import io

    full = gather_colors(colors, group)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    io.write_ppm(io.decode_color(full, width, height, samples), path)
    return path
