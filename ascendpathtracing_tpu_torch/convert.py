"""The JAX package's scene parameters and rays, as the port's tensors.

Scenes and camera rays are made once, by the JAX package's NumPy host
modules (``scenes.SphereScene.soa10``, ``camera.generate_rays_numpy``,
``models.megakernel.scene_to_device`` read back as NumPy; the mesh
tables of ``pallas_mesh_pt.mesh_pt_tables``).  These functions carry
those arrays, and a test's uniform draws, over to a device and dtype,
so that a test feeds both sides the same inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_FLOAT_KEYS = ("r2", "center", "emission", "albedo")


def scene_planes_from_numpy(
    planes, *, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """[10, S] scene planes (r2 x y z ex ey ez cr cg cb) -> a contiguous
    tensor.  Values are converted as NumPy's ``astype`` would."""
    arr = np.asarray(planes)
    if arr.ndim != 2 or arr.shape[0] != 10:
        raise ValueError(f"expected [10, S] scene planes, got {arr.shape}")
    return torch.tensor(arr, dtype=dtype, device=device)


def rays_planes_from_numpy(
    rays, *, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """[N, 6] rays (ox oy oz dx dy dz) -> contiguous [6, N] planes, the
    rays.bin layout."""
    arr = np.asarray(rays)
    if arr.ndim != 2 or arr.shape[1] != 6:
        raise ValueError(f"expected [N, 6] rays, got {arr.shape}")
    return torch.tensor(np.ascontiguousarray(arr.T), dtype=dtype, device=device)


def uniforms_from_numpy(
    uniforms, *, device="cpu", dtype=torch.float32
) -> torch.Tensor:
    """Uniform draws (NumPy, e.g. the JAX package's per-bounce
    ``jax.random.uniform`` draws stacked as [bounces, k, N]) -> a
    contiguous tensor, so that both sides of a test see the same
    randomness."""
    arr = np.asarray(uniforms)
    if arr.ndim != 3:
        raise ValueError(f"expected [bounces, k, N] uniforms, got {arr.shape}")
    return torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


def scene_dict_from_numpy(
    dev: Mapping, *, device="cpu", dtype=torch.float32
) -> dict:
    """The JAX package's ``megakernel.scene_to_device`` dict (any mapping
    whose arrays ``np.asarray`` reads) -> the port's scene dict: float
    leaves ``r2 center emission albedo`` in ``dtype``, ``material`` int32,
    ``light_index`` a Python int."""
    out = {
        k: torch.tensor(np.asarray(dev[k]), dtype=dtype, device=device)
        for k in _FLOAT_KEYS
    }
    out["material"] = torch.tensor(
        np.asarray(dev["material"]), dtype=torch.int32, device=device
    )
    out["light_index"] = int(dev["light_index"])
    return out


def mesh_tables_from_numpy(
    planes, cboxes, sboxes, ssboxes, tris, *, device="cpu", dtype=torch.float32
) -> tuple:
    """The JAX package's mesh tables (``pallas_mesh_pt.mesh_pt_tables``
    or ``pallas_wbvh.chunk_grid_to_device`` outputs, any arrays
    ``np.asarray`` reads) -> (scene planes [10, S] in ``dtype``, cboxes,
    sboxes, ssboxes, tris) with the tables float32, as the builder makes
    them; ``ssboxes`` None becomes [0, 6]."""
    boxes = []
    for name, b in (("cboxes", cboxes), ("sboxes", sboxes), ("ssboxes", ssboxes)):
        arr = np.zeros((0, 6), np.float32) if b is None else np.asarray(b)
        if arr.ndim != 2 or arr.shape[1] != 6:
            raise ValueError(f"expected [*, 6] {name}, got {arr.shape}")
        boxes.append(torch.tensor(arr, dtype=torch.float32, device=device))
    rows = np.asarray(tris)
    if rows.ndim != 2:
        raise ValueError(f"expected [C*T, F] triangle rows, got {rows.shape}")
    return (
        scene_planes_from_numpy(planes, device=device, dtype=dtype),
        *boxes,
        torch.tensor(rows, dtype=torch.float32, device=device),
    )
