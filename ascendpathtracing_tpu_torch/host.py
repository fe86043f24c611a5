"""The NumPy host modules the port shares with the JAX package.

Scenes, camera rays, the render configuration, the float64 oracle, the
``.bin``/PPM formats and the procedural meshes have one source: the JAX
package's ``config``, ``scenes``, ``camera``, ``oracle``, ``utils.io``
and ``accel.meshes``.  Those modules import NumPy only
(``camera.generate_rays_jax`` imports jax inside the function, and the
port never calls it), so the port runs where jax is absent.

``accel.meshes`` is loaded from its file: importing it as
``ascendpathtracing_tpu.accel.meshes`` would run the ``accel`` package's
``__init__``, which imports jax.  Its ``load_obj`` must be called with
``native="never"`` here: the native loader is reached through the same
package.  This is the only module of the port that imports from
``ascendpathtracing_tpu``; no other part of that package may be imported.
"""

import importlib.util
from pathlib import Path

import ascendpathtracing_tpu
from ascendpathtracing_tpu import camera, config, oracle, scenes
from ascendpathtracing_tpu.utils import io


_spec = importlib.util.spec_from_file_location(
    "ascendpathtracing_tpu_torch._host_meshes",
    Path(ascendpathtracing_tpu.__file__).parent / "accel" / "meshes.py",
)
meshes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(meshes)

__all__ = ["camera", "config", "io", "meshes", "oracle", "scenes"]
