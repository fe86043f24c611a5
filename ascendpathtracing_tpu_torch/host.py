"""The NumPy host modules the port shares with the JAX package.

Scenes, camera rays, the render configuration, the float64 oracle and the
``.bin``/PPM formats have one source: the JAX package's ``config``,
``scenes``, ``camera``, ``oracle`` and ``utils.io``.  Those modules import
NumPy only (``camera.generate_rays_jax`` imports jax inside the function,
and the port never calls it), so the port runs where jax is absent.
This is the only module of the port that imports from
``ascendpathtracing_tpu``; no other part of that package may be imported.
"""

from ascendpathtracing_tpu import camera, config, oracle, scenes
from ascendpathtracing_tpu.utils import io

__all__ = ["camera", "config", "io", "oracle", "scenes"]
