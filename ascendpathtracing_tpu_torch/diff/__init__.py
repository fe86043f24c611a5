"""Gradients of the port's renderers (counterpart of
``ascendpathtracing_tpu/diff``).

- ``camera``: the camera parameters as tensors and a differentiable ray
  build.
- ``fd``: central finite-difference gradient checks.
- ``camera_fused``: camera gradients through the fused mesh renderer.
- ``mesh_fused``: the fused mesh renderer's replay backward.
- ``mesh``: the differentiable bounce-loop mesh render.
"""

from ascendpathtracing_tpu_torch.diff.camera import CameraParams, camera_rays
from ascendpathtracing_tpu_torch.diff.fd import check_grads_fd, fd_grad

__all__ = ["CameraParams", "camera_rays", "fd_grad", "check_grads_fd"]
