"""Gradients of the port's renderers (``mesh_fused``: the fused mesh
renderer's replay backward)."""
