"""Renderers of the port.  ``megakernel`` holds the sphere renderers in
plain torch, ``mesh`` the mesh scenes and their first-hit query."""
