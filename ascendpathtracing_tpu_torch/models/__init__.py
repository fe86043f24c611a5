"""Renderers of the port.  ``megakernel`` holds the reference-semantics
render in plain torch."""
