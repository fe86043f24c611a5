"""Device ops of the port: intersection, shading, and the CUDA kernels of
the reference render (``render_kernels``, built by ``build``)."""
