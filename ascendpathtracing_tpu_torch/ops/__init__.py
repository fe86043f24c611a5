"""Device ops of the port: intersection, shading, random numbers, the
chunk-grid builder, and the CUDA kernels with their plain twins
(``render_kernels``, ``pt_kernels``, ``wbvh_kernels``, ``mesh_pt_kernels``,
built by ``build``)."""
