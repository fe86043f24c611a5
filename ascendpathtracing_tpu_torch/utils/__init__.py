"""Host-side utilities of the port: the binary SoA formats and the PPM codec
(``io``, a copy of the JAX package's ``utils.io`` with its native branch),
checkpoints, the float guards (``debug``), timing and traces
(``profiling``) and op counts (``roofline``)."""
