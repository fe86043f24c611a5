"""Triangle intersection of the port.  ``tri`` holds the brute-force
Moller-Trumbore oracle (the chunk-grid kernels are in ``ops``)."""
