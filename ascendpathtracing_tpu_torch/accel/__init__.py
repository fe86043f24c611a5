"""Triangle intersection of the port.  ``tri`` holds the brute-force
Moller-Trumbore oracle, ``bvh`` the BVH builder and per-ray walk (the
traversal kernels are in ``ops``)."""
