"""Triangle intersection of the port.  ``tri`` holds the brute-force
Moller-Trumbore oracle, ``bvh`` the BVH builder and per-ray walk (the
traversal kernels are in ``ops``), ``native`` the C++ host library (BVH
builder, PPM codec, OBJ loader), ``meshes`` the procedural meshes and
OBJ files."""
