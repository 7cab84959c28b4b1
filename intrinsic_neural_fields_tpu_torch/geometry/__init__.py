"""Host-side geometry: meshes and their file IO (OBJ, PLY, OFF, point
clouds), the local triangulation, primitives, the cotan and robust
Laplacians with the intrinsic Delaunay flips, SHOT descriptors, cameras
and lens undistortion, the synthetic scene and its dataset generator."""
