"""Point-cloud support: local triangulation + point-cloud Laplacian (host;
a copy of the JAX package's geometry/pointcloud.py whose native core is the
port's build of native/localtri.cpp).

Replaces the reference's custom potpourri3d `PointCloudLocalTriangulation`
(reference mesh.py:19-36) and `robust_laplacian.point_cloud_laplacian`
(reference mesh.py:129-133). Both are host-side preprocessing; numpy/scipy.

`local_triangulation` builds, for every point, a Delaunay triangulation of
its k nearest neighbors projected onto the PCA tangent plane, and keeps the
triangles incident to the point. The union (deduplicated) gives a triangle
soup covering the surface, which is exactly what the downstream pipeline
needs: ray intersection targets and vertex triples for barycentric
eigenfeature interpolation.

`point_cloud_laplacian` runs the full Sharp & Crane robust construction
(intrinsic mollification + tufted double cover + intrinsic Delaunay flips,
see geometry/laplacian.robust_laplacian) over that generally nonmanifold
local triangulation — matching robust_laplacian.point_cloud_laplacian's
"tufted" operator (reference mesh.py:129-133).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree


def _tangent_basis(neighbors):
    """PCA tangent plane basis (two in-plane unit vectors) of a local patch."""
    centered = neighbors - neighbors.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return vt[0], vt[1]


def local_triangulation(points, n_neighbors=16, native=True):
    """Per-point tangent-plane Delaunay triangulation, union over all points.

    Returns faces i32 [F,3] indexing into `points`. Orientation is made
    locally consistent with the PCA normal but is globally arbitrary (the
    ray tracer treats triangles as two-sided).

    native=True (default) runs the C++ core (native/localtri.cpp: kd-tree
    kNN + Jacobi PCA + Bowyer-Watson Delaunay; raises when it cannot be
    built), except for n >= 2^21 points (beyond the core's 21-bit dedup-key
    packing), which take this Python loop, as native=False does. Both
    produce valid per-patch Delaunay triangulations; cocircular ties may
    resolve differently.
    """
    points = np.asarray(points, dtype=np.float64)
    if native:
        faces = _local_triangulation_native(points, n_neighbors)
        if faces is not None:
            return faces
    n = points.shape[0]
    k = min(n_neighbors, n)
    tree = cKDTree(points)
    _, knn = tree.query(points, k=k)

    seen = set()
    faces = []
    for i in range(n):
        idxs = knn[i]
        nbrs = points[idxs]
        e1, e2 = _tangent_basis(nbrs)
        centered = nbrs - points[i]
        uv = np.stack([centered @ e1, centered @ e2], axis=-1)
        try:
            tri = Delaunay(uv)
        except Exception:
            continue
        for simplex in tri.simplices:
            if 0 not in simplex:  # keep only triangles incident to the center
                continue
            f = tuple(int(idxs[s]) for s in simplex)
            key = tuple(sorted(f))
            if len(set(key)) < 3 or key in seen:
                continue
            seen.add(key)
            faces.append(f)
    if not faces:
        return np.zeros((0, 3), dtype=np.int32)
    return np.asarray(faces, dtype=np.int32)


def _local_triangulation_native(points, n_neighbors):
    """C++-core triangulation, or None when n is beyond the core's limit."""
    import ctypes

    from ..native import load_localtri

    lib = load_localtri()
    n = points.shape[0]
    pts = np.ascontiguousarray(points, dtype=np.float64)
    max_faces = 8 * max(n, 4)
    for _ in range(3):
        out = np.empty((max_faces, 3), dtype=np.int32)
        got = lib.local_triangulation(
            n,
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(n_neighbors),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_faces,
        )
        if got == -2:
            return None  # n beyond the 21-bit dedup packing: Python path
        if got >= 0:
            return np.ascontiguousarray(out[:got])
        max_faces *= 4  # -1: buffer too small
    raise RuntimeError("local_triangulation: native face buffer kept overflowing")


def point_cloud_laplacian(points, n_neighbors=16):
    """(L PSD csr, M diagonal csr) over the local triangulation of `points`:
    mollified intrinsic-Delaunay cotan operator (flips on the triangulation's
    manifold interior edges) + lumped mass, replacing
    robust_laplacian.point_cloud_laplacian (reference mesh.py:129-133)."""
    from .laplacian import robust_laplacian

    points = np.asarray(points, dtype=np.float64)
    faces = local_triangulation(points, n_neighbors=n_neighbors)
    if faces.shape[0] == 0:
        raise RuntimeError("point_cloud_laplacian: local triangulation produced no faces")
    return robust_laplacian(points, faces)
