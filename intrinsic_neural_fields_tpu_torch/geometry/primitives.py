"""Procedural test meshes with known analytic properties (copies of the
JAX package's geometry/primitives.py: `grid_mesh` :14, `icosphere`)."""
from __future__ import annotations

import numpy as np

from .mesh import Mesh


def grid_mesh(n=20, scale=1.0):
    """Regular triangulated [0,scale]^2 grid in the z=0 plane.

    The cotan Laplacian of this mesh discretizes the flat Laplacian with
    natural (Neumann) boundary conditions: eigenvalues pi^2 (m^2 + n^2) on
    the unit square.
    """
    xs = np.linspace(0.0, scale, n)
    xx, yy = np.meshgrid(xs, xs, indexing="xy")
    v = np.stack([xx.reshape(-1), yy.reshape(-1), np.zeros(n * n)], axis=-1)
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            i = r * n + c
            faces.append((i, i + 1, i + n))
            faces.append((i + 1, i + n + 1, i + n))
    return Mesh(vertices=v, faces=np.asarray(faces, dtype=np.int32))


def icosphere(subdivisions=3, radius=1.0):
    """Icosahedron subdivided + projected to the sphere of given radius.

    LBO eigenvalues of the unit sphere: l (l + 1), multiplicity 2l + 1.
    Vertex and face order equal the reference package's icosphere.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = [v for v in verts]

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = verts_list[i] + verts_list[j]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return Mesh(vertices=verts * radius, faces=faces.astype(np.int32))
