"""Host-side Wavefront OBJ read/write (numpy only).

Vertex and face order are preserved exactly as stored in the file. Polygons
are fan-triangulated. `read_obj` ignores texture/normal indices and other
records; `read_obj_with_uv` keeps the texture coordinates (a copy of the JAX
package's geometry/mesh_io.py:68-126, wedge splitting included).
"""
from __future__ import annotations

import numpy as np


def _triangulate_fan(poly):
    return [(poly[0], poly[i], poly[i + 1]) for i in range(1, len(poly) - 1)]


def read_obj(path):
    """Parse an OBJ. Returns (vertices f64 [V,3], faces i32 [F,3]).

    Handles `v x y z` and `f` entries in the `i`, `i/j`, `i//k`, `i/j/k`
    forms with 1-based (or negative, relative) indexing.
    """
    vertices = []
    faces = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "f":
                idxs = []
                for p in parts[1:]:
                    i = int(p.split("/")[0])
                    idxs.append(i - 1 if i > 0 else len(vertices) + i)
                faces.extend(_triangulate_fan(idxs))
    v = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    f = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return v, f


def read_obj_with_uv(path):
    """Parse an OBJ that carries texture coordinates (MeshLab-style export
    where vertices are duplicated along UV seams, so UVs are per-vertex).

    Returns (vertices f64 [V,3], faces i32 [F,3], uv f64 [V,2], mtl_name).
    Wedge UVs (`f v/vt` with vt differing for the same v) are resolved by
    splitting vertices, matching what trimesh produces for such files.
    """
    vertices, uvs, faces = [], [], []
    mtllib = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                vertices.append((float(p[1]), float(p[2]), float(p[3])))
            elif p[0] == "vt":
                uvs.append((float(p[1]), float(p[2])))
            elif p[0] == "mtllib":
                mtllib = line.split(None, 1)[1].strip()
            elif p[0] == "f":
                corners = []
                for tok in p[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    vi = vi - 1 if vi > 0 else len(vertices) + vi
                    ti = None
                    if len(parts) > 1 and parts[1]:
                        t = int(parts[1])
                        ti = t - 1 if t > 0 else len(uvs) + t
                    corners.append((vi, ti))
                faces.extend(_triangulate_fan(corners))

    v = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    vt = np.asarray(uvs, dtype=np.float64).reshape(-1, 2)

    # Split vertices so each has exactly one UV.
    wedge_map = {}  # (vi, ti) -> new vertex id
    new_v, new_uv, new_faces = [], [], []
    for tri in faces:
        idxs = []
        for vi, ti in tri:
            key = (vi, ti)
            if key not in wedge_map:
                wedge_map[key] = len(new_v)
                new_v.append(v[vi])
                new_uv.append(vt[ti] if ti is not None else (0.0, 0.0))
            idxs.append(wedge_map[key])
        new_faces.append(idxs)

    return (
        np.asarray(new_v, dtype=np.float64).reshape(-1, 3),
        np.asarray(new_faces, dtype=np.int32).reshape(-1, 3),
        np.asarray(new_uv, dtype=np.float64).reshape(-1, 2),
        mtllib,
    )


def write_obj(path, vertices, faces):
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
