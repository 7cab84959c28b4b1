"""Host-side mesh file IO: OBJ, PLY (ascii and binary, faceless point
clouds included) and OFF (numpy only; copies of the JAX package's
geometry/mesh_io.py).

Vertex and face order are preserved exactly as stored in the file. Polygons
are fan-triangulated. `read_obj` ignores texture/normal indices and other
records; `read_obj_with_uv` keeps the texture coordinates (wedge splitting
included).
"""
from __future__ import annotations

import os
import struct

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


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


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


def read_ply(path):
    """Parse a PLY file (ascii, binary_little_endian, or binary_big_endian).

    Returns (vertices f64 [V,3], faces i32 [F,3]). Faces may be empty
    ([0,3]) for point-cloud PLYs. Extra vertex properties (normals, colors,
    quality, even list-typed ones) are skipped; unknown property dtypes and
    formats raise with an actionable message.
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file (missing 'ply' magic)")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype) or ('list', count_dt, item_dt, name)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in PLY header")
            tokens = line.decode("ascii", errors="replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment" or tokens[0] == "obj_info":
                continue
            elif tokens[0] == "element":
                cur = {"name": tokens[1], "count": int(tokens[2]), "props": []}
                elements.append(cur)
            elif tokens[0] == "property":
                try:
                    if tokens[1] == "list":
                        cur["props"].append(("list", _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]], tokens[4]))
                    else:
                        cur["props"].append((tokens[2], _PLY_DTYPES[tokens[1]]))
                except KeyError as e:
                    raise NotImplementedError(
                        f"{path}: PLY property type {e} not supported "
                        f"(known: {sorted(_PLY_DTYPES)})"
                    ) from None
            elif tokens[0] == "end_header":
                break

        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise NotImplementedError(
                f"{path}: PLY format '{fmt}' not supported (ascii, "
                "binary_little_endian, binary_big_endian are)"
            )
        bo = ">" if fmt == "binary_big_endian" else "<"

        vertices = np.zeros((0, 3), dtype=np.float64)
        faces = np.zeros((0, 3), dtype=np.int32)

        for elem in elements:
            name, count, props = elem["name"], elem["count"], elem["props"]
            has_list = any(p[0] == "list" for p in props)
            if fmt == "ascii":
                rows = [f.readline().decode("ascii").split() for _ in range(count)]
                if name == "vertex":
                    names = [p[0] for p in props]
                    ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                    vertices = np.array(
                        [[float(r[ix]), float(r[iy]), float(r[iz])] for r in rows], dtype=np.float64
                    ).reshape(-1, 3)
                elif name == "face":
                    polys = [[int(t) for t in r[1 : 1 + int(r[0])]] for r in rows]
                    tris = []
                    for p in polys:
                        tris.extend(_triangulate_fan(p))
                    faces = np.asarray(tris, dtype=np.int32).reshape(-1, 3)
            else:  # binary (either endianness)
                if not has_list:
                    dt = np.dtype([(p[0], bo + p[1]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
                    if name == "vertex":
                        vertices = np.stack(
                            [data["x"], data["y"], data["z"]], axis=-1
                        ).astype(np.float64)
                else:
                    # generic item-by-item path for elements with list
                    # properties: collects face polygons AND vertex x/y/z
                    # (a vertex element can legally carry a list property)
                    tris = []
                    verts = []
                    for _ in range(count):
                        row_polys = None
                        row_xyz = {}
                        for p in props:
                            if p[0] == "list":
                                cnt_dt, item_dt = np.dtype(bo + p[1]), np.dtype(bo + p[2])
                                n = int(np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0])
                                items = np.frombuffer(f.read(item_dt.itemsize * n), dtype=item_dt, count=n)
                                if p[3] in ("vertex_indices", "vertex_index"):
                                    row_polys = [int(x) for x in items]
                            else:
                                dt = np.dtype(bo + p[1])
                                raw = np.frombuffer(f.read(dt.itemsize), dtype=dt)
                                if p[0] in ("x", "y", "z"):
                                    row_xyz[p[0]] = float(raw[0])
                        if name == "face" and row_polys is not None:
                            tris.extend(_triangulate_fan(row_polys))
                        if name == "vertex" and len(row_xyz) == 3:
                            verts.append((row_xyz["x"], row_xyz["y"], row_xyz["z"]))
                    if name == "face":
                        faces = np.asarray(tris, dtype=np.int32).reshape(-1, 3)
                    if name == "vertex" and verts:
                        vertices = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    return vertices, faces


def read_off(path):
    """Parse an OFF file. Returns (vertices f64 [V,3], faces i32 [F,3]).

    Tolerates '#' comments (full-line or trailing) and the header keyword
    fused with the counts line ('OFF 8 12 18'). COFF/NOFF/STOFF variants
    carry extra per-vertex fields this parser does not model — rejected
    with an actionable error rather than misparsed.
    """
    lines = []
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if line:
                lines.append(line)
    tokens = " ".join(lines).split()
    i = 0
    if tokens and tokens[i].upper().endswith("OFF") and not tokens[i].lstrip("+-").replace(".", "").isdigit():
        if tokens[i] != "OFF":
            raise NotImplementedError(
                f"{path}: OFF variant '{tokens[i]}' carries extra per-vertex "
                "fields (colors/normals); only plain OFF is supported"
            )
        i += 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    v = np.array(tokens[i : i + 3 * nv], dtype=np.float64).reshape(nv, 3)
    i += 3 * nv
    tris = []
    for _ in range(nf):
        n = int(tokens[i])
        poly = [int(t) for t in tokens[i + 1 : i + 1 + n]]
        tris.extend(_triangulate_fan(poly))
        i += 1 + n
    return v, np.asarray(tris, dtype=np.int32).reshape(-1, 3)


def read_mesh_file(path):
    """Dispatch by extension. Returns (vertices f64 [V,3], faces i32 [F,3])."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return read_obj(path)
    if ext == ".ply":
        return read_ply(path)
    if ext == ".off":
        return read_off(path)
    if ext == ".xyz":
        pts = np.loadtxt(path, dtype=np.float64)[:, :3]
        return pts.reshape(-1, 3), np.zeros((0, 3), dtype=np.int32)
    raise ValueError(f"Unsupported mesh format: {path}")


def write_obj(path, vertices, faces):
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def write_ply(path, vertices, faces):
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(path, "wb") as f:
        header = [
            "ply",
            "format binary_little_endian 1.0",
            f"element vertex {len(vertices)}",
            "property float x",
            "property float y",
            "property float z",
            f"element face {len(faces)}",
            "property list uchar int vertex_indices",
            "end_header",
        ]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        for face in faces:
            f.write(struct.pack("<Biii", 3, int(face[0]), int(face[1]), int(face[2])))
