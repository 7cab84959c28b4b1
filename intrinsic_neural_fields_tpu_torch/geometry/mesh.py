"""Host triangle-mesh container (numpy) and loading, preserving file
vertex/face order. Point-cloud files (no faces) are loaded and locally
triangulated (geometry/pointcloud.py), so the ray tracer and the
barycentric interpolation treat them as meshes."""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from .mesh_io import read_mesh_file


@functools.lru_cache(maxsize=8)
def is_pointcloud_file(path):
    """True if the file stores points without faces."""
    _, faces = read_mesh_file(path)
    return faces.shape[0] == 0


@dataclass
class Mesh:
    """A triangle mesh: vertices f64 [V,3] (numpy, host), faces i32 [F,3]."""

    vertices: np.ndarray
    faces: np.ndarray
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float64)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 3:
            raise ValueError(f"vertices must be [V,3], got {self.vertices.shape}")
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"faces must be [F,3], got {self.faces.shape}")

    @property
    def num_vertices(self):
        return self.vertices.shape[0]

    @property
    def num_faces(self):
        return self.faces.shape[0]

    @property
    def triangles(self):
        """[F,3,3] corner positions."""
        return self.vertices[self.faces]

    @property
    def face_normals(self):
        """Unit face normals [F,3] (right-hand rule over (v1-v0)x(v2-v0))."""
        if "face_normals" not in self._cache:
            t = self.triangles
            n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
            norm = np.linalg.norm(n, axis=-1, keepdims=True)
            self._cache["face_normals"] = n / np.maximum(norm, 1e-300)
        return self._cache["face_normals"]

    @property
    def face_areas(self):
        if "face_areas" not in self._cache:
            t = self.triangles
            n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
            self._cache["face_areas"] = 0.5 * np.linalg.norm(n, axis=-1)
        return self._cache["face_areas"]

    def apply_transform(self, T):
        """Apply a 4x4 homogeneous transform in place."""
        T = np.asarray(T, dtype=np.float64)
        v_h = np.concatenate([self.vertices, np.ones_like(self.vertices[:, :1])], axis=-1)
        self.vertices = (v_h @ T.T)[:, :3]
        self._cache.clear()
        return self


def load_pointcloud(path, n_neighbors=16):
    """Load a point-cloud file and build a local triangulation around the
    points. Invalid faces are dropped; point order preserved."""
    from .pointcloud import local_triangulation

    pts, _ = read_mesh_file(path)
    return Mesh(vertices=pts, faces=local_triangulation(pts, n_neighbors=n_neighbors))


def load_mesh(path):
    """Load a triangle mesh (OBJ, PLY, OFF) or a point cloud (a faceless PLY
    or OFF, or .xyz), preserving vertex/face order. One parse: a faceless
    file is detected from the same read and locally triangulated."""
    v, f = read_mesh_file(path)
    if f.shape[0] == 0:
        from .pointcloud import local_triangulation

        return Mesh(vertices=v, faces=local_triangulation(v))
    return Mesh(vertices=v, faces=f)
