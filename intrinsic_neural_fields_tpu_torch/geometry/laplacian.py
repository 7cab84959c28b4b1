"""Laplace-Beltrami operators on the host (numpy + scipy.sparse).

Conventions match the reference package: the stiffness matrix is POSITIVE
semi-definite (== -igl.cotmatrix) and the mass matrix is diagonal: the
"mixed Voronoi" mass of Meyer et al. (igl MASSMATRIX_TYPE_VORONOI) for
"cotan", the lumped (barycentric) mass of the intrinsic Delaunay metric for
"robust" and "pc_vert_robust".

The robust operator is Sharp & Crane's, "A Laplacian for Nonmanifold
Triangle Meshes" (2020): intrinsic mollification (edge lengths lengthened
so every triangle satisfies the triangle inequality with slack delta), the
tufted double cover (every face duplicated with reversed orientation, so
every edge becomes interior; the VERTEX set stays the input's, so the
operators are halved) and intrinsic Delaunay edge flips: an M-matrix even
on meshes with boundary, skinny triangles or nonmanifold edges.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sparse


def _edge_lengths(vertices, faces):
    """l[F,3], l[:,i] = length of the edge OPPOSITE corner i."""
    t = vertices[faces]
    l0 = np.linalg.norm(t[:, 2] - t[:, 1], axis=-1)
    l1 = np.linalg.norm(t[:, 0] - t[:, 2], axis=-1)
    l2 = np.linalg.norm(t[:, 1] - t[:, 0], axis=-1)
    return np.stack([l0, l1, l2], axis=-1)


def _heron_area(l):
    """Numerically stable (Kahan) triangle areas from edge lengths l[F,3]."""
    a = np.sort(l, axis=-1)[:, ::-1]
    x, y, z = a[:, 0], a[:, 1], a[:, 2]
    arg = (x + (y + z)) * (z - (x - y)) * (z + (x - y)) * (x + (y - z))
    return 0.25 * np.sqrt(np.maximum(arg, 0.0))


def _cotangents_from_lengths(l, area):
    """cot of the interior angle at each corner: (l_j^2 + l_k^2 - l_i^2) / 4A."""
    l2 = l * l
    cots = np.empty_like(l)
    denom = 4.0 * np.maximum(area, 1e-300)[:, None]
    cots[:, 0] = l2[:, 1] + l2[:, 2] - l2[:, 0]
    cots[:, 1] = l2[:, 2] + l2[:, 0] - l2[:, 1]
    cots[:, 2] = l2[:, 0] + l2[:, 1] - l2[:, 2]
    return cots / denom


def _mollify_lengths(l, rel_delta=1e-6):
    """Intrinsic mollification (Sharp & Crane 2020, section 3.3): the
    smallest eps such that every triangle satisfies l_i + l_j >= l_k +
    delta, added to all edge lengths."""
    delta = rel_delta * np.mean(l)
    needed = np.concatenate([
        delta + l[:, 0] - l[:, 1] - l[:, 2],
        delta + l[:, 1] - l[:, 2] - l[:, 0],
        delta + l[:, 2] - l[:, 0] - l[:, 1],
    ])
    eps = max(0.0, float(needed.max()))
    return l + eps


def _assemble_cotan(faces, cots, n_vertices):
    """PSD stiffness from per-corner cotangents: W_ij += cot(c) / 2 for the
    edge (i, j) opposite corner c; L = D - W."""
    ii = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    jj = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]])
    ww = 0.5 * np.concatenate([cots[:, 0], cots[:, 1], cots[:, 2]])
    rows = np.concatenate([ii, jj, ii, jj])
    cols = np.concatenate([jj, ii, ii, jj])
    vals = np.concatenate([-ww, -ww, ww, ww])
    return sparse.coo_matrix((vals, (rows, cols)), shape=(n_vertices, n_vertices)).tocsr()


def _lumped_mass(faces, area, n_vertices):
    m = np.zeros(n_vertices)
    for c in range(3):
        np.add.at(m, faces[:, c], area / 3.0)
    return sparse.diags(m).tocsr()


def cotan_laplacian_from_lengths(faces, lengths, n_vertices):
    """PSD cotan stiffness from an INTRINSIC metric (faces + edge lengths)."""
    faces = np.asarray(faces, dtype=np.int64)
    cots = _cotangents_from_lengths(lengths, _heron_area(lengths))
    return _assemble_cotan(faces, cots, n_vertices)


def barycentric_mass_from_lengths(faces, lengths, n_vertices):
    """Diagonal lumped mass from an intrinsic metric."""
    return _lumped_mass(np.asarray(faces, dtype=np.int64), _heron_area(lengths), n_vertices)


def cotan_laplacian(vertices, faces, mollify=False):
    """Positive semi-definite cotan stiffness matrix (csr)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    l = _edge_lengths(vertices, faces)
    if mollify:
        l = _mollify_lengths(l)
    cots = _cotangents_from_lengths(l, _heron_area(l))
    return _assemble_cotan(faces, cots, vertices.shape[0])


def robust_laplacian(vertices, faces):
    """(L PSD csr, M diagonal csr), Sharp & Crane's robust operator:
    mollification -> tufted double cover -> intrinsic Delaunay flips (the
    native core) -> cotan stiffness and lumped mass of the flipped metric,
    halved."""
    from .intrinsic_delaunay import build_double_cover, intrinsic_delaunay

    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    l = _mollify_lengths(_edge_lengths(vertices, faces))
    faces_cov, l_cov = build_double_cover(faces, l)
    faces_idt, l_idt, _ = intrinsic_delaunay(faces_cov, l_cov)
    n = vertices.shape[0]
    L = 0.5 * cotan_laplacian_from_lengths(faces_idt, l_idt, n)
    M = (0.5 * barycentric_mass_from_lengths(faces_idt, l_idt, n)).tocsr()
    d = M.diagonal()
    if d.min() <= 0:
        eps = 1e-12 * d[d > 0].mean()
        M = sparse.diags(np.maximum(d, eps)).tocsr()
    return L.tocsr(), M


def barycentric_mass_matrix(vertices, faces):
    """Diagonal lumped mass: one third of incident face area per vertex."""
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    return _lumped_mass(faces, _heron_area(_edge_lengths(vertices, faces)), vertices.shape[0])


def voronoi_mass_matrix(vertices, faces):
    """Diagonal mixed-Voronoi (hybrid) mass matrix of Meyer et al. 2003.

    Non-obtuse triangle, corner i: A_i = (l_j^2 cot(j) + l_k^2 cot(k)) / 8.
    Obtuse triangle: area/2 at the obtuse corner, area/4 at the others.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    l = _edge_lengths(vertices, faces)
    area = _heron_area(l)
    cots = _cotangents_from_lengths(l, area)
    l2 = l * l
    vor = np.empty_like(l)
    vor[:, 0] = (l2[:, 1] * cots[:, 1] + l2[:, 2] * cots[:, 2]) / 8.0
    vor[:, 1] = (l2[:, 2] * cots[:, 2] + l2[:, 0] * cots[:, 0]) / 8.0
    vor[:, 2] = (l2[:, 0] * cots[:, 0] + l2[:, 1] * cots[:, 1]) / 8.0
    obtuse_at = cots < 0.0
    any_obtuse = obtuse_at.any(axis=-1, keepdims=True)
    hybrid = np.where(
        any_obtuse,
        np.where(obtuse_at, area[:, None] / 2.0, area[:, None] / 4.0),
        vor,
    )
    m = np.zeros(vertices.shape[0])
    for c in range(3):
        np.add.at(m, faces[:, c], hybrid[:, c])
    return sparse.diags(m).tocsr()


def build_laplacian(mesh, laplacian_type="cotan"):
    """(L PSD csr, M diagonal csr) for a mesh, by the reference's
    laplacian_type switch."""
    if laplacian_type == "cotan":
        return (cotan_laplacian(mesh.vertices, mesh.faces),
                voronoi_mass_matrix(mesh.vertices, mesh.faces))
    if laplacian_type == "robust":
        return robust_laplacian(mesh.vertices, mesh.faces)
    if laplacian_type == "pc_vert_robust":
        from .pointcloud import point_cloud_laplacian

        return point_cloud_laplacian(mesh.vertices)
    raise RuntimeError(f"Laplacian type {laplacian_type} not implemented.")
