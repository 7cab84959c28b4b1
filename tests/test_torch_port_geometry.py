"""The port's geometry slice against the JAX package on the same inputs:
mesh IO (PLY ascii / binary of both byte orders, with and without faces,
OFF, .xyz) and load_mesh, the local triangulation (C++ core and Python
loop), the intrinsic Delaunay flips (both backends, with the tufted double
cover), the robust and point-cloud Laplacians, and SHOT descriptors.

Tolerances: file IO, faces and flip counts equal; L and M within 1e-12 of
their largest entry (measured: equal to the bit, the same f64 numpy and
C++ built with the same flags); SHOT within 1e-6. The two triangulation
backends agree up to cocircular ties: Jaccard index of their face sets
>= 0.999, the gate of tests/test_native_localtri.py (measured 0.99978 on
the 2,000-point cloud)."""
import os
import struct

import numpy as np
import pytest
import scipy.sparse as sparse

from intrinsic_neural_fields_tpu.geometry import intrinsic_delaunay as jidt
from intrinsic_neural_fields_tpu.geometry import laplacian as jlap
from intrinsic_neural_fields_tpu.geometry import mesh as jmesh
from intrinsic_neural_fields_tpu.geometry import mesh_io as jio
from intrinsic_neural_fields_tpu.geometry import pointcloud as jpc
from intrinsic_neural_fields_tpu.geometry import shot as jshot
from intrinsic_neural_fields_tpu.geometry.primitives import grid_mesh as jax_grid_mesh

from intrinsic_neural_fields_tpu_torch import compute_shot
from intrinsic_neural_fields_tpu_torch.geometry import intrinsic_delaunay as pidt
from intrinsic_neural_fields_tpu_torch.geometry import laplacian as plap
from intrinsic_neural_fields_tpu_torch.geometry import mesh as pmesh
from intrinsic_neural_fields_tpu_torch.geometry import mesh_io as pio
from intrinsic_neural_fields_tpu_torch.geometry import pointcloud as ppc
from intrinsic_neural_fields_tpu_torch.geometry import shot as pshot
from intrinsic_neural_fields_tpu_torch.geometry.primitives import grid_mesh, icosphere
from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
from intrinsic_neural_fields_tpu_torch.make_transfer_targets import write_cloud_ply
from intrinsic_neural_fields_tpu_torch.native import load_idt, load_localtri

TET_V = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
TET_F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
REL = 1e-12


def _ply_header(fmt, nv, nf, vert_props, face_prop="property list uchar int vertex_indices"):
    lines = ["ply", f"format {fmt} 1.0", "comment fixture", f"element vertex {nv}"] + \
        vert_props + [f"element face {nf}", face_prop, "end_header"]
    return ("\n".join(lines) + "\n").encode("ascii")


def _ascii_quads(p):
    hdr = _ply_header("ascii", 4, 2, ["property float x", "property float y", "property float z",
                                      "property uchar red"])
    p.write_bytes(hdr + b"".join(f"{x} {y} {z} 255\n".encode() for x, y, z in TET_V)
                  + b"4 0 1 2 3\n3 1 2 3\n")


def _binary(bo, fmt):
    def write(p):
        hdr = _ply_header(fmt, 4, 4, ["property double x", "property double y",
                                      "property double z", "property float quality"])
        body = b"".join(struct.pack(bo + "dddf", x, y, z, 0.5) for x, y, z in TET_V)
        body += b"".join(struct.pack(bo + "Biii", 3, *map(int, t)) for t in TET_F)
        p.write_bytes(hdr + body)
    return write


def _vertex_list_prop(p):
    hdr = _ply_header("binary_little_endian", 4, 1, [
        "property float x", "property float y", "property float z",
        "property list uchar float weights"])
    body = b"".join(struct.pack("<fff", *v) + struct.pack("<Bff", 2, 0.25, 0.75) for v in TET_V)
    p.write_bytes(hdr + body + struct.pack("<Biii", 3, 0, 1, 2))


def _ascii_cloud(p):
    pts = blob_mesh(1).vertices
    hdr = ("ply\nformat ascii 1.0\nelement vertex %d\nproperty float x\nproperty float y\n"
           "property float z\nend_header\n" % len(pts)).encode()
    p.write_bytes(hdr + b"".join(f"{x:.6f} {y:.6f} {z:.6f}\n".encode() for x, y, z in pts))


def _binary_cloud(p):
    write_cloud_ply(str(p), blob_mesh(2).vertices)


def _written_ply(p):
    pio.write_ply(str(p), TET_V, TET_F)


def _off(p):
    p.write_text("OFF 4 4 6   # fused header\n# comment\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n"
                 "3 0 1 2\n3 0 1 3\n3 0 2 3\n4 1 2 3 0\n")


def _off_cloud(p):
    pts = blob_mesh(1).vertices
    rows = "".join(f"{x:.17g} {y:.17g} {z:.17g}\n" for x, y, z in pts)
    p.write_text(f"OFF\n{len(pts)} 0 0\n" + rows)


def _xyz(p):
    np.savetxt(str(p), blob_mesh(1).vertices)


FILES = {"ascii_quads.ply": _ascii_quads, "le.ply": _binary("<", "binary_little_endian"),
         "be.ply": _binary(">", "binary_big_endian"), "vlist.ply": _vertex_list_prop,
         "cloud_ascii.ply": _ascii_cloud, "cloud.ply": _binary_cloud,
         "written.ply": _written_ply, "tet.off": _off, "cloud.off": _off_cloud,
         "cloud.xyz": _xyz}


@pytest.mark.parametrize("name", sorted(FILES))
def test_mesh_files_read_and_load_like_jax(tmp_path, name):
    """read_mesh_file and load_mesh (faceless files locally triangulated)
    give the JAX package's arrays, and is_pointcloud_file its answer."""
    path = tmp_path / name
    FILES[name](path)
    path = str(path)
    for got, want in zip(pio.read_mesh_file(path), jio.read_mesh_file(path)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = pmesh.load_mesh(path), jmesh.load_mesh(path)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.face_areas, want.face_areas)
    assert pmesh.is_pointcloud_file(path) == jmesh.is_pointcloud_file(path)
    if name.startswith("cloud"):
        assert got.num_faces > got.num_vertices
        faces = pmesh.load_pointcloud(path, n_neighbors=10).faces
        np.testing.assert_array_equal(faces, jmesh.load_pointcloud(path, n_neighbors=10).faces)
    if name.endswith(".ply"):
        for got, want in zip(pio.read_ply(path), jio.read_ply(path)):
            np.testing.assert_array_equal(got, want)


def test_mesh_io_refuses_what_jax_refuses(tmp_path):
    cases = {"mid.ply": b"ply\nformat binary_middle_endian 1.0\nend_header\n",
             "quad.ply": b"ply\nformat ascii 1.0\nelement vertex 1\n"
                         b"property quadfloat x\nend_header\n0\n",
             "notply.ply": b"solid x\n", "colored.off": b"COFF\n1 0 0\n0 0 0 255 0 0 255\n",
             "mesh.stl": b"solid x\n"}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises((ValueError, NotImplementedError)) as want:
            jio.read_mesh_file(str(tmp_path / name))
        with pytest.raises(type(want.value)) as got:
            pio.read_mesh_file(str(tmp_path / name))
        assert str(got.value) == str(want.value)


def _surface_cloud(n=2000, seed=0):
    """Points sampled uniformly on the faces of icosphere(4): the irregular
    cloud of tests/test_spectral.py::test_chefsi_on_irregular_point_cloud."""
    rng = np.random.default_rng(seed)
    m = icosphere(4)
    tri = m.vertices[m.faces]
    fidx = rng.integers(0, len(m.faces), size=n)
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    w = np.stack([1.0 - s, s * (1.0 - r2), s * r2], axis=-1)
    return np.einsum("nk,nkd->nd", w, tri[fidx])


def _face_set(faces):
    return {tuple(sorted(f)) for f in faces.tolist()}


def test_native_cores_load():
    assert load_localtri() is not None and load_idt() is not None


@pytest.mark.parametrize("native", [True, False])
def test_local_triangulation_matches_jax(native):
    """Each backend gives the JAX package's faces in its order (the JAX
    native call may load its checked-in library, built on another host:
    measured equal here); the two backends agree up to cocircular ties."""
    pts = _surface_cloud()
    got = ppc.local_triangulation(pts, n_neighbors=12, native=native)
    want = jpc.local_triangulation(pts, n_neighbors=12, native=native)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    other = _face_set(ppc.local_triangulation(pts, n_neighbors=12, native=not native))
    mine = _face_set(got)
    assert len(mine & other) / len(mine | other) >= 0.999


def test_local_triangulation_edge_cases():
    assert ppc.local_triangulation(np.zeros((2, 3))).shape == (0, 3)
    line = np.stack([np.linspace(0, 1, 100), np.zeros(100), np.zeros(100)], 1)
    assert len(ppc.local_triangulation(line)) == 0
    dup = np.repeat(blob_mesh(1).vertices, 3, axis=0)
    np.testing.assert_array_equal(ppc.local_triangulation(dup), jpc.local_triangulation(dup))


def _bowtie():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [-1, 0, 0], [-1, -1, 0],
                  [0, -1, 0], [0.5, 0.2, 0.8]], dtype=np.float64)
    f = np.array([[0, 1, 2], [0, 2, 3], [0, 4, 5], [0, 5, 6], [0, 1, 7]], dtype=np.int64)
    return v, f


def _jittered_grid():
    m = grid_mesh(20)
    v = m.vertices.copy()
    v[:, :2] += np.random.default_rng(0).normal(scale=0.01, size=(v.shape[0], 2))
    return v, m.faces.astype(np.int64)


def _cloud_mesh():
    pts = _surface_cloud()
    return pts, ppc.local_triangulation(pts, n_neighbors=12).astype(np.int64)


SURFACES = {"bowtie": _bowtie, "open_grid": lambda: (grid_mesh(24).vertices,
                                                     grid_mesh(24).faces.astype(np.int64)),
            "jittered_grid": _jittered_grid, "cloud_2000": _cloud_mesh}


def _rel(a, b):
    a, b = sparse.csr_matrix(a), sparse.csr_matrix(b)
    return abs(a - b).max() / max(abs(b).max(), 1e-300)


@pytest.mark.parametrize("surface", sorted(SURFACES))
@pytest.mark.parametrize("backend", ["native", "python"])
def test_intrinsic_delaunay_matches_jax(surface, backend):
    """The double cover and the flips of each backend: faces, lengths and
    flip counts equal to the JAX package's; both backends one operator."""
    v, f = SURFACES[surface]()
    l = plap._mollify_lengths(plap._edge_lengths(v, f))
    np.testing.assert_array_equal(l, jlap._mollify_lengths(jlap._edge_lengths(v, f)))
    fc, lc = pidt.build_double_cover(f, l)
    jfc, jlc = jidt.build_double_cover(f, l)
    np.testing.assert_array_equal(fc, jfc)
    np.testing.assert_array_equal(lc, jlc)
    got = pidt.intrinsic_delaunay(fc, lc, backend=backend)
    want = jidt.intrinsic_delaunay(fc, lc, backend=backend)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    other = pidt.intrinsic_delaunay(fc, lc, backend="python" if backend == "native" else "native")
    assert other[2] == got[2]
    n = v.shape[0]
    assert _rel(plap.cotan_laplacian_from_lengths(other[0], other[1], n),
                plap.cotan_laplacian_from_lengths(got[0], got[1], n)) < 1e-9


def test_intrinsic_delaunay_refuses_an_unknown_backend():
    v, f = _bowtie()
    with pytest.raises(ValueError, match="backend"):
        pidt.intrinsic_delaunay(f, plap._edge_lengths(v, f), backend="auto")


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_robust_laplacian_matches_jax(surface):
    """L and M within 1e-12 of their largest entry; an M-matrix with rows
    summing to zero and positive mass."""
    v, f = SURFACES[surface]()
    L, M = plap.robust_laplacian(v, f)
    jL, jM = jlap.robust_laplacian(v, f)
    assert _rel(L, jL) < REL and _rel(M, jM) < REL
    off = (L - sparse.diags(L.diagonal())).toarray()
    assert off.max() < 1e-10
    np.testing.assert_allclose(L @ np.ones(len(v)), 0.0, atol=1e-10)
    assert M.diagonal().min() > 0


def test_build_laplacian_dispatch_matches_jax():
    """cotan, robust and pc_vert_robust through build_laplacian on the same
    mesh (the point-cloud operator from its vertices alone); the mollified
    cotan and the lumped masses too."""
    m = blob_mesh(2)
    jm = jmesh.Mesh(m.vertices, m.faces)
    for lap in ("cotan", "robust", "pc_vert_robust"):
        for got, want in zip(plap.build_laplacian(m, lap), jlap.build_laplacian(jm, lap)):
            assert _rel(got, want) < REL, lap
    assert _rel(plap.cotan_laplacian(m.vertices, m.faces, mollify=True),
                jlap.cotan_laplacian(m.vertices, m.faces, mollify=True)) < REL
    assert _rel(plap.barycentric_mass_matrix(m.vertices, m.faces),
                jlap.barycentric_mass_matrix(m.vertices, m.faces)) < REL
    pts = _surface_cloud(800, seed=1)
    for got, want in zip(ppc.point_cloud_laplacian(pts), jpc.point_cloud_laplacian(pts)):
        assert _rel(got, want) < REL
    with pytest.raises(RuntimeError, match="not implemented"):
        plap.build_laplacian(m, "igl")


def test_robust_spectrum_on_the_open_grid():
    """The flat square's Neumann eigenvalues pi^2 (m^2 + n^2) through the
    robust operator (tests/test_intrinsic_delaunay.py's gate), and the JAX
    package's eigenvalues to 1e-10 relative."""
    from intrinsic_neural_fields_tpu.spectral.eigensolver import (
        solve_generalized_eigenproblem as jax_solve)
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        solve_generalized_eigenproblem)

    m = grid_mesh(24)
    L, M = plap.robust_laplacian(m.vertices, m.faces)
    np.testing.assert_allclose(M.diagonal().sum(), 1.0, rtol=1e-6)
    evals, _ = solve_generalized_eigenproblem(L, M, 5)
    pi2 = np.pi ** 2
    np.testing.assert_allclose(evals, [0.0, pi2, pi2, 2 * pi2, 4 * pi2], rtol=0.03, atol=0.05)
    jm = jax_grid_mesh(24)
    want, _ = jax_solve(*jlap.robust_laplacian(jm.vertices, jm.faces), 5)
    np.testing.assert_allclose(evals, want, rtol=1e-10, atol=1e-12)


def test_shot_descriptors_match_jax(tmp_path):
    """compute_shot_descriptors and vertex_normals on the subdivision-3 blob
    and a rotated copy, within 1e-6; the CLI writes the same matrix."""
    m = blob_mesh(3)
    got = pshot.compute_shot_descriptors(m.vertices, m.faces)
    want = jshot.compute_shot_descriptors(m.vertices, m.faces)
    assert got.shape == (m.num_vertices, pshot.SHOT_DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pshot.vertex_normals(m.vertices, m.faces),
                                  jshot.vertex_normals(m.vertices, m.faces))
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    v = m.vertices @ R.T
    np.testing.assert_allclose(pshot.compute_shot_descriptors(v, m.faces, radius=0.3),
                               jshot.compute_shot_descriptors(v, m.faces, radius=0.3),
                               atol=1e-6, rtol=0)
    mesh_path = str(tmp_path / "blob.obj")
    pio.write_obj(mesh_path, m.vertices, m.faces)
    out = str(tmp_path / "shot" / "blob_shot.npy")
    compute_shot.main([out, mesh_path, "--min_neighbors", "5"])
    back = pmesh.load_mesh(mesh_path)
    np.testing.assert_allclose(np.load(out), jshot.compute_shot_descriptors(
        back.vertices, back.faces), atol=1e-6, rtol=0)
    assert os.path.exists(out)
