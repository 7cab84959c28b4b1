"""The HQ texture-transfer experiment's inputs (the port's copy of
tools/make_transfer_targets.py, which imports the JAX package): target
shapes, point-to-point correspondences, full (constant-including)
eigenbases and carried-texture ground-truth views.

  python -m intrinsic_neural_fields_tpu_torch.make_transfer_targets \
      [--out_dir data/transfer_hq] [--src_dataset data/synthetic_hq] \
      [--src_efuncs <trained k=512 basis>] [--targets coarse dense deformed] \
      [--tracer device|host] [--device cuda]

The SOURCE is the HQ synthetic blob (icosphere subdivision 5, 10,242
vertices); the TARGETS re-discretize or deform the same surface:

  coarse    the subdivision-4 blob (2,562 vertices). Subdivision keeps the
            parent vertices as a prefix and the bump is per-vertex, so the
            correspondence is exact: target vertex i == source vertex i.
  dense     the subdivision-6 blob (40,962 vertices); the first 10,242
            correspond exactly, the edge midpoints map to the nearest
            source vertex.
  deformed  the source under a smooth z-twist (non-rigid, near-isometric;
            vertex order kept, correspondence = identity), with test views
            whose texture is CARRIED along the deformation (the colour of a
            deformed point is the procedural texture at its source position).
  cloud     (not ported: the PLY reader, the local triangulation and the
            pc_vert_robust Laplacian are ROADMAP queue 1 item 5) raises.

Written per target: <name>.obj, corr_<name>.npy (target -> source ids,
int64), efuncs_full_<name>.npy ([V, 1 + k_basis] unrescaled: the analytic
constant phi0 = 1/sqrt(1^T M 1) spliced in front of a deterministic
skip-first shift-invert solve) and efuncs_skip_<name>.npy; plus
source_efuncs_full.npy (the TRAINED basis behind the constant, the
contract of texture_transfer) and, for `deformed`, a MeshViews-layout
directory of carried-texture test views. Host code except `--tracer
device`, which traces the deformed views on --device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

TARGETS = ("coarse", "dense", "cloud", "deformed")


def constant_eigenfunction(M):
    """The analytic first LBO eigenfunction: phi0 = 1/sqrt(total mass),
    M-normalized (phi0^T M phi0 = 1)."""
    m = np.asarray(M.diagonal(), dtype=np.float64)
    return np.full(m.shape[0], 1.0 / np.sqrt(m.sum()))


def spliced_full_basis(mesh, k_basis, laplacian_type):
    """[V, 1+k_basis] unrescaled basis: analytic constant + deterministic
    skip-first shift-invert solve. Returns (basis, M)."""
    from .geometry.laplacian import build_laplacian
    from .spectral.eigensolver import compute_first_k_eigenfunctions

    _, M = build_laplacian(mesh, laplacian_type)
    E = compute_first_k_eigenfunctions(mesh, k_basis, laplacian_type, skip_first_efunc=True)
    phi0 = constant_eigenfunction(M)
    return np.concatenate([phi0[:, None], E], axis=1).astype(np.float64), M


def twist_deform(vertices, rate=0.6):
    """Smooth twist about the z axis: rotate (x, y) by rate * z radians.
    Non-rigid, volume-preserving, near-isometric for moderate rates."""
    v = np.asarray(vertices, dtype=np.float64)
    theta = rate * v[:, 2]
    c, s = np.cos(theta), np.sin(theta)
    out = v.copy()
    out[:, 0] = c * v[:, 0] - s * v[:, 1]
    out[:, 1] = s * v[:, 0] + c * v[:, 1]
    return out


def nearest_vertex_correspondence(target_verts, source_verts):
    from scipy.spatial import cKDTree

    return cKDTree(source_verts).query(target_verts)[1].astype(np.int64)


def make_deformed_views(out_dir, deformed_mesh, source_verts, src_dataset, split,
                        tracer="device", device="cuda"):
    """Carried-texture GT views of the deformed mesh through the SOURCE
    dataset's `split` cameras, in MeshViewsDataset layout."""
    from .data.datasets import read_split_list
    from .geometry.synthetic import _host_bvh_or_none, render_gt_view
    from .utils.io import imread, imwrite

    names = [n.strip() for n in read_split_list(src_dataset, split) if n.strip()]
    os.makedirs(out_dir, exist_ok=True)
    bvh = _host_bvh_or_none(deformed_mesh) if tracer == "host" else None
    for name in names:
        cams = np.load(os.path.join(src_dataset, name, "depth", "cameras.npz"))
        cam, K = cams["world_mat_0"], cams["camera_mat_0"]
        # image size from the source view's mask
        src_mask = imread(os.path.join(src_dataset, name, "depth", "mask.png"))
        H, W = src_mask.shape[:2]
        img, mask = render_gt_view(deformed_mesh, cam, K, H, W, tracer=tracer,
                                   texture_positions=source_verts, bvh=bvh, device=device)
        vdir = os.path.join(out_dir, name)
        os.makedirs(os.path.join(vdir, "depth"), exist_ok=True)
        os.makedirs(os.path.join(vdir, "image"), exist_ok=True)
        np.savez(os.path.join(vdir, "depth", "cameras.npz"), world_mat_0=cam, camera_mat_0=K)
        imwrite(os.path.join(vdir, "depth", "mask.png"), (mask * 255).astype(np.uint8))
        imwrite(os.path.join(vdir, "image", "000.png"), img)
    with open(os.path.join(out_dir, f"{split}.lst"), "w") as f:
        f.write("\n".join(names) + "\n")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="data/transfer_hq")
    p.add_argument("--src_dataset", default="data/synthetic_hq")
    p.add_argument("--src_efuncs", default=(
        "data/synthetic_hq/efuncs/eigenfunctions_cotan_kmax512_skip_first_efuncs.npy"))
    p.add_argument("--src_subdivisions", type=int, default=5)
    p.add_argument("--k_basis", type=int, default=1024,
                   help="non-constant target basis size (richer than the trained k, so "
                        "the mapped functions are well represented)")
    p.add_argument("--twist_rate", type=float, default=0.6)
    p.add_argument("--targets", nargs="+", choices=TARGETS,
                   default=["coarse", "dense", "deformed"])
    p.add_argument("--tracer", default="device", choices=("host", "device"))
    p.add_argument("--device", default="cuda", help="device of --tracer device")
    return p.parse_args(argv)


def main(argv=None):
    from .geometry.laplacian import build_laplacian
    from .geometry.mesh import Mesh
    from .geometry.mesh_io import write_obj
    from .geometry.synthetic import blob_mesh

    args = parse_args(argv)
    if "cloud" in args.targets:
        raise NotImplementedError(
            "the cloud target needs the PLY reader, the local triangulation and the "
            "pc_vert_robust Laplacian, not ported yet (ROADMAP queue 1 item 5)")
    out = args.out_dir
    os.makedirs(out, exist_ok=True)
    source = blob_mesh(subdivisions=args.src_subdivisions)
    n_src = source.num_vertices

    # Source full basis: the TRAINED (on-disk, deterministic) columns spliced
    # behind the analytic constant — texture_transfer's contract.
    E_src = np.load(args.src_efuncs)
    assert E_src.shape[0] == n_src, (E_src.shape, n_src)
    _, M_src = build_laplacian(source, "cotan")
    src_full = np.concatenate([constant_eigenfunction(M_src)[:, None], E_src], axis=1)
    np.save(os.path.join(out, "source_efuncs_full.npy"), src_full)
    print(f"source basis: {src_full.shape}")

    def solve_and_save(name, mesh, laplacian_type):
        path = os.path.join(out, f"efuncs_full_{name}.npy")
        if os.path.exists(path):
            print(f"{name}: basis exists, skipping solve")
            return
        basis, _ = spliced_full_basis(mesh, args.k_basis, laplacian_type)
        np.save(path, basis)
        # the skip-first view of the same solve, for a direct-swap baseline
        np.save(os.path.join(out, f"efuncs_skip_{name}.npy"), basis[:, 1:].astype(np.float32))
        print(f"{name}: basis {basis.shape} ({laplacian_type})")

    if "coarse" in args.targets:
        coarse = blob_mesh(subdivisions=args.src_subdivisions - 1)
        write_obj(os.path.join(out, "coarse.obj"), coarse.vertices, coarse.faces)
        # subdivision prefix property: exact identity correspondence
        assert np.allclose(coarse.vertices, source.vertices[: coarse.num_vertices])
        np.save(os.path.join(out, "corr_coarse.npy"),
                np.arange(coarse.num_vertices, dtype=np.int64))
        solve_and_save("coarse", coarse, "cotan")

    if "dense" in args.targets:
        dense = blob_mesh(subdivisions=args.src_subdivisions + 1)
        write_obj(os.path.join(out, "dense.obj"), dense.vertices, dense.faces)
        assert np.allclose(dense.vertices[:n_src], source.vertices)
        corr = nearest_vertex_correspondence(dense.vertices, source.vertices)
        corr[:n_src] = np.arange(n_src)  # prefix is exact
        np.save(os.path.join(out, "corr_dense.npy"), corr)
        solve_and_save("dense", dense, "cotan")

    if "deformed" in args.targets:
        deformed = Mesh(vertices=twist_deform(source.vertices, rate=args.twist_rate),
                        faces=source.faces.copy())
        write_obj(os.path.join(out, "deformed.obj"), deformed.vertices, deformed.faces)
        np.save(os.path.join(out, "corr_deformed.npy"), np.arange(n_src, dtype=np.int64))
        solve_and_save("deformed", deformed, "cotan")
        views_dir = os.path.join(out, "deformed_views")
        if os.path.exists(os.path.join(views_dir, "test.lst")):
            print("deformed GT views exist, skipping render")
        else:
            print("rendering carried-texture GT test views on the deformed mesh...")
            make_deformed_views(views_dir, deformed, source.vertices, args.src_dataset, "test",
                                tracer=args.tracer, device=args.device)

    print(f"Transfer targets written to {out}")


if __name__ == "__main__":
    main()
