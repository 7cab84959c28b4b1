"""Eigenfunction preprocessing CLI of the port (reference
preprocess_eigenfunctions.py):

  python -m intrinsic_neural_fields_tpu_torch.preprocess_eigenfunctions out_dir mesh k_max \
      [--laplacian_type cotan|robust|pc_vert_robust] [--keep_first_efunc] \
      [--method shift_invert|dense|lobpcg|chefsi] [--device cuda]

Writes eigenfunctions_<base>.npy and eigenvalues_<base>.npy with
<base> = <laplacian_type>_kmax<k_max>_{skip_first_efuncs|all_efuncs}, the
JAX CLI's naming, and symlinks the mesh into out_dir. The mesh may be an
OBJ, PLY or OFF file or a faceless point cloud (locally triangulated;
pc_vert_robust is the point-cloud Laplacian). shift_invert is scipy on the
host; dense, lobpcg and chefsi run on --device.
"""
import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess the eigenfunctions of a mesh")
    parser.add_argument("out_dir", type=str)
    parser.add_argument("path_to_mesh", type=str)
    parser.add_argument("k_max", type=int)
    parser.add_argument("--laplacian_type", default="cotan", type=str,
                        help="cotan, robust, pc_vert_robust")
    parser.add_argument("--keep_first_efunc", default=False, action="store_true")
    parser.add_argument("--method", default="shift_invert", type=str,
                        help="eigensolver: shift_invert (host oracle), dense, lobpcg or chefsi "
                             "(on --device)")
    parser.add_argument("--device", default="cuda",
                        help="device of the dense, lobpcg and chefsi solvers")
    return parser.parse_args(argv)


def main(argv=None):
    from .spectral.eigensolver import EigenfuncsProcessor

    args = parse_args(argv)
    geometry = "pointcloud" if args.laplacian_type == "pc_vert_robust" else "mesh"
    print(f"Computing the first {args.k_max} eigenfunctions of a {geometry}...")
    proc = EigenfuncsProcessor(args.path_to_mesh, args.k_max, args.laplacian_type,
                               skip_first_efunc=(not args.keep_first_efunc), method=args.method,
                               device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    skip_suffix = "all_efuncs" if args.keep_first_efunc else "skip_first_efuncs"
    base = f"{args.laplacian_type}_kmax{args.k_max}_{skip_suffix}"
    np.save(os.path.join(args.out_dir, f"eigenfunctions_{base}.npy"), proc.get_eigenfunctions())
    np.save(os.path.join(args.out_dir, f"eigenvalues_{base}.npy"), proc.get_eigenvalues())

    mesh_dst = os.path.join(args.out_dir, os.path.basename(args.path_to_mesh))
    if not os.path.exists(mesh_dst):
        os.symlink(src=os.path.abspath(args.path_to_mesh), dst=mesh_dst)
    print("Done.")


if __name__ == "__main__":
    main()
