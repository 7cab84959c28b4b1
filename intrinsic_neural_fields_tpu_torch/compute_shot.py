"""Per-vertex SHOT descriptor matrix for the shape-descriptor experiments
(the port's counterpart of tools/compute_shot.py): a [V, 352] f32 matrix
that a config loads through data.eigenfunctions_path with model.k: 352
(configs/synthetic/shot_blob.yaml).

  python -m intrinsic_neural_fields_tpu_torch.compute_shot out.npy mesh \
      [--radius R] [--min_neighbors 5]

The radius defaults to 5% of the bounding-box diagonal. Host numpy
(geometry/shot.py); vertices with fewer than --min_neighbors support points
get a zero descriptor.
"""
import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out_path", help=".npy output (the eigenfunctions_path the shot configs "
                                    "point at)")
    p.add_argument("path_to_mesh")
    p.add_argument("--radius", type=float, default=None,
                   help="support radius (default: 5%% of the bbox diagonal)")
    p.add_argument("--min_neighbors", type=int, default=5)
    return p.parse_args(argv)


def main(argv=None):
    from .geometry.mesh import load_mesh
    from .geometry.shot import SHOT_DIM, compute_shot_descriptors

    args = parse_args(argv)
    mesh = load_mesh(args.path_to_mesh)
    t0 = time.time()
    E = compute_shot_descriptors(mesh.vertices, mesh.faces, radius=args.radius,
                                 min_neighbors=args.min_neighbors)
    if E.shape != (len(mesh.vertices), SHOT_DIM):
        raise RuntimeError(f"SHOT matrix has shape {E.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out_path)), exist_ok=True)
    np.save(args.out_path, E)
    nz = float((np.linalg.norm(E, axis=1) > 0).mean())
    print(f"wrote {args.out_path}: {E.shape[0]} x {E.shape[1]} f32 in "
          f"{time.time() - t0:.1f}s ({nz:.1%} vertices with support)")
    return E


if __name__ == "__main__":
    main()
