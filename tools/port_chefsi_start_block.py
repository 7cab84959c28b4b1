"""CheFSI in the JAX package and in the port from the same start block, at
the HQ recipe's solve: the blob's cotan operator (subdivision 5, the
synthetic dataset's mesh) and k + 1 = 513 functions, both with the
default f32 device pre-filter in the polish (refine_filter="device"),
against ARPACK shift-invert.

  JAX_PLATFORMS=cpu python tools/port_chefsi_start_block.py \
      [--subdivisions 5] [--k 513] [--seed 0]

Both solvers draw their start blocks from PRNGKey(seed) (the port through
utils/jax_random.py); the script prints the largest ulp distance between
the two start blocks, then per solver the relative error of the top
eigenvalue and the largest over the window (|ev - ev_ref| / max ev_ref)
and its seconds, as one JSON line. Needs JAX; runs on the CPU (a few
minutes at the default size).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--subdivisions", type=int, default=5)
    parser.add_argument("--k", type=int, default=513)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)

    import jax

    from intrinsic_neural_fields_tpu.spectral import eigensolver as jeig
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
    from intrinsic_neural_fields_tpu_torch.spectral import eigensolver as peig
    from intrinsic_neural_fields_tpu_torch.utils.jax_random import PRNGKey, fold_in, normal

    mesh = blob_mesh(args.subdivisions)
    L, M = build_laplacian(mesh, "cotan")
    n, k = L.shape[0], args.k
    m = k + max(int(k * 0.2), 16)  # the subspace both solvers iterate
    key = jax.random.PRNGKey(args.seed)
    start_ulps = 0
    for got, want in ((normal(PRNGKey(args.seed), (n, 1)), jax.random.normal(key, (n, 1))),
                      (normal(fold_in(PRNGKey(args.seed), 1), (n, m)),
                       jax.random.normal(jax.random.fold_in(key, 1), (n, m)))):
        ia, ib = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (got, want))
        start_ulps = max(start_ulps, int(np.abs(ia - ib).max()))
    t0 = time.perf_counter()
    ev_ref, _ = peig.solve_generalized_eigenproblem(L, M, k)
    out = {"n": n, "k": k, "seed": args.seed, "start_block_max_ulps": start_ulps,
           "shift_invert_s": time.perf_counter() - t0}
    scale = np.abs(ev_ref).max()
    for name, solve in (
            ("jax", lambda: jeig.solve_generalized_eigenproblem(L, M, k, method="chefsi",
                                                                seed=args.seed)),
            ("port", lambda: peig.solve_generalized_eigenproblem(
                L, M, k, method="chefsi", seed=args.seed, refine_filter="device",
                device="cpu"))):
        t0 = time.perf_counter()
        ev, _ = solve()
        err = np.abs(np.asarray(ev, np.float64) - ev_ref) / scale
        out[name] = {"top_rel_err": float(err[-1]), "max_rel_err": float(err.max()),
                     "s": time.perf_counter() - t0}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
