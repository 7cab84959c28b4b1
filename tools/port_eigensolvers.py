#!/usr/bin/env python
"""The port's device eigensolvers at full size on one NVIDIA GPU.

  python tools/port_eigensolvers.py [--sections dense chefsi spmv]
      [--dense_n 6000 20000] [--chefsi_subdivisions 6] [--k 529]
      [--out chiprun_out/eigensolvers.jsonl]

- dense: torch.linalg.eigh in f32 on the card of C = M^-1/2 L M^-1/2 of a
  point cloud sampled on the HQ blob (pc_vert_robust), at each --dense_n:
  its time (CUDA events around the call, after one warm-up at n=512) and
  peak device memory beyond the matrix (max_memory_allocated after
  reset_peak_memory_stats), and the 65 smallest eigenvalues' largest error
  against shift_invert beside eps32 ||C|| (Gershgorin). The dense method
  routes only 4096 < n <= 6000 to the card; this section measures what a
  wider window would cost.
- chefsi: solve_generalized_eigenproblem(method="chefsi", device="cuda")
  on icosphere(--chefsi_subdivisions)'s cotan operator at k=--k (529 =
  23^2 fills the sphere's shells l <= 22, so the span is unique), with the
  default device-filtered polish and with the all-f64 host polish, against
  shift_invert: wall seconds of the device loop and of the polish, rounds,
  peak device memory, eigenvalue error of the largest, principal angles,
  M-orthonormality.
- spmv: the padded-ELL gather product (spectral/eigensolver.ell_spmv)
  against cuSPARSE's CSR product (torch.sparse_csr_tensor @ X) and the
  bound, at the CheFSI loop's [n, m] for the HQ blob and icosphere 6 and 7.

One JSON line per measurement, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def _emit(out, **row):
    line = json.dumps(row)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def _cloud_operator(n, seed=0):
    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import robust_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.pointcloud import local_triangulation
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh

    mesh = blob_mesh(5)
    rng = np.random.default_rng(seed)
    tri = mesh.vertices[mesh.faces]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    fidx = rng.choice(len(mesh.faces), size=n, p=area / area.sum())
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    w = np.stack([1.0 - s, s * (1.0 - r2), s * r2], axis=-1)
    pts = np.einsum("nk,nkd->nd", w, tri[fidx])
    return robust_laplacian(pts, local_triangulation(pts))


def section_dense(out, sizes):
    import scipy.sparse as sparse
    import torch

    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import shift_invert_eigenpairs

    torch.linalg.eigh(torch.eye(512, device="cuda"))  # cuSOLVER's first-call set-up
    for n in sizes:
        L, M = _cloud_operator(n)
        inv = 1.0 / np.sqrt(M.diagonal())
        C = (sparse.diags(inv) @ L @ sparse.diags(inv)).toarray()
        C = 0.5 * (C + C.T)
        c_norm = float(np.abs(C).sum(axis=1).max())
        A = torch.as_tensor(C, dtype=torch.float32, device="cuda")
        del C
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        evals, _ = torch.linalg.eigh(A)
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        ev = evals[:65].double().cpu().numpy()
        ev_h, _ = shift_invert_eigenpairs(L, M, 65)
        err = float(np.abs(ev - ev_h).max())
        _emit(out, section="dense", n=n, eigh_ms=start.elapsed_time(stop), wall_s=wall,
              peak_bytes_beyond_matrix=peak, matrix_bytes=4 * n * n, max_abs_err_k65=err,
              rel_err_of_largest_k65=err / ev_h.max(),
              err_over_eps32_norm=err / (float(np.finfo(np.float32).eps) * c_norm),
              in_route_window=4096 < n <= 6000)
        del A, evals
        torch.cuda.empty_cache()


def section_chefsi(out, subdivisions, k):
    import torch

    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import (
        shift_invert_eigenpairs, solve_generalized_eigenproblem)

    L, M = build_laplacian(icosphere(subdivisions), "cotan")
    Md = M.diagonal()
    t0 = time.perf_counter()
    ev_h, phi_h = shift_invert_eigenpairs(L, M, k)
    si_s = time.perf_counter() - t0
    _emit(out, section="chefsi", solver="shift_invert", n=L.shape[0], k=k, wall_s=si_s)
    for refine_filter in ("device", "host"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        ev, phi = solve_generalized_eigenproblem(L, M, k, method="chefsi", device="cuda",
                                                 refine_filter=refine_filter, stats=stats)
        wall = time.perf_counter() - t0
        s = np.linalg.svd((phi_h * Md[:, None]).T @ phi, compute_uv=False)
        R = (L @ phi - (M @ phi) * ev[None, :]) / np.sqrt(Md)[:, None]
        _emit(out, section="chefsi", solver="chefsi", refine_filter=refine_filter, k=k,
              wall_s=wall, **stats, peak_device_bytes=torch.cuda.max_memory_allocated(),
              eig_rel_err=float(np.abs(ev - ev_h).max() / np.abs(ev_h).max()),
              max_principal_angle_deg=float(np.degrees(np.arccos(np.clip(s, 0, 1))).max()),
              m_orth_err=float(np.abs((phi * Md[:, None]).T @ phi - np.eye(k)).max()),
              rel_residual=float(np.linalg.norm(R, axis=0).max() / np.abs(ev).max()))


def _cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def section_spmv(out, k):
    import scipy.sparse as sparse
    import torch

    from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian
    from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
    from intrinsic_neural_fields_tpu_torch.geometry.synthetic import blob_mesh
    from intrinsic_neural_fields_tpu_torch.spectral.eigensolver import _ell_arrays, ell_spmv

    for name, mesh, kk in (("hq_blob", blob_mesh(5), 513), ("icosphere6", icosphere(6), k),
                           ("icosphere7", icosphere(7), k)):
        L, M = build_laplacian(mesh, "cotan")
        inv = 1.0 / np.sqrt(M.diagonal())
        idx, w = _ell_arrays(L, inv)
        n, m = L.shape[0], kk + max(int(kk * 0.2), 16)
        spmv, _ = ell_spmv(idx, w, m, 2 << 30, "cuda")
        C = (sparse.diags(inv) @ L @ sparse.diags(inv)).tocsr()
        C_t = torch.sparse_csr_tensor(torch.as_tensor(C.indptr, dtype=torch.int64),
                                      torch.as_tensor(C.indices, dtype=torch.int64),
                                      torch.as_tensor(C.data, dtype=torch.float32), C.shape,
                                      device="cuda", check_invariants=False)
        X = torch.randn(n, m, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
        diff = (spmv(X) - C_t @ X).abs().max().item()
        nbytes = C.nnz * 8 + (n + 1) * 8 + 2 * n * m * 4
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2.0 * C.nnz * m / H100_F32_FLOPS
        _emit(out, section="spmv", mesh=name, n=n, m=m, dmax=int(idx.shape[1]), nnz=int(C.nnz),
              ell_ms=_cuda_ms(lambda: spmv(X)), cusparse_csr_ms=_cuda_ms(lambda: C_t @ X),
              bound_ms=1e3 * max(t_bytes, t_ops),
              bound_by="bytes" if t_bytes > t_ops else "operations", max_abs_diff=diff)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", nargs="+", default=["dense", "chefsi", "spmv"],
                    choices=("dense", "chefsi", "spmv"))
    ap.add_argument("--dense_n", nargs="+", type=int, default=[6000, 20000])
    ap.add_argument("--chefsi_subdivisions", type=int, default=6)
    ap.add_argument("--k", type=int, default=529)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "eigensolvers.jsonl"))
    args = ap.parse_args(argv)
    import torch

    import intrinsic_neural_fields_tpu_torch  # noqa: F401  (TF32 off)

    if not torch.cuda.is_available():
        print("port_eigensolvers: needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if "spmv" in args.sections:
        section_spmv(args.out, args.k)
    if "dense" in args.sections:
        section_dense(args.out, args.dense_n)
    if "chefsi" in args.sections:
        section_chefsi(args.out, args.chefsi_subdivisions, args.k)
    _emit(args.out, nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
