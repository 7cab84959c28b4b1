"""Laplace-Beltrami eigendecomposition: L phi = lambda M phi.

Four solver paths, each returning M-orthonormal eigenvectors sorted by
ascending eigenvalue (the JAX package's spectral/eigensolver.py):

  - "shift_invert": scipy ARPACK with sigma=0 on the host, the semantics
    oracle and the default. Retries with L + 1e-10 I when the factorization
    is exactly singular.
  - "dense": eigh of C = M^-1/2 L M^-1/2 (M is diagonal for every
    Laplacian this package builds), phi = M^-1/2 u. The routing is the
    reference's: f32 torch.linalg.eigh on the device for 4096 < n <= 6000,
    f64 host LAPACK outside that window (chosen by size, never on a
    failure).
  - "lobpcg": torch.lobpcg on the device, f32, on the sparse shifted
    operator sigma I - C, whose LARGEST eigenpairs are C's smallest (the
    counterpart of jax's lobpcg_standard). For small k only (the flipped
    spectrum has poor gap ratios) and n >= 3k (torch.lobpcg's limit).
  - "chefsi": Chebyshev-filtered subspace iteration, the at-scale device
    path: an f32 filter + QR + Rayleigh-Ritz loop on the device, then an
    f64 filter + Rayleigh-Ritz polish on the host (see _chefsi_device).

The device paths take `device` ("cuda" by default; without a card it
raises, and "cpu" runs the same torch code on the CPU).
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sparse
import scipy.sparse.linalg as sla

METHODS = ("shift_invert", "dense", "lobpcg", "chefsi")


def _as_diag_array(M):
    d = np.asarray(M.diagonal() if sparse.issparse(M) else np.diag(M), dtype=np.float64)
    offdiag = (M - sparse.diags(d)) if sparse.issparse(M) else (M - np.diag(d))
    nrm = abs(offdiag).sum() if sparse.issparse(M) else np.abs(offdiag).sum()
    if nrm > 1e-12 * abs(d).sum():
        raise ValueError("mass matrix must be diagonal for the on-device solver paths")
    return d


def _arpack_start_vector(n, seed=0):
    """Deterministic, generic ARPACK start vector (seeded uniform; never
    all-ones, which is M-orthogonal to every non-constant eigenfunction)."""
    return np.random.RandomState(seed).uniform(-1.0, 1.0, n)


def shift_invert_eigenpairs(L, M, k):
    """k smallest eigenpairs (evals ascending, evecs [n,k])."""
    n = L.shape[0]
    v0 = _arpack_start_vector(n)
    # A Lanczos basis of at least 64 resolves degenerate multiplicities.
    ncv = min(n, max(2 * k + 1, 64))
    try:
        evals, evecs = sla.eigsh(L, k, M, sigma=0, which="LM", v0=v0, ncv=ncv)
    except RuntimeError as e:
        if e.args != ("Factor is exactly singular",):
            raise
        # Badly conditioned stiffness: nudge the diagonal and retry.
        L = L + 1e-10 * sparse.eye(n)
        evals, evecs = sla.eigsh(L, k, M, sigma=0, which="LM", v0=v0, ncv=ncv)
    order = np.argsort(evals)
    return evals[order], evecs[:, order]


# The dense path's device window: f32 eigh's accuracy suffices only for
# well-separated spectra, and the reference's device eigh ran out of memory
# beyond ~6-8k rows; host LAPACK (f64) covers the small and the large n.
DENSE_DEVICE_WINDOW = (4096, 6000)


def _dense_device(L, M, k, device="cuda"):
    import torch

    d = _as_diag_array(M)
    inv_sqrt = 1.0 / np.sqrt(d)
    Ld = L.toarray() if sparse.issparse(L) else np.asarray(L)
    C = Ld * inv_sqrt[:, None] * inv_sqrt[None, :]
    C = 0.5 * (C + C.T)  # symmetrize against assembly round-off
    n = C.shape[0]
    lo, hi = DENSE_DEVICE_WINDOW
    if lo < n <= hi:
        evals_t, u_t = torch.linalg.eigh(torch.as_tensor(C, dtype=torch.float32, device=device))
        evals = evals_t.double().cpu().numpy()
        u = u_t.double().cpu().numpy()
    else:
        evals, u = np.linalg.eigh(C)
    return evals[:k], u[:, :k] * inv_sqrt[:, None]


def _lobpcg_device(L, M, k, tol=1e-6, maxiter=400, seed=0, device="cuda"):
    import torch

    from ..utils.jax_random import PRNGKey, normal

    d = _as_diag_array(M)
    inv_sqrt = 1.0 / np.sqrt(d)
    n = L.shape[0]
    Lcoo = L.tocoo()
    # C = D^-1/2 L D^-1/2 and the Gershgorin bound on lambda_max(C), on the
    # host; sigma I - C flips the spectrum so that LOBPCG's largest-eigenpair
    # iteration finds C's smallest.
    vals = Lcoo.data * inv_sqrt[Lcoo.row] * inv_sqrt[Lcoo.col]
    row_abs = np.zeros(n)
    np.add.at(row_abs, Lcoo.row, np.abs(vals))
    sigma = float(row_abs.max()) * 1.01 + 1e-6
    A = (sigma * sparse.eye(n) - sparse.coo_matrix((vals, (Lcoo.row, Lcoo.col)),
                                                   shape=L.shape)).tocoo()
    A_t = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([A.row, A.col]), dtype=torch.int64),
        torch.as_tensor(A.data, dtype=torch.float32), (n, n), device=device,
        check_invariants=False).coalesce()
    X0 = normal(PRNGKey(seed), (n, k), device=device)  # JAX eigensolver.py:136
    # method="basic" (Knyazev's LOBPCG, as jax's lobpcg_standard): torch's
    # default "ortho" keeps iterating below f32's floor when tol is tighter
    # than f32 can reach and its Ritz values then drift (on icosphere(2),
    # k=10, tol=1e-7: 3.6e-3 off shift_invert against "basic"'s 4.7e-5).
    theta, u = torch.lobpcg(A_t, k=k, X=X0, niter=maxiter, tol=tol, largest=True,
                            method="basic")
    evals = sigma - theta.double().cpu().numpy()
    u = u.double().cpu().numpy()
    order = np.argsort(evals)
    return evals[order], u[:, order] * inv_sqrt[:, None]


def _ell_arrays(L, inv_sqrt):
    """C = D^{-1/2} L D^{-1/2} in padded-ELL layout: per-row neighbor index
    and weight matrices [n, dmax] (pad: self-index, weight 0). A sparse
    matvec then is one row gather + a small weighted reduction."""
    Lcsr = L.tocsr()
    n = Lcsr.shape[0]
    deg = np.diff(Lcsr.indptr)
    dmax = int(deg.max())
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, dmax))
    w = np.zeros((n, dmax), dtype=np.float32)
    coo = Lcsr.tocoo()
    order = np.argsort(coo.row, kind="stable")
    rows, cols, vals = coo.row[order], coo.col[order], coo.data[order]
    pos = np.concatenate([[0], np.cumsum(deg)])
    within = np.arange(len(rows)) - pos[rows]
    idx[rows, within] = cols.astype(np.int32)
    w[rows, within] = (vals * inv_sqrt[rows] * inv_sqrt[cols]).astype(np.float32)
    return idx, w


def ell_spmv(idx_np, w_np, m, spmv_bytes_budget, device):
    """X [n, c] -> C X on the device, C in padded-ELL (`_ell_arrays`): a
    row gather X[idx] ([n, dmax, c]) and a weighted sum over the dmax
    neighbors. Where the one-shot gather at c = m columns would pass
    `spmv_bytes_budget`, the output rows go in chunks that each gather
    [chunk, dmax, c] (the last chunk ragged). Returns (spmv, rows per
    chunk)."""
    import torch

    n, dmax = idx_np.shape
    idx = torch.as_tensor(idx_np, dtype=torch.int64, device=device)
    w = torch.as_tensor(w_np, device=device)
    if n * dmax * m * 4 <= spmv_bytes_budget:
        def spmv(X):
            return torch.einsum("nd,ndm->nm", w, X[idx])
        return spmv, n

    chunk = max(1024, int(spmv_bytes_budget // (dmax * m * 4) // 1024 * 1024))
    bounds = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]

    def spmv(X):
        out = torch.empty((n, X.shape[1]), dtype=X.dtype, device=X.device)
        for s, e in bounds:
            out[s:e] = torch.einsum("nd,ndm->nm", w[s:e], X[idx[s:e]])
        return out
    return spmv, chunk


def _chefsi_device(
    L, M, k,
    tol=1e-3, degree=40, buffer_frac=0.2, max_iter=30, seed=0,
    refine=True, refine_degree=60, refine_rounds=12, spmv_bytes_budget=2 << 30,
    refine_filter="device", device="cuda", stats=None,
):
    """Chebyshev-filtered subspace iteration (CheFSI) on the device, f32,
    with an f64 filter + Rayleigh-Ritz polish on the host.

    A degree-p Chebyshev polynomial of C = M^-1/2 L M^-1/2, scaled to damp
    [lambda_cut, lambda_max], amplifies the wanted low end of the spectrum;
    iterating filter -> QR -> Rayleigh-Ritz converges the k + buffer lowest
    pairs. Every device operation is a padded-ELL sparse product
    (`ell_spmv`), a tall-skinny QR or a small dense eigh, in full f32 (the
    package turns TF32 off). The f32 iteration stalls near relative
    residual 1e-3 (the filter's dynamic range exceeds f32), so the host
    applies f64 filter + Rayleigh-Ritz rounds to the returned subspace
    until the wanted residuals reach f64 scale.

    refine_filter: where the polish rounds' chained Chebyshev PRE-FILTER
    runs. "device" reuses the f32 device filter between the f64 host
    Rayleigh-Ritz steps (cheap rounds, f32 rounding noise re-injected each
    round, which the f64 Rayleigh-Ritz resolves; at small n the
    per-eigenvalue parity floors near 1e-8 relative); "host" keeps the
    pre-filter in f64 on the host (the conservative all-f64 path).

    stats: a dict to fill with the wall seconds of the device loop and of
    the polish, the rounds of each, and the spmv calls of each.
    Deterministic: the JAX package's start blocks for `seed`
    (utils/jax_random.py, computed on `device`), fixed iteration counts
    given the same inputs.
    """
    import torch

    from ..utils.jax_random import PRNGKey, fold_in, normal

    if refine_filter not in ("device", "host"):
        raise ValueError(f"refine_filter must be 'device' or 'host', got {refine_filter!r}")
    t_start = time.perf_counter()
    d = _as_diag_array(M)
    inv_sqrt = 1.0 / np.sqrt(d)
    n = L.shape[0]
    m = k + max(int(k * buffer_frac), 16)
    if m > n:
        raise ValueError(f"chefsi: subspace of {m} columns for k={k} exceeds n={n}")
    idx_np, w_np = _ell_arrays(L, inv_sqrt)
    spmv_ell, _ = ell_spmv(idx_np, w_np, m, spmv_bytes_budget, device)
    calls = {"spmv": 0}

    def spmv(X):
        calls["spmv"] += 1
        return spmv_ell(X)

    key = PRNGKey(seed)  # the JAX start blocks (eigensolver.py:256-315)
    v = normal(key, (n, 1), device=device)
    for _ in range(50):
        u = spmv(v)
        v = u / torch.linalg.norm(u)
    u = spmv(v)
    lam_max = float((v * u).sum() / (v * v).sum()) * 1.05

    def rayleigh_ritz(Y):
        Q, _ = torch.linalg.qr(Y)
        H = Q.T @ spmv(Q)
        theta, U = torch.linalg.eigh(0.5 * (H + H.T))
        X = Q @ U
        R = spmv(X) - X * theta[None, :]
        return X, theta, torch.linalg.norm(R, dim=0)

    def cheb_filter(X, lam_cut, deg):
        # Scaled three-term recurrence (Zhou et al.): the polynomial is
        # normalized at lambda=0, so wanted components stay O(1) while
        # [lam_cut, lam_max] is damped.
        e = (lam_max - lam_cut) / 2.0
        c = (lam_max + lam_cut) / 2.0
        sigma1 = e / c
        Xm1, Y, sig = X, (spmv(X) - c * X) * (sigma1 / e), sigma1
        for _ in range(deg - 1):
            sig_new = 1.0 / (2.0 / sigma1 - sig)
            Xm1, Y = Y, 2.0 * (sig_new / e) * (spmv(Y) - c * Y) - (sig * sig_new) * Xm1
            sig = sig_new
        # wanted components grow ~exp(deg*2*sqrt(cut/max)) per application,
        # and ill-conditioned operators chain many: keep f32 finite (the
        # subspace is scale-invariant)
        return Y / Y.abs().max()

    def _filter_applications(lam_cut):
        # A degree-p pass amplifies the wanted end by ~exp(p * 2 *
        # sqrt(lam_cut / lam_max)) against the damped band; point-cloud
        # Laplacians reach lam_max / lam_cut ~ 1e4-1e5, where one degree-40
        # pass amplifies by ~2x. Chain applications to reach ~e^4 per
        # iteration.
        per_pass = degree * 2.0 * np.sqrt(max(lam_cut / lam_max, 1e-12))
        return int(np.clip(np.ceil(4.0 / per_pass), 1, 12))

    X = normal(fold_in(key, 1), (n, m), device=device)
    X, theta, res = rayleigh_ritz(X)
    # Exit when the wanted residuals are small RELATIVE TO THE WANTED
    # EIGENVALUES (res / lam_cut; lam_max-relative would let an
    # ill-conditioned operator "converge" on noise). Two non-improving
    # rounds hand off to the f64 host polish (the f32 stall).
    prev = np.inf
    stalled = 0
    rounds = 0
    for _ in range(max_iter):
        rounds += 1
        lam_cut = min(max(float(theta[k]), 1e-6 * lam_max), 0.9 * lam_max)
        Y = X
        for _ in range(_filter_applications(lam_cut)):
            Y = cheb_filter(Y, lam_cut, degree)
        X, theta, res = rayleigh_ritz(Y)
        r = float(res[:k].max())
        if r < tol * lam_cut:
            break
        stalled = stalled + 1 if r > 0.9 * prev else 0
        if stalled >= 2:
            break
        prev = min(prev, r)

    X_host = X.double().cpu().numpy()
    theta_host = theta.double().cpu().numpy()
    t_device = time.perf_counter()
    device_spmv = calls["spmv"]
    polish_rounds = 0
    if refine:
        # f64 polish rounds on the host (filter + Rayleigh-Ritz). The f32
        # subspace can be rank-deficient inside near-degenerate clusters and
        # filtering cannot re-create a lost direction, so the start is
        # re-seeded with small noise; rounds repeat until the wanted
        # residuals reach f64 scale.
        C = (sparse.diags(inv_sqrt) @ L @ sparse.diags(inv_sqrt)).tocsr()
        rng = np.random.RandomState(seed + 1)
        X_host = X_host + 1e-5 * rng.standard_normal(X_host.shape)
        lam_cut = min(max(float(theta_host[k]), 1e-6 * lam_max), 0.9 * lam_max)

        def cheb_f64(Xh, cut, deg):
            e = (lam_max - cut) / 2.0
            c = (lam_max + cut) / 2.0
            sig = sig1 = e / c
            Y = (C @ Xh - c * Xh) * (sig1 / e)
            Xm1 = Xh
            for _ in range(deg - 1):
                sig_new = 1.0 / (2.0 / sig1 - sig)
                Y, Xm1 = 2.0 * (sig_new / e) * (C @ Y - c * Y) - (sig * sig_new) * Xm1, Y
                sig = sig_new
            return Y

        from scipy.linalg import solve_triangular

        def chol_qr2(X):
            """CholeskyQR2: two rounds of Q = X chol(X^T X)^-T, all BLAS-3;
            Householder-grade orthogonality in f64 while cond(X) << 1e8 (the
            filtered iterates are normalized). np.linalg.qr if the Gram
            factorization fails."""
            for _ in range(2):
                G = X.T @ X
                try:
                    R = np.linalg.cholesky(G)
                except np.linalg.LinAlgError:
                    return np.linalg.qr(X)[0]
                X = np.ascontiguousarray(solve_triangular(R, X.T, lower=True).T)
            return X

        evals = None
        prev_r = np.inf
        stalls = 0
        for _ in range(refine_rounds):
            polish_rounds += 1
            # the device loop's conditioning-adaptive chaining, at a higher
            # amplification target (e^8 per round): a host round's fixed cost
            # (CholQR2 and two [n,m]x[m,m] products) dominates its matvecs
            per_pass = refine_degree * 2.0 * np.sqrt(max(lam_cut / lam_max, 1e-12))
            passes = int(np.clip(np.ceil(8.0 / per_pass), 1, 12))
            if refine_filter == "device":
                Xf = torch.as_tensor(X_host, dtype=torch.float32, device=device)
                cut32 = float(np.float32(lam_cut))
                for _ in range(passes):
                    Xf = cheb_filter(Xf, cut32, refine_degree)
                Xf = Xf.double().cpu().numpy()
            else:
                Xf = X_host
                for _ in range(passes):
                    Xf = cheb_f64(Xf, lam_cut, refine_degree)
                    Xf = Xf / np.abs(Xf).max()
            Q = chol_qr2(Xf)
            H = Q.T @ (C @ Q)
            theta_h, U = np.linalg.eigh(0.5 * (H + H.T))
            X_host = Q @ U
            evals = theta_h[:k]
            R = C @ X_host[:, :k] - X_host[:, :k] * evals[None, :]
            # wanted-scale relative target, as in the device loop; stop once
            # rounds stop buying anything
            r = np.linalg.norm(R, axis=0).max()
            if r < 1e-8 * max(np.abs(evals).max(), 1e-12 * lam_max):
                break
            # Refresh the Chebyshev window from the current Ritz values
            # BEFORE judging a stall (a round filtered with the f32 loop's
            # lam_cut can contract < 10%); two strikes end the polish.
            lam_cut = min(max(float(theta_h[k]), 1e-6 * lam_max), 0.9 * lam_max)
            if r > 0.9 * prev_r:
                stalls += 1
                if stalls >= 2:
                    break
            else:
                stalls = 0
            prev_r = min(prev_r, r)
    else:
        evals = theta_host[:k]

    if stats is not None:
        stats.update(device_s=t_device - t_start, polish_s=time.perf_counter() - t_device,
                     device_rounds=rounds, polish_rounds=polish_rounds, n=n, m=m,
                     dmax=int(idx_np.shape[1]), device_spmv_calls=device_spmv,
                     polish_spmv_calls=calls["spmv"] - device_spmv, lam_max=lam_max)
    phi = X_host[:, :k] * inv_sqrt[:, None]
    return evals, phi


def solve_generalized_eigenproblem(L, M, k, method="shift_invert", device="cuda", **kwargs):
    """k smallest eigenpairs of L phi = lambda M phi, M-orthonormal phi.
    `device` is where the device methods (dense, lobpcg, chefsi) run;
    shift_invert is host scipy and ignores it."""
    if method == "shift_invert":
        return shift_invert_eigenpairs(L, M, k)
    if method not in METHODS:
        raise ValueError(f"Unknown eigensolver method: {method}")
    from .. import resolve_device

    device = resolve_device(device)
    if method == "dense":
        return _dense_device(L, M, k, device=device)
    if method == "lobpcg":
        return _lobpcg_device(L, M, k, device=device, **kwargs)
    return _chefsi_device(L, M, k, device=device, **kwargs)


def compute_first_k_eigenfunctions(mesh, k, laplacian_type="cotan", skip_first_efunc=True,
                                   return_evalues=False, method="shift_invert",
                                   device="cuda"):
    """First k LBO eigenfunctions of a mesh. Solves for k+1 pairs and drops
    the constant first eigenfunction by default."""
    from ..geometry.laplacian import build_laplacian

    L, M = build_laplacian(mesh, laplacian_type)
    evals, efuncs = solve_generalized_eigenproblem(L, M, k + 1, method=method, device=device)
    # "standard" rescaling divides by max-min: a constant column is fatal.
    if np.any(np.max(efuncs, axis=0) == np.min(efuncs, axis=0)):
        raise ValueError("degenerate (constant) eigenfunction column")
    if skip_first_efunc:
        efuncs, evals = efuncs[:, 1:], evals[1:]
    else:
        efuncs, evals = efuncs[:, :-1], evals[:-1]
    if return_evalues:
        return efuncs, evals
    return efuncs


class EigenfuncsProcessor:
    """Offline eigenfunction preprocessing (reference mesh.py:573-587): the
    first k eigenfunctions (f32 [V, k]) and eigenvalues (f32 [k]) of a mesh
    or point-cloud file's Laplacian (cotan, robust or pc_vert_robust) by
    one of METHODS (the device ones on `device`)."""

    def __init__(self, path_to_mesh, k, laplacian_type="cotan", skip_first_efunc=True,
                 method="shift_invert", device="cuda"):
        from ..geometry.mesh import load_mesh

        if method not in METHODS:
            raise ValueError(f"Unknown eigensolver method: {method}")
        self.mesh = load_mesh(path_to_mesh)
        self.k = k
        self.laplacian_type = laplacian_type
        efuncs, evalues = compute_first_k_eigenfunctions(
            self.mesh, self.k, laplacian_type, skip_first_efunc=skip_first_efunc,
            return_evalues=True, method=method, device=device)
        self.E = efuncs.astype(np.float32)
        self.evalues = evalues.astype(np.float32)

    def get_eigenfunctions(self):
        return self.E

    def get_eigenvalues(self):
        return self.evalues
