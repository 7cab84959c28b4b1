"""The port's eigensolvers against the JAX package and the shift-invert
oracle, on the CPU (device="cpu": the same torch code the card runs).

Random starts differ from JAX's PRNG, so parity is on the converged
eigenpairs (eigenvalues, principal angles, M-orthonormality), never on
iterates. Gates:
  - dense: rtol 1e-6 / atol 1e-8 against the JAX package's dense path (the
    host LAPACK route at these sizes, equal arithmetic);
  - lobpcg: rtol 1e-3 / atol 1e-4 against shift_invert
    (tests/test_spectral.py's gate, met in f32 by torch.lobpcg's "basic"
    method: measured 4.7e-5 at seed 0);
  - chefsi: tests/test_spectral.py:182-256's gates, case by case;
  - _ell_arrays: equal; the ELL product within f32 rounding of scipy's.
"""
import numpy as np
import pytest
import scipy.sparse as sparse
import torch

from intrinsic_neural_fields_tpu.geometry.laplacian import build_laplacian as jax_build_laplacian
from intrinsic_neural_fields_tpu.geometry.mesh import Mesh as JaxMesh
from intrinsic_neural_fields_tpu.spectral import eigensolver as jeig

from intrinsic_neural_fields_tpu_torch.geometry.laplacian import build_laplacian, robust_laplacian
from intrinsic_neural_fields_tpu_torch.geometry.pointcloud import local_triangulation
from intrinsic_neural_fields_tpu_torch.geometry.primitives import icosphere
from intrinsic_neural_fields_tpu_torch.spectral import eigensolver as peig

torch.set_num_threads(2)
solve = peig.solve_generalized_eigenproblem


def _operators(sub):
    return build_laplacian(icosphere(sub), "cotan")


def _angles_deg(phi_h, phi_d, Md):
    s = np.linalg.svd((phi_h * Md[:, None]).T @ phi_d, compute_uv=False)
    return np.degrees(np.arccos(np.clip(s, 0.0, 1.0)))


def _orth(phi, Md):
    return np.abs((phi * Md[:, None]).T @ phi - np.eye(phi.shape[1])).max()


def test_dense_matches_jax():
    L, M = _operators(2)
    ev, phi = solve(L, M, 10, method="dense", device="cpu")
    jev, jphi = jeig.solve_generalized_eigenproblem(L, M, 10, method="dense")
    np.testing.assert_allclose(ev, jev, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.abs(phi), np.abs(jphi), rtol=1e-6, atol=1e-8)
    ev_si, _ = solve(L, M, 10)
    np.testing.assert_allclose(ev, ev_si, rtol=1e-6, atol=1e-8)
    assert _orth(phi, M.diagonal()) < 1e-6


def test_dense_device_window_runs_f32_eigh(monkeypatch):
    """Inside the window the f32 torch eigh runs (the window moved down to
    this small operator to keep the test fast): eigenvalues to f32 accuracy
    of the largest, M-orthonormal to f32 rounding."""
    L, M = _operators(2)
    calls = []
    eigh = torch.linalg.eigh

    def spy(A):
        calls.append(A.dtype)
        return eigh(A)
    monkeypatch.setattr(peig, "DENSE_DEVICE_WINDOW", (100, 200))
    monkeypatch.setattr(torch.linalg, "eigh", spy)
    ev, phi = solve(L, M, 10, method="dense", device="cpu")
    assert calls == [torch.float32]
    ev_si, _ = solve(L, M, 10)
    assert np.abs(ev - ev_si).max() < 1e-5 * np.abs(ev_si).max() + 1e-5
    assert _orth(phi, M.diagonal()) < 1e-5


def test_lobpcg_matches_shift_invert():
    L, M = _operators(2)
    ev_si, phi_si = solve(L, M, 10)
    ev, phi = solve(L, M, 10, method="lobpcg", tol=1e-7, device="cpu")
    np.testing.assert_allclose(ev, ev_si, rtol=1e-3, atol=1e-4)
    assert _orth(phi, M.diagonal()) < 1e-4
    # the smallest non-degenerate pair spans the same function
    assert _angles_deg(phi_si[:, :1], phi[:, :1], M.diagonal()).max() < 1.0


def test_chefsi_chunked_spmv_matches():
    """A budget of 4 KB forces the ELL product into three row chunks (1024,
    1024 and a ragged 514 of icosphere(4)'s 2,562 rows): the spectrum of the
    unchunked solve to 1e-8, M-orthonormal to 1e-10."""
    L, M = _operators(4)
    k = 16
    ev_h, _ = solve(L, M, k)
    idx, w = peig._ell_arrays(L, 1.0 / np.sqrt(M.diagonal()))
    _, chunk = peig.ell_spmv(idx, w, k + 16, 1 << 12, "cpu")
    assert chunk == 1024 and L.shape[0] % chunk and L.shape[0] // chunk == 2
    stats = {}
    ev_c, phi_c = solve(L, M, k, method="chefsi", spmv_bytes_budget=1 << 12,
                        refine_filter="host", device="cpu", stats=stats)
    np.testing.assert_allclose(ev_c, ev_h, rtol=1e-8, atol=1e-8)
    assert _orth(phi_c, M.diagonal()) < 1e-10
    assert stats["device_spmv_calls"] > 50 and stats["polish_spmv_calls"] == 0
    assert stats["device_s"] > 0 and stats["polish_s"] > 0


def test_chefsi_device_filtered_polish():
    L, M = _operators(4)
    k = 64
    ev_h, phi_h = solve(L, M, k)
    stats = {}
    ev_d, phi_d = solve(L, M, k, method="chefsi", refine_filter="device", device="cpu",
                        stats=stats)
    assert np.abs(ev_d - ev_h).max() / np.abs(ev_h).max() < 1e-4
    Md = M.diagonal()
    assert _angles_deg(phi_h, phi_d, Md).max() < 1.0
    assert _orth(phi_d, Md) < 1e-10
    assert stats["polish_spmv_calls"] > 0


def test_chefsi_on_irregular_point_cloud():
    """An ill-conditioned point-cloud operator (lam_max / lam_cut ~ 1e4):
    the chained filter and wanted-scale criteria hold the JAX gates."""
    rng = np.random.default_rng(0)
    m = icosphere(4)
    tri = m.vertices[m.faces]
    fidx = rng.integers(0, len(m.faces), size=2000)
    r1, r2 = rng.random(2000), rng.random(2000)
    s = np.sqrt(r1)
    w = np.stack([1.0 - s, s * (1.0 - r2), s * r2], axis=-1)
    pts = np.einsum("nk,nkd->nd", w, tri[fidx])
    L, M = robust_laplacian(pts, local_triangulation(pts, n_neighbors=12))
    k = 16
    ev_h, phi_h = solve(L, M, k)
    ev_d, phi_d = solve(L, M, k, method="chefsi", device="cpu")
    assert np.abs(ev_d - ev_h).max() / np.abs(ev_h).max() < 1e-4
    assert _angles_deg(phi_h, phi_d, M.diagonal()).max() < 0.5


@pytest.mark.slow
def test_chefsi_at_preprocessing_scale():
    """k=529 (shell-aligned) on icosphere(4) with the all-f64 polish:
    eigenvalues to 1e-8, the span within 0.1 degree, M-orthonormal."""
    L, M = _operators(4)
    k = 529
    ev_h, phi_h = solve(L, M, k)
    ev_d, phi_d = solve(L, M, k, method="chefsi", refine_filter="host", device="cpu")
    np.testing.assert_allclose(ev_d, ev_h, rtol=1e-8, atol=1e-8)
    Md = M.diagonal()
    assert _angles_deg(phi_h, phi_d, Md).max() < 0.1
    assert _orth(phi_d, Md) < 1e-10


def test_ell_arrays_and_product_match():
    L, M = jax_build_laplacian(JaxMesh(icosphere(3).vertices, icosphere(3).faces), "cotan")
    inv_sqrt = 1.0 / np.sqrt(M.diagonal())
    idx, w = peig._ell_arrays(L, inv_sqrt)
    jidx, jw = jeig._ell_arrays(L, inv_sqrt)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w, jw)
    C = (sparse.diags(inv_sqrt) @ L @ sparse.diags(inv_sqrt)).tocsr()
    X = np.random.default_rng(0).standard_normal((L.shape[0], 24)).astype(np.float32)
    want = C @ X.astype(np.float64)
    for budget in (2 << 30, 1 << 12):
        spmv, _ = peig.ell_spmv(idx, w, 24, budget, "cpu")
        got = spmv(torch.from_numpy(X)).numpy()
        assert np.abs(got - want).max() < 1e-5 * np.abs(C).max() * np.abs(X).max() * 8


def test_methods_and_devices_are_checked(monkeypatch):
    """An unknown method raises like the JAX package's; the device methods
    resolve their device first, so device="cuda" without a card raises
    (the card is hidden here); shift_invert is host scipy and ignores it."""
    L, M = _operators(1)
    with pytest.raises(ValueError, match="Unknown eigensolver method"):
        solve(L, M, 4, method="arpack")
    with pytest.raises(ValueError, match="Unknown eigensolver method"):
        peig.EigenfuncsProcessor("unused.obj", 4, method="arpack")
    with pytest.raises(ValueError, match="refine_filter"):
        solve(L, M, 4, method="chefsi", refine_filter="gpu", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in ("dense", "lobpcg", "chefsi"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            solve(L, M, 4, method=method)
    ev, _ = solve(L, M, 4, device="cuda")
    np.testing.assert_allclose(ev, jeig.solve_generalized_eigenproblem(L, M, 4)[0], rtol=1e-12)


@pytest.mark.parametrize("lap", ["robust", "pc_vert_robust"])
def test_compute_first_k_eigenfunctions_matches_jax(lap):
    """The robust and point-cloud operators' skip-first basis through the
    shift-invert default, to the JAX package's (1e-8 eigenvalues, 1e-6
    functions up to sign), and through chefsi on the CPU to the oracle."""
    m = icosphere(3)
    ef, ev = peig.compute_first_k_eigenfunctions(m, 12, lap, return_evalues=True)
    jef, jev = jeig.compute_first_k_eigenfunctions(JaxMesh(m.vertices, m.faces), 12, lap,
                                                   return_evalues=True)
    np.testing.assert_allclose(ev, jev, rtol=1e-8)
    sign = np.sign(np.sum(ef * jef, axis=0))
    np.testing.assert_allclose(ef * sign, jef, atol=1e-6)
    _, ev_c = peig.compute_first_k_eigenfunctions(m, 12, lap, return_evalues=True,
                                                  method="chefsi", device="cpu")
    assert np.abs(ev_c - jev).max() < 1e-4 * np.abs(jev).max()
