"""Functional-map texture transfer: render a field trained on shape A directly
on shape B by expressing A's eigenbasis in B's.

Library equivalent of the reference's four texture_transfer/*.ipynb notebooks
(P2P variant, e.g. texture_transfer_cat_tosca2.ipynb cells 6-7) and of
mesh.py:590-605 (ground-truth variant). Flow: given a point-to-point
correspondence P (target vertex i corresponds to source vertex P[i]), the
functional map over FULL bases (constant eigenfunction included) is

    C = E_tgt^T  M_tgt  Q  E_src,    Q[i, P[i]] = 1

and the transferred features are the first k non-constant columns of
E_tgt @ C, range-rescaled. A trained TextureField consumes them unchanged —
no retraining, just `Renderer(model, target_mesh, mapped_efuncs)`.

Host numpy/scipy code, a copy of the JAX package's transfer/functional_map.py
(:1-149); only `postprocess_eigenfunctions` comes from this package's
spectral/features.py.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sparse


def p2p_matrix(correspondence, n_src, n_tgt):
    """Sparse permutation-like matrix Q [n_tgt, n_src] from a point-to-point
    correspondence array (target vertex i -> source vertex correspondence[i])."""
    correspondence = np.asarray(correspondence).reshape(-1)
    assert correspondence.shape[0] == n_tgt
    rows = np.arange(n_tgt)
    data = np.ones(n_tgt, dtype=np.float32)
    return sparse.csr_matrix((data, (rows, correspondence)), shape=(n_tgt, n_src))


def functional_map_from_p2p(E_tgt_full, M_tgt, Q, E_src_full):
    """C = E_tgt^T M_tgt Q E_src over FULL (constant-including) bases."""
    return E_tgt_full.T @ (M_tgt @ (Q @ E_src_full))


def map_eigenfunctions_p2p(
    E_src_full,
    E_tgt_full,
    M_tgt,
    correspondence,
    k,
    rescale=True,
):
    """Transferred eigenfeatures on the target mesh.

    Args:
      E_src_full / E_tgt_full: [V,*] UNRESCALED bases including the constant
        first eigenfunction (use keep_first_efunc preprocessing).
      M_tgt: target mass matrix (diagonal csr).
      correspondence: [V_tgt] int, target -> source vertex ids.
      k: int (first-k) or index list into the source's non-constant functions.
    Returns float32 [V_tgt, k'] features, range-rescaled like the notebooks.
    """
    Q = p2p_matrix(correspondence, E_src_full.shape[0], E_tgt_full.shape[0])
    C = functional_map_from_p2p(E_tgt_full, M_tgt, Q, E_src_full)
    mapped = E_tgt_full @ C  # V_tgt x k_src_full

    if isinstance(k, list):
        mapped = mapped[:, np.asarray(k) + 1]  # +1: skip the constant column
    else:
        mapped = mapped[:, 1 : k + 1]

    if rescale:
        mapped = mapped / (
            np.max(mapped, axis=0, keepdims=True) - np.min(mapped, axis=0, keepdims=True)
        )
    return mapped.astype(np.float32)


def check_source_basis_matches_trained(
    E_src_full, trained_features, k, rescale_strategy="standard", atol=1e-4
):
    """Fail loudly on the degenerate-shell trap: the supplied full source
    basis must be the EXACT basis the model was trained on (constant column
    spliced in front), not an independent re-solve.

    Why this matters: near-symmetric shapes have degenerate eigenvalue shells
    whose eigenvectors an independent solve rotates arbitrarily (even a lone
    sign flip is the 1-D case). The functional map then aligns the target to
    the WRONG frame and the trained MLP reads rotated features — a silent
    ~15 dB render (the direct-swap control row in RESULTS.md). The cheap
    invariant: identity self-transfer of the supplied basis — i.e. selecting
    the model's k columns (skipping the constant) and rescaling — must
    reproduce the features the model was trained on, bit-near-exactly.

    Args:
      E_src_full: [V, kfull] unrescaled source basis incl. constant column.
      trained_features: [V, k'] the features the model trains/renders with
        (load_first_k_eigenfunctions of the config's eigenfunctions_path).
      k: int or index list, as in the model config (indices into the
        non-constant functions).
      rescale_strategy: the config's data.rescale_strategy; the check only
        makes sense for "standard" (the transfer path itself range-rescales).
    Raises ValueError with the splice recipe on mismatch.
    """
    from ..spectral.features import postprocess_eigenfunctions

    E_src_full = np.asarray(E_src_full)
    trained = np.asarray(trained_features, dtype=np.float32)
    if E_src_full.shape[0] != trained.shape[0]:
        raise ValueError(
            f"--source_efuncs_full has {E_src_full.shape[0]} vertices but the "
            f"trained features have {trained.shape[0]} — wrong source mesh/basis."
        )
    if isinstance(k, list):
        idx = np.asarray(k) + 1  # +1: skip the constant column
    else:
        idx = np.arange(1, int(k) + 1)
    if int(idx.max()) >= E_src_full.shape[1]:
        raise ValueError(
            f"--source_efuncs_full has only {E_src_full.shape[1]} columns but "
            f"the model uses eigenfunction index {int(idx.max()) - 1} "
            "(constant-including index "
            f"{int(idx.max())}) — basis too small."
        )
    ours = postprocess_eigenfunctions(
        E_src_full[:, idx], rescale_strategy=rescale_strategy
    )
    scale = max(float(np.max(np.abs(trained))), 1e-12)
    err = float(np.max(np.abs(ours - trained))) / scale
    if err > atol:
        col = int(np.argmax(np.max(np.abs(ours - trained), axis=0)))
        raise ValueError(
            "--source_efuncs_full is NOT the basis the model was trained on "
            f"(max relative mismatch {err:.3e} at selected column {col}; "
            f"tolerance {atol:g}). An independently re-solved basis rotates "
            "eigenvectors inside degenerate eigenvalue shells (sign flips are "
            "the 1-D case), so the functional map would align the target to a "
            "rotated frame and the render silently degrades. Fix: splice the "
            "TRAINED basis — prepend the constant eigenfunction to the exact "
            "array at the config's data.eigenfunctions_path (like the "
            "reference's texture_transfer_cat_tosca2.ipynb cell 4, or "
            "python -m intrinsic_neural_fields_tpu_torch.make_transfer_targets, "
            "which writes both sides in this "
            "format) instead of re-running the eigensolver."
        )


def get_remapped_efuncs_with_fm_gt(E_source, M_source, E_target, rescale=True):
    """Ground-truth functional map variant (reference mesh.py:590-605):
    C = E_src^T M_src E_tgt; mapped = E_src @ C, range-rescaled. Both inputs
    unrescaled, without the constant eigenfunction."""
    C = E_source.T @ (M_source @ E_target)
    mapped = E_source @ C
    if rescale:
        mapped = mapped / (
            np.max(mapped, axis=0, keepdims=True) - np.min(mapped, axis=0, keepdims=True)
        )
    return mapped.astype(np.float32)
