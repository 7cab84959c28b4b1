"""SHOT descriptors (Signature of Histograms of OrienTations) per vertex
(host numpy; a copy of the JAX package's geometry/shot.py).

The reference's shape-descriptor experiments train the texture field on a
precomputed per-vertex SHOT matrix loaded through the `eigenfunctions_path`
config field with k=352 (reference configs/shape_descriptors/cat_shot.yaml;
352 = SHOT's canonical 32 spatial sectors x 11 cosine bins). The reference
repo never computes SHOT — its download_data.sh fetches a precomputed
`shape_descriptors.zip`. This module computes the descriptor from scratch
(Tombari, Salti, Di Stefano, ECCV 2010, following PCL's interpolation
scheme), so the experiment family is runnable without any download:

  E = compute_shot_descriptors(vertices, faces, radius=...)   # [V, 352] f32
  np.save("..._shot.npy", E)  ->  data.eigenfunctions_path

or `python -m intrinsic_neural_fields_tpu_torch.compute_shot out.npy mesh`.

Algorithm per vertex p with support radius r:
  1. local reference frame (LRF): eigenvectors of the (r - d)-weighted
     neighbor covariance; x = largest-eigenvalue axis, z = smallest; signs
     disambiguated to agree with the majority of neighbor offsets
     (Tombari et al. section 3; ambiguous ties resolved as in PCL).
  2. the spherical support splits into 32 volumes: 8 azimuth x 2 elevation
     x 2 radial sectors in LRF coordinates.
  3. each neighbor q contributes to an 11-bin histogram of
     cos(theta) = n_q . z_p inside its volume, with LINEAR soft-binning
     along all four dimensions (cosine bin, azimuth, elevation, radial) —
     PCL's "quadrilinear" interpolation: per dimension the unit weight
     splits (1-|off|, |off|) between the two nearest bins; azimuth wraps,
     the bounded dimensions clamp — beyond the first/last bin center the
     edge bin takes the full unit weight (see _split).
  4. the concatenated 352-vector is L2-normalized.

Everything is vectorized numpy over the flattened (vertex, neighbor) pair
list (cKDTree ball queries); host-side like the rest of offline
preprocessing (eigenfunctions, baking) per SURVEY section 7.1.
"""
from __future__ import annotations

import numpy as np

N_AZIMUTH = 8
N_ELEVATION = 2
N_RADIAL = 2
N_COS_BINS = 11
SHOT_DIM = N_AZIMUTH * N_ELEVATION * N_RADIAL * N_COS_BINS  # 352


def vertex_normals(vertices, faces):
    """Area-weighted vertex normals (orientation from face winding)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    out = np.zeros_like(v)
    for c in range(3):
        np.add.at(out, f[:, c], fn)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    out /= np.maximum(norm, 1e-20)
    return out


def _neighbor_pairs(vertices, radius):
    """(center_idx, neighbor_idx) int arrays for all pairs within `radius`,
    self-pairs excluded."""
    from scipy.spatial import cKDTree

    tree = cKDTree(vertices)
    pairs = tree.query_pairs(radius, output_type="ndarray")  # i < j, no self
    ci = np.concatenate([pairs[:, 0], pairs[:, 1]])
    ni = np.concatenate([pairs[:, 1], pairs[:, 0]])
    return ci, ni


def _local_reference_frames(vertices, ci, ni, radius, min_neighbors,
                            d_vec=None, dist=None):
    """[V, 3, 3] LRF rows (x, y, z axes) per vertex; invalid-mask [V].

    Covariance weighted by (radius - d) over the support (the paper's eq. 3);
    axes are covariance eigenvectors with x = largest / z = smallest
    eigenvalue, each sign-flipped to agree with the majority of the
    neighbor offsets it projects (x over all neighbors, z likewise);
    y = z cross x. d_vec/dist may be passed in to share the O(pairs)
    geometry arrays with the caller's binning stage.
    """
    n = len(vertices)
    if d_vec is None:
        d_vec = vertices[ni] - vertices[ci]                    # [P, 3]
        dist = np.linalg.norm(d_vec, axis=1)
    w = np.maximum(radius - dist, 0.0)                         # [P]

    # np.bincount for every per-vertex reduction: ~10x np.add.at at the
    # reference's pair counts (12.6M pairs at cat scale)
    wsum = np.bincount(ci, weights=w, minlength=n)
    cov = np.zeros((n, 3, 3))
    wd = d_vec * w[:, None]
    for a in range(3):
        for b in range(a, 3):
            acc = np.bincount(ci, weights=wd[:, a] * d_vec[:, b], minlength=n)
            cov[:, a, b] = acc
            cov[:, b, a] = acc
    counts = np.bincount(ci, minlength=n)
    invalid = (counts < min_neighbors) | (wsum <= 0)
    cov[~invalid] /= wsum[~invalid, None, None]
    cov[invalid] = np.eye(3)

    evals, evecs = np.linalg.eigh(cov)          # ascending eigenvalues
    x_ax = evecs[:, :, 2]                        # largest
    z_ax = evecs[:, :, 0]                        # smallest

    # sign disambiguation: majority vote of neighbor-offset projections.
    # Symmetric neighbor rings tie the count vote EXACTLY for ~40% of
    # vertices on regular meshes, which would leave the sign to eigh's
    # arbitrary (rotation-dependent) choice and break the descriptor's
    # rigid-motion invariance. Ties fall back to the weighted cubic moment
    # sum(w * proj^3) — the continuous analog of the paper's
    # strongest-projections tie-break (rotation-equivariant, dominated by
    # the largest |proj| points).
    def _disambiguate(axis):
        proj = np.einsum("pd,pd->p", d_vec, axis[ci])
        # neighbors lying (numerically) IN the axis' orthogonal plane have a
        # pure-fp-noise projection sign — drop them from the count vote
        # (regular meshes put neighbors exactly on such planes)
        signif = np.abs(proj) > 1e-9 * radius
        vote = np.bincount(
            ci, weights=np.where(signif, np.sign(proj), 0.0), minlength=n
        )
        cubic = np.bincount(ci, weights=w * proj ** 3, minlength=n)
        use = np.where(vote != 0, vote, cubic)
        flip = use < 0
        axis[flip] = -axis[flip]
        return axis

    x_ax = _disambiguate(x_ax)
    z_ax = _disambiguate(z_ax)
    y_ax = np.cross(z_ax, x_ax)
    frames = np.stack([x_ax, y_ax, z_ax], axis=1)  # rows = axes
    return frames, invalid


def compute_shot_descriptors(vertices, faces, radius=None, min_neighbors=5):
    """[V, 352] float32 SHOT descriptors.

    radius: support radius; default 5% of the bounding-box diagonal (a
    common correspondence-benchmark setting — the precomputed matrices the
    reference downloads do not document theirs, so the radius is exposed on
    the CLI). Vertices with fewer than min_neighbors support points get a
    zero descriptor (PCL emits NaN there; zero keeps the field trainable).
    """
    v = np.asarray(vertices, np.float64)
    if radius is None:
        radius = 0.05 * float(np.linalg.norm(v.max(0) - v.min(0)))
    normals = vertex_normals(v, faces)
    ci, ni = _neighbor_pairs(v, radius)
    d_vec = v[ni] - v[ci]
    dist = np.linalg.norm(d_vec, axis=1)
    frames, invalid = _local_reference_frames(
        v, ci, ni, radius, min_neighbors, d_vec=d_vec, dist=dist
    )

    # neighbor offsets in LRF coordinates
    local = np.einsum("pad,pd->pa", frames[ci], d_vec)   # [P, 3] (x, y, z)

    # --- four soft-binned coordinates per pair ---------------------------
    # cosine of the angle between the NEIGHBOR's normal and the center's
    # LRF z axis (the "orientations" SHOT histograms)
    cosine = np.clip(np.einsum("pd,pd->p", normals[ni], frames[ci, 2]), -1.0, 1.0)
    # continuous bin coordinate in [0, n); offset measured from bin center
    cos_pos = (1.0 + cosine) * (N_COS_BINS / 2.0)
    az_pos = (np.arctan2(local[:, 1], local[:, 0]) + np.pi) / (2 * np.pi) * N_AZIMUTH
    # elevation: interpolate on z/d (signed sine of the elevation angle) —
    # bin centers at +-1 (poles), 50/50 split exactly at the equator plane
    el_frac = np.where(dist > 0, local[:, 2] / np.maximum(dist, 1e-20), 0.0)
    el_pos = 1.0 + el_frac * 0.5            # in [0.5, 1.5]: 1.0 = equator
    ra_pos = dist / radius * N_RADIAL        # in [0, 2): shell boundary at r/2

    def _split(pos, nbins, wrap):
        """(lo bin, hi bin, lo weight, hi weight): linear soft-binning of a
        continuous coordinate whose bin CENTERS sit at i + 0.5. Azimuth
        wraps; for the bounded dimensions a sample beyond the first/last
        center gives its FULL weight to the edge bin (the published
        descriptor's behavior at the extremes — dropping the out-of-range
        share would under-weight, e.g., neighbors deep inside the inner
        radial shell or normals aligned with the LRF z axis)."""
        centered = pos - 0.5
        lo = np.floor(centered)
        off = centered - lo               # in [0, 1): distance past lo center
        lo = lo.astype(np.int64)
        hi = lo + 1
        w_lo = 1.0 - off
        w_hi = off
        if wrap:
            lo %= nbins
            hi %= nbins
        else:
            lo_oob = lo < 0
            hi_oob = hi > nbins - 1
            w_hi = np.where(lo_oob, 1.0, w_hi)   # everything to the hi bin
            w_lo = np.where(lo_oob, 0.0, w_lo)
            w_lo = np.where(hi_oob, 1.0, w_lo)   # everything to the lo bin
            w_hi = np.where(hi_oob, 0.0, w_hi)
            lo = np.clip(lo, 0, nbins - 1)
            hi = np.clip(hi, 0, nbins - 1)
        return (lo, hi), (w_lo, w_hi)

    cos_b, cos_w = _split(cos_pos, N_COS_BINS, wrap=False)
    az_b, az_w = _split(az_pos, N_AZIMUTH, wrap=True)
    el_b, el_w = _split(el_pos, N_ELEVATION, wrap=False)
    ra_b, ra_w = _split(ra_pos, N_RADIAL, wrap=False)

    # accumulate the 2^4 quadrilinear contributions: one flat bincount per
    # combination over the full pair list (np.add.at on the 5-D array was
    # ~10x slower at the reference's 12.6M-pair cat scale)
    flat = np.zeros(len(v) * SHOT_DIM)
    for ia in range(2):
        for ie in range(2):
            for ir in range(2):
                for ic in range(2):
                    wq = az_w[ia] * el_w[ie] * ra_w[ir] * cos_w[ic]
                    nz = wq > 0
                    if not nz.any():
                        continue
                    idx = (
                        ((ci[nz] * N_AZIMUTH + az_b[ia][nz]) * N_ELEVATION
                         + el_b[ie][nz]) * N_RADIAL + ra_b[ir][nz]
                    ) * N_COS_BINS + cos_b[ic][nz]
                    flat += np.bincount(idx, weights=wq[nz],
                                        minlength=len(v) * SHOT_DIM)

    flat = flat.reshape(len(v), SHOT_DIM)
    flat[invalid] = 0.0
    norms = np.linalg.norm(flat, axis=1, keepdims=True)
    flat = np.where(norms > 0, flat / np.maximum(norms, 1e-20), 0.0)
    return flat.astype(np.float32)
