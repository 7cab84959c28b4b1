"""Intrinsic Delaunay triangulation by edge flipping (host-side; a copy of
the JAX package's geometry/intrinsic_delaunay.py whose native backend is
the port's build of native/idt.cpp and never falls back to Python).

The robust Laplacian of Sharp & Crane ("A Laplacian for Nonmanifold Triangle
Meshes", SGP 2020) combines intrinsic mollification with the cotan operator of
the INTRINSIC DELAUNAY triangulation: edges whose cotan weight would be
negative are flipped purely metrically (connectivity + lengths, no vertex
movement) until every interior edge satisfies the Delaunay condition. The
resulting operator is an M-matrix (non-positive off-diagonals), which the raw
cotan Laplacian of a bad triangulation is not.

This module implements the flip algorithm on a halfedge structure driven by
edge LENGTHS only, plus `build_double_cover`, the tufted double cover that
manifoldizes arbitrary soups: after the cover, EVERY edge has exactly two
incident halfedges and is flippable, so boundary and nonmanifold inputs
(e.g. point-cloud local triangulations) get the full algorithm, not just its
manifold-interior part. Within the flip driver itself, edges that still are
not manifold (possible only without the cover) are left unflipped. The
greedy twin pairing picks one valid gluing of the cover; Sharp & Crane's
ordering around a nonmanifold edge can differ, which may change individual
flips but not the resulting operator's M-matrix property.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def _corner_cot(a, b, c):
    """cot of the angle opposite side a, triangle with sides (a, b, c)."""
    b2, c2 = b * b, c * c
    a2 = a * a
    # 4*Area via Kahan-stable Heron
    s = sorted((a, b, c), reverse=True)
    x, y, z = s
    area4sq = (x + (y + z)) * (z - (x - y)) * (z + (x - y)) * (x + (y - z))
    area4 = np.sqrt(max(area4sq, 1e-300))
    return (b2 + c2 - a2) / area4


def intrinsic_delaunay(faces, lengths, max_flips=None, backend="native"):
    """Flip to the intrinsic Delaunay triangulation.

    Args:
      faces: [F,3] int vertex ids.
      lengths: [F,3] float edge lengths, lengths[f,i] = |edge OPPOSITE corner i|
        (i.e. edge (i+1, i+2) of face f), e.g. from laplacian._edge_lengths
        after mollification.
      backend: "native" (default) runs the C++ core (native/idt.cpp, built
        at first use; raises when it cannot be built), "python" this
        implementation. Both produce the same triangulation.
    Returns (faces_new [F,3], lengths_new [F,3], n_flips).
    """
    if backend == "native":
        return _intrinsic_delaunay_native(faces, lengths, max_flips)
    if backend != "python":
        raise ValueError(f"unknown iDT backend {backend!r} (native, python)")
    F = faces.shape[0]
    H = 3 * F
    # halfedge h in face f=h//3, corner slot s=h%3: runs from vertex
    # faces[f, s] to faces[f, (s+1)%3]; its length is lengths[f, (s+2)%3]
    # (the edge opposite corner (s+2)).
    src = np.empty(H, dtype=np.int64)
    dst = np.empty(H, dtype=np.int64)
    elen = np.empty(H, dtype=np.float64)
    for s in range(3):
        src[s::3] = faces[:, s]
        dst[s::3] = faces[:, (s + 1) % 3]
        elen[s::3] = lengths[:, (s + 2) % 3]

    nxt = np.arange(H, dtype=np.int64)
    nxt = (nxt // 3) * 3 + (nxt % 3 + 1) % 3

    # Twin pairing: greedy matching of opposite-direction halfedges per
    # undirected edge (in index order). For a manifold mesh this is the usual
    # pairing; for a double cover it pairs original-with-original and
    # duplicate-with-duplicate on interior edges and original-with-duplicate
    # on boundary edges — the tufted gluing. Unbalanced leftovers stay -1.
    twin = np.full(H, -1, dtype=np.int64)
    by_edge = {}
    for h in range(H):
        key = (min(src[h], dst[h]), max(src[h], dst[h]))
        by_edge.setdefault(key, []).append(h)
    for (lo, hi), hs in by_edge.items():
        fwd = [h for h in hs if src[h] == lo]
        bwd = [h for h in hs if src[h] == hi]
        for a, b in zip(fwd, bwd):
            twin[a], twin[b] = b, a

    def is_delaunay(h, eps=1e-12):
        t = twin[h]
        if t < 0:
            return True
        a1, b1 = nxt[h], nxt[nxt[h]]
        a2, b2 = nxt[t], nxt[nxt[t]]
        cot1 = _corner_cot(elen[h], elen[a1], elen[b1])
        cot2 = _corner_cot(elen[t], elen[a2], elen[b2])
        return cot1 + cot2 >= -eps

    def flipped_length(h):
        """Length of the new diagonal after flipping edge h (lay both
        triangles flat across the shared edge)."""
        t = twin[h]
        a1, b1 = nxt[h], nxt[nxt[h]]      # h: u->v, a1: v->w1, b1: w1->u
        a2, b2 = nxt[t], nxt[nxt[t]]      # t: v->u, a2: u->w2, b2: w2->u? (w2->v)
        l_uv = elen[h]
        l_vw1, l_w1u = elen[a1], elen[b1]
        l_uw2, l_w2v = elen[a2], elen[b2]
        # place u=(0,0), v=(l_uv,0); w1 above, w2 below
        x1 = (l_uv * l_uv + l_w1u * l_w1u - l_vw1 * l_vw1) / (2.0 * l_uv)
        y1 = np.sqrt(max(l_w1u * l_w1u - x1 * x1, 0.0))
        x2 = (l_uv * l_uv + l_uw2 * l_uw2 - l_w2v * l_w2v) / (2.0 * l_uv)
        y2 = -np.sqrt(max(l_uw2 * l_uw2 - x2 * x2, 0.0))
        return float(np.hypot(x1 - x2, y1 - y2))

    def flip(h):
        """Flip edge h. Standard halfedge flip, lengths updated intrinsically."""
        t = twin[h]
        a1, b1 = nxt[h], nxt[nxt[h]]
        a2, b2 = nxt[t], nxt[nxt[t]]
        u, v = src[h], dst[h]
        w1, w2 = dst[a1], dst[a2]

        new_len = flipped_length(h)

        # h becomes w2->w1 in face (w2, w1, u); t becomes w1->w2 in (w1, w2, v)
        src[h], dst[h] = w2, w1
        src[t], dst[t] = w1, w2
        elen[h] = elen[t] = new_len

        # rewire next pointers: f1' = h -> b1 -> a2 ; f2' = t -> b2 -> a1
        nxt[h], nxt[b1], nxt[a2] = b1, a2, h
        nxt[t], nxt[b2], nxt[a1] = b2, a1, t
        return (a1, b1, a2, b2)

    queue = deque(h for h in range(H) if twin[h] >= 0 and h < twin[h])
    in_queue = np.zeros(H, dtype=bool)
    for h in queue:
        in_queue[h] = True
    flips = 0
    limit = max_flips if max_flips is not None else 100 * H

    while queue and flips < limit:
        h = queue.popleft()
        in_queue[h] = False
        if twin[h] < 0 or is_delaunay(h):
            continue
        neighbors = flip(h)
        flips += 1
        for nb in neighbors:
            e = min(nb, twin[nb]) if twin[nb] >= 0 else nb
            if twin[e] >= 0 and not in_queue[e]:
                queue.append(e)
                in_queue[e] = True

    # Recover faces + per-face lengths from the halfedge cycles.
    faces_new = np.empty_like(faces)
    lengths_new = np.empty_like(lengths)
    visited = np.zeros(H, dtype=bool)
    f = 0
    for h in range(H):
        if visited[h]:
            continue
        h1, h2 = nxt[h], nxt[nxt[h]]
        assert nxt[h2] == h, "halfedge cycles must have length 3"
        visited[h] = visited[h1] = visited[h2] = True
        faces_new[f] = (src[h], src[h1], src[h2])
        # lengths[f, i] = edge opposite corner i = edge (i+1, i+2):
        # corner 0 = src[h]; opposite edge is h1 (src[h1]->src[h2]) etc.
        lengths_new[f] = (elen[h1], elen[h2], elen[h])
        f += 1
    assert f == F
    return faces_new, lengths_new, flips


def _intrinsic_delaunay_native(faces, lengths, max_flips=None):
    """C++ flip core (ctypes)."""
    import ctypes

    from ..native import load_idt

    lib = load_idt()
    faces_c = np.ascontiguousarray(faces, dtype=np.int64)
    lengths_c = np.ascontiguousarray(lengths, dtype=np.float64)
    F = faces_c.shape[0]
    faces_out = np.empty_like(faces_c)
    lengths_out = np.empty_like(lengths_c)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    flips = lib.idt_flip(
        F,
        p(faces_c, ctypes.c_int64),
        p(lengths_c, ctypes.c_double),
        p(faces_out, ctypes.c_int64),
        p(lengths_out, ctypes.c_double),
        0 if max_flips is None else int(max_flips),
    )
    if flips < 0:
        raise RuntimeError("native iDT reported a broken halfedge structure")
    return faces_out.astype(faces.dtype), lengths_out.astype(lengths.dtype), int(flips)


def build_double_cover(faces, lengths):
    """Tufted double cover: every face duplicated with reversed orientation.

    The greedy twin pairing then glues original-with-original on interior
    edges and original-with-duplicate along boundary/nonmanifold edges,
    producing a CLOSED surface in which every edge is flippable — boundary
    and nonmanifold Delaunay violations become fixable (Sharp & Crane 2020).
    Operators assembled over the cover are exactly twice the intended ones.
    """
    faces = np.asarray(faces)
    lengths = np.asarray(lengths)
    faces_rev = faces[:, [0, 2, 1]]
    # lengths[f,i] is the edge opposite corner i; reversing (a,b,c)->(a,c,b)
    # keeps the edge opposite corner 0 and swaps the other two.
    lengths_rev = lengths[:, [0, 2, 1]]
    return (
        np.concatenate([faces, faces_rev], axis=0),
        np.concatenate([lengths, lengths_rev], axis=0),
    )
