"""Projective-binning first-hit tracer for pinhole ray bundles, in torch.

A ray through pixel (u, v) can only hit faces whose image-plane projection
covers (u, v). Per view:

  1. project every face into the view (f32 component products), take its
     conservative pixel-space AABB;
  2. emit up to 2x2 (32px tile) entries per face; faces with a vertex at or
     behind the camera plane, or a projected span wider than 2x2 tiles, go
     to an exact OVERFLOW segment instead, so nothing is ever dropped;
  3. sort entries by (tile Morton id, quantized camera-space depth) with ONE
     stable sort (``sort_method``: ``torch.sort``, a counting radix sort, a
     bitonic network in plain torch, or the bitonic CUDA kernel — the same
     permutation, so the same tables and hits), so a tile's candidates are
     a contiguous front-to-back slice;
  4. each 1024-ray packet walks its own tile span in depth order, chunk by
     chunk, skipping chunks whose depth bound cannot beat the packet's
     frontier, then the depth-sorted overflow segment with an exact early
     exit.

Step 4 runs every packet in LOCKSTEP over the chunk index instead of one
data-dependent loop per packet: packets are sorted by span length once per
view (one host sync fetches the spans and the overflow chunk count), and at
step k only the prefix of packets whose span exceeds k is computed. A chunk
a packet skips is masked, not dropped, so the visit order and the strict
``t < best`` update — hence the answers, ties included — are the
reference's (a chunk skipped there has a depth bound >= the frontier and
cannot improve any ray).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import launches
from .intersect import B_EPS, T_EPS, Hits, precompute_face_data
from .ray_gen import ray_origins_and_directions
from .sort import bitonic_argsort, bitonic_argsort_vmem, stable_radix_argsort

_Z_BITS = 14                 # depth-quantization bits inside the sort key
_ZQ_MAX = (1 << _Z_BITS) - 1
_Z_NEAR = 1e-6               # camera-plane epsilon: nearer/behind -> overflow
TILE_PX = 32                 # binning tile edge, pixels
RAY_TILE = 1024              # rays per packet
CHUNK = 256                  # entries tested per chunk step
# Packets per lockstep group. It bounds memory: each chunk step holds a few
# [group, RAY_TILE, CHUNK] f32 intermediates (128 MB each at 128 packets);
# fewer, larger groups mean fewer host-issued steps.
PACKET_GROUP = 128


def _interleave2(x, y):
    """Morton-interleave two int32 tensors (16 significant bits each)."""

    def spread(v):
        v = v & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(x) | (spread(y) << 1)


def _morton2_host(x, y):
    out = 0
    for b in range(16):
        out |= ((x >> b) & 1) << (2 * b) | ((y >> b) & 1) << (2 * b + 1)
    return out


def check_pinhole_K(K):
    """The binning projection assumes K[1,0] == 0 and K[2] == [0, 0, 1]
    (column skew K[0,1] is handled); anything else would silently mis-bin."""
    Ka = np.asarray(K, dtype=np.float64)[:3, :3]
    if Ka[1, 0] != 0.0 or not np.allclose(Ka[2], (0.0, 0.0, 1.0)):
        raise ValueError(
            "intersect_coords_pinhole assumes pinhole intrinsics with "
            "K[1,0] == 0 and K[2] == [0, 0, 1]; got "
            f"K[1,0]={Ka[1, 0]!r}, K[2]={Ka[2]!r}"
        )


def argsort_keys(keys, total_bits, method):
    """Stable ascending sort of int32 keys < 2^total_bits: (sorted keys
    int32 [E], order int64 [E])."""
    if method == "radix":
        order = stable_radix_argsort(keys, total_bits)
    elif method == "bitonic":
        order = bitonic_argsort(keys, total_bits)
    elif method == "bitonic_vmem":
        order = bitonic_argsort_vmem(keys, total_bits)
    elif method == "argsort":
        return torch.sort(keys, stable=True)
    else:
        raise ValueError(f"unknown sort_method {method!r}: expected "
                         "'argsort', 'radix', 'bitonic', or 'bitonic_vmem'")
    order = order.long()
    return keys[order], order


class BinTables(NamedTuple):
    """Per-view binning tables."""

    ed_t: torch.Tensor      # [12, Etot] transposed entry hit data:
                            #   rows 0:3 n, 3:6 a, 6:9 b, 9 tnum, 10 oa, 11 ob
    ed_rows: torch.Tensor   # [Etot, 12] row-major copy (winner re-gather)
    efid: torch.Tensor      # [Etot] i64 sorted-face ids per entry
    offsets: torch.Tensor   # [T_ids+1] i64 entry segment bounds per tile id
    czmin_e: torch.Tensor   # [Ce] f32 per-chunk depth lower bound
    czmin_o: torch.Tensor   # [Co] f32 (ascending) for the overflow segment
    o_chunks: torch.Tensor  # i64 scalar: occupied overflow chunks
    e_pad: int              # overflow segment base index in ed_t
    scene_min: torch.Tensor  # [3] f32 scene AABB (per-ray search cap)
    scene_max: torch.Tensor  # [3]
    lost_faces: torch.Tensor  # i64 scalar: faces demoted to overflow by the
                              # ~2F entry cap (correct, but slow)


def bin_faces(vertices, faces, camCv2world, K, cmin, cmax, W, H, sort_method="argsort"):
    """Build the per-view binning tables. All tensors on one device;
    camCv2world [3,4] and K [3,3] f32 tensors; cmin/cmax [2] f32 hulls of
    the ray pixel coordinates (conservative drop bounds); sort_method: see
    ``argsort_keys`` (two sorts per view: the entries, the overflow faces).

    Valid entries are stream-compacted into a ~2F-capped buffer before the
    sort; faces whose entries miss the cap are demoted WHOLE to the exact
    overflow segment, so no hit can be lost."""
    dev = vertices.device
    Tx = -(-W // TILE_PX)
    Ty = -(-H // TILE_PX)
    T_ids = _morton2_host(Tx - 1, Ty - 1) + 1
    if T_ids * (1 << _Z_BITS) >= 2 ** 31:
        raise ValueError(f"tile-id key space overflow: {Tx}x{Ty} tiles")

    F = faces.shape[0]
    fd = precompute_face_data(vertices, faces)
    o = camCv2world[:3, 3]
    R = camCv2world[:3, :3]

    # Shared-origin hoists (the per-pair arithmetic of the reference tracer).
    tnum = fd.c - (fd.n[:, 0] * o[0] + fd.n[:, 1] * o[1] + fd.n[:, 2] * o[2])
    oa = (fd.a[:, 0] * o[0] + fd.a[:, 1] * o[1] + fd.a[:, 2] * o[2]) - fd.a0
    ob = (fd.b[:, 0] * o[0] + fd.b[:, 1] * o[1] + fd.b[:, 2] * o[2]) - fd.b0
    packed = torch.cat(
        [fd.n, fd.a, fd.b, tnum[:, None], oa[:, None], ob[:, None]], dim=1
    )  # [F,12]

    # Camera-space vertices of each face: q = R^T (p - o).
    tri = vertices[faces.long().reshape(-1)].reshape(F, 3, 3)
    rel = tri - o
    qx = rel[..., 0] * R[0, 0] + rel[..., 1] * R[1, 0] + rel[..., 2] * R[2, 0]
    qy = rel[..., 0] * R[0, 1] + rel[..., 1] * R[1, 1] + rel[..., 2] * R[2, 1]
    qz = rel[..., 0] * R[0, 2] + rel[..., 1] * R[1, 2] + rel[..., 2] * R[2, 2]

    zmin = qz.amin(dim=1)
    frontal = zmin > _Z_NEAR
    # A face with EVERY vertex behind the camera plane is unhittable.
    hittable = qz.amax(dim=1) > 0.0

    zs = torch.clamp(qz, min=_Z_NEAR)
    u = (K[0, 0] * qx + K[0, 1] * qy) / zs + K[0, 2]
    v = (K[1, 1] * qy) / zs + K[1, 2]
    umin, umax = u.amin(dim=1), u.amax(dim=1)
    vmin, vmax = v.amin(dim=1), v.amax(dim=1)
    # Conservative margin: sub-pixel slack for B_EPS/f32 rounding.
    ext = torch.maximum(umax - umin, vmax - vmin)
    mag = torch.maximum(umax.abs(), vmax.abs())
    margin = 1.5 + 1e-4 * ext + 1e-5 * mag
    umin, umax = umin - margin, umax + margin
    vmin, vmax = vmin - margin, vmax + margin

    onscreen = (
        (umax >= cmin[0]) & (umin <= cmax[0])
        & (vmax >= cmin[1]) & (vmin <= cmax[1])
    )
    # Camera-plane-STRADDLING faces bypass the hull cull: their eps-clamped
    # projection is not conservative (a vertex just behind the camera
    # clamps toward the principal point), so they go to the overflow
    # segment, which every ray tests.
    vis = hittable & torch.where(frontal, onscreen, torch.ones_like(onscreen))

    def tile_of(x, n):
        # floor, clamped in float first so the int conversion is defined
        return torch.floor(x * (1.0 / TILE_PX)).clamp(-1, n).to(torch.int32).clamp(0, n - 1)

    tx0, tx1 = tile_of(umin, Tx), tile_of(umax, Tx)
    ty0, ty1 = tile_of(vmin, Ty), tile_of(vmax, Ty)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1

    binnable = fd.ok & frontal & (span_x <= 2) & (span_y <= 2)
    overflow = fd.ok & vis & ~binnable
    emit = binnable & onscreen

    # Depth quantization (dequantized floor <= z). Straddling faces sort
    # with z_eff = 0, the only sound early-exit bound for them.
    inf = torch.tensor(float("inf"), device=dev)
    z_eff = torch.where(frontal, zmin, torch.zeros_like(zmin))
    seen = fd.ok & vis
    zmn = torch.where(seen, z_eff, inf).amin()
    zmx = torch.where(seen, z_eff, -inf).amax()
    zmn = torch.minimum(zmn, zmx)  # both inf when nothing visible
    step = torch.clamp((zmx - zmn) / _ZQ_MAX, min=1e-30)
    zq_f = torch.nan_to_num((z_eff - zmn) / step, nan=0.0).clamp(0, _ZQ_MAX)
    zq = zq_f.to(torch.int32)
    zfloor = zmn + zq.to(torch.float32) * step

    invalid_key = T_ids << _Z_BITS
    keys = []
    for sy in range(2):
        for sx in range(2):
            tid = _interleave2(
                torch.minimum(tx0 + sx, tx1), torch.minimum(ty0 + sy, ty1)
            )
            ok_slot = emit & (sx < span_x) & (sy < span_y)
            keys.append(torch.where(ok_slot, (tid << _Z_BITS) | zq,
                                    torch.full_like(tid, invalid_key)))
    keys = torch.stack(keys, dim=1).reshape(-1)  # [4F] slot-major

    Ecap = max(CHUNK, -(-2 * F // CHUNK) * CHUNK)
    valid_slot = keys < invalid_key
    pos = torch.cumsum(valid_slot.to(torch.int64), dim=0) - 1
    fits = valid_slot & (pos < Ecap)
    lost = (valid_slot & ~fits).reshape(F, 4).any(dim=1)
    slot = torch.where(fits, pos, torch.full_like(pos, Ecap))  # Ecap: discard
    ckeys = torch.full((Ecap + 1,), invalid_key, dtype=torch.int32, device=dev)
    ckeys[slot] = torch.where(fits, keys, torch.full_like(keys, invalid_key))
    ckeys = ckeys[:Ecap]
    # Unfilled cfid slots keep face id 0 — safe ONLY because their keys stay
    # invalid_key, so valid_e masks them to (0, +inf) and they never win.
    fid4 = torch.arange(4 * F, device=dev) // 4
    cfid = torch.zeros(Ecap + 1, dtype=torch.int64, device=dev)
    cfid[slot] = fid4
    cfid = cfid[:Ecap]
    sorted_keys, order = argsort_keys(ckeys, invalid_key.bit_length(), sort_method)
    entry_fid = cfid[order]
    valid_e = sorted_keys < invalid_key

    ed_e = torch.where(valid_e[:, None], packed[entry_fid], torch.zeros((), device=dev))
    ez_e = torch.where(valid_e, zfloor[entry_fid], inf)

    bounds = torch.arange(T_ids + 1, dtype=torch.int32, device=dev) << _Z_BITS
    offsets = torch.searchsorted(sorted_keys, bounds, right=False)

    # Overflow segment: z-sorted (ascending => exact monotone early exit).
    # Includes compaction-demoted faces, tested against every ray.
    in_o = overflow | lost
    okey = torch.where(in_o, zq, torch.full_like(zq, 1 << 30))
    _, oorder = argsort_keys(okey, 31, sort_method)
    o_count = in_o.sum()
    Op = -(-F // CHUNK) * CHUNK
    valid_o = torch.arange(F, device=dev) < o_count
    ed_o = torch.where(valid_o[:, None], packed[oorder], torch.zeros((), device=dev))
    ez_o = torch.where(valid_o, zfloor[oorder], inf)
    pad_o = Op - F
    if pad_o:
        ed_o = torch.nn.functional.pad(ed_o, (0, 0, 0, pad_o))
        ez_o = torch.nn.functional.pad(ez_o, (0, pad_o), value=float("inf"))
        oorder = torch.nn.functional.pad(oorder, (0, pad_o))
    o_chunks = (o_count + CHUNK - 1) // CHUNK

    ed_rows = torch.cat([ed_e, ed_o], dim=0)
    return BinTables(
        ed_t=ed_rows.t().contiguous(), ed_rows=ed_rows,
        efid=torch.cat([entry_fid, oorder]), offsets=offsets,
        czmin_e=ez_e.reshape(-1, CHUNK).amin(dim=1),
        czmin_o=ez_o.reshape(-1, CHUNK).amin(dim=1),
        o_chunks=o_chunks, e_pad=Ecap,
        scene_min=vertices.amin(dim=0), scene_max=vertices.amax(dim=0),
        lost_faces=lost.sum(),
    )


def _do_chunk(ed_t, start, d, best_t, best_e, active):
    """Test rays d [n,rt,3] against the chunk starting at entry start [n];
    strict-< update of best_t/best_e [n,rt] where the packet is active."""
    cols = start[:, None] + torch.arange(CHUNK, device=d.device)
    EDc = ed_t[:, cols]  # [12, n, chunk]

    def dot3t(rows):
        return (d[..., 0:1] * EDc[rows][:, None, :]
                + d[..., 1:2] * EDc[rows + 1][:, None, :]
                + d[..., 2:3] * EDc[rows + 2][:, None, :])

    dn, dA, dB = dot3t(0), dot3t(3), dot3t(6)
    t = EDc[9][:, None, :] / dn
    u = EDc[10][:, None, :] + t * dA
    v = EDc[11][:, None, :] + t * dB
    hit = (
        (dn.abs() > 1e-12)
        & (t > T_EPS)
        & (u >= -B_EPS)
        & (v >= -B_EPS)
        & (u + v <= 1.0 + B_EPS)
    )
    tm = torch.where(hit, t, torch.full_like(t, float("inf")))
    t_c, j = tm.min(dim=-1)  # first minimum, like the reference's argmin
    better = active[:, None] & (t_c < best_t)
    best_t = torch.where(better, t_c, best_t)
    best_e = torch.where(better, start[:, None] + j, best_e)
    return best_t, best_e


def traverse(tables, origins, dirs, coords, *, Tx, Ty):
    """Walk each packet's tile-span entries, then the overflow segment.
    Returns (best_t [R], best_e [R]) — best_e indexes the tables' entries."""
    dev = origins.device
    R = origins.shape[0]
    n_e_chunks = tables.e_pad // CHUNK
    Rp = -(-R // RAY_TILE) * RAY_TILE

    def packets(x):
        if Rp > R:
            x = torch.cat([x, x[-1:].expand(Rp - R, x.shape[1])])
        return x.reshape(-1, RAY_TILE, x.shape[1])

    o_t, d_t, c_t = packets(origins), packets(dirs), packets(coords)
    P = o_t.shape[0]

    # Rays clamp into the border tiles exactly like the face bins do.
    def tile_of(c, n):
        return (c / TILE_PX).clamp(-1, n).to(torch.int32).clamp(0, n - 1)

    tid = _interleave2(tile_of(c_t[..., 0], Tx), tile_of(c_t[..., 1], Ty))
    e0 = tables.offsets[tid.amin(dim=1).long()]
    e1 = tables.offsets[tid.amax(dim=1).long() + 1]
    c0 = e0 // CHUNK
    c1 = torch.clamp((e1 + CHUNK - 1) // CHUNK, max=n_e_chunks)
    span = torch.clamp(c1 - c0, min=0)

    # Per-ray search cap: scene-AABB exit distance.
    tiny = torch.where(d_t < 0, -1e-12, 1e-12)
    d_safe = torch.where(d_t.abs() > 1e-12, d_t, tiny)
    t1 = (tables.scene_min - o_t) / d_safe
    t2 = (tables.scene_max - o_t) / d_safe
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    in_box = t_far >= torch.clamp(t_near, min=0.0)
    t_cap = torch.where(in_box, t_far * (1 + 1e-5) + 1e-4,
                        torch.full_like(t_far, -float("inf")))

    # The one host sync of the view: span lengths and overflow chunks.
    with launches.span("raster.sync"):
        span_h = span.cpu().numpy()
        o_chunks = int(tables.o_chunks.item())
    order_h = np.argsort(-span_h, kind="stable")
    order = torch.from_numpy(order_h).to(dev)
    span_sorted = span_h[order_h]
    if launches.tracing():  # the loops below: per group, its longest span, then the overflow
        heads = span_sorted[::PACKET_GROUP]
        launches.add("chunk_steps", int(heads.sum()) + o_chunks * len(heads))

    best_t = torch.full((P, RAY_TILE), float("inf"), device=dev)
    best_e = torch.full((P, RAY_TILE), -1, dtype=torch.int64, device=dev)
    for g0 in range(0, P, PACKET_GROUP):
        pk = order[g0:g0 + PACKET_GROUP]
        g_span = span_sorted[g0:g0 + PACKET_GROUP]
        d = d_t[pk]
        cap = t_cap[pk]
        c0g = c0[pk]
        bt = best_t[pk]
        be = best_e[pk]
        # Entry span: chunks in (tile, depth) order. Per-chunk depth bounds
        # are not monotone across tiles, so a chunk that cannot improve is
        # skipped (masked), never used as a stop condition.
        for k in range(int(g_span[0]) if len(g_span) else 0):
            n = int(np.count_nonzero(g_span > k))  # sorted: a prefix
            ck = c0g[:n] + k
            frontier = torch.minimum(bt[:n], cap[:n]).amax(dim=1)
            active = tables.czmin_e[ck] < frontier
            bt[:n], be[:n] = _do_chunk(tables.ed_t, ck * CHUNK, d[:n], bt[:n],
                                       be[:n], active)
        # Overflow segment: globally depth-ascending, so once a packet's
        # frontier drops below a chunk's bound it stays below for the rest.
        for k in range(o_chunks):
            frontier = torch.minimum(bt, cap).amax(dim=1)
            active = tables.czmin_o[k] < frontier
            start = torch.full_like(c0g, tables.e_pad + k * CHUNK)
            bt, be = _do_chunk(tables.ed_t, start, d, bt, be, active)
        best_t[pk] = bt
        best_e[pk] = be
    return best_t.reshape(-1)[:R], best_e.reshape(-1)[:R]


def intersect_coords_pinhole_core(vertices, faces, camCv2world, K, coords, *, W, H,
                                  coord_hull=None, return_dirs=False, sort_method="argsort"):
    """Trace body. vertices [V,3] f32 and faces [F,3] int tensors and coords
    [L,2] f32 on one device; camCv2world and K host arrays (numpy).
    coord_hull: optional [2,2] (cmin; cmax) pixel hull override for the
    conservative face cull (default: from `coords`). return_dirs: return
    (hits, the re-normalised unit ray directions [L,3]), which the
    view-dependent field needs. sort_method: the binning sort
    (``argsort_keys``); every method gives the same hits, bit for bit."""
    dev = coords.device
    origins, dirs = ray_origins_and_directions(camCv2world, K, coords)
    # The reference tracer re-normalizes its (already unit) dirs and
    # converts t back; the same ops keep per-pair results identical.
    dir_norm = torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-30)
    dirs = dirs / dir_norm

    if coord_hull is None:
        cmin, cmax = coords.amin(dim=0), coords.amax(dim=0)
    else:
        hull = torch.as_tensor(np.asarray(coord_hull, np.float32), device=dev)
        cmin, cmax = hull[0], hull[1]
    cam_t = torch.as_tensor(np.asarray(camCv2world, np.float32)[:3, :4], device=dev)
    K_t = torch.as_tensor(np.asarray(K, np.float32)[:3, :3], device=dev)
    with launches.span("raster.bin"):
        tables = bin_faces(vertices, faces, cam_t, K_t, cmin, cmax, W, H, sort_method)
    best_t, best_e = traverse(tables, origins, dirs, coords,
                              Tx=-(-W // TILE_PX), Ty=-(-H // TILE_PX))

    valid = torch.isfinite(best_t)
    se = torch.where(valid, best_e, torch.zeros_like(best_e))
    face_idx = torch.where(valid, tables.efid[se], torch.full_like(se, -1))

    # Winner (u,v) recomputed from the winning entry's packed row — same
    # inputs, same f32 op order as the chunk body.
    G = tables.ed_rows[se]
    A, B = G[:, 3:6], G[:, 6:9]
    dA = dirs[:, 0] * A[:, 0] + dirs[:, 1] * A[:, 1] + dirs[:, 2] * A[:, 2]
    dB = dirs[:, 0] * B[:, 0] + dirs[:, 1] * B[:, 1] + dirs[:, 2] * B[:, 2]
    zero = torch.zeros((), device=dev)
    tsafe = torch.where(valid, best_t, zero)
    best_u = torch.where(valid, G[:, 10] + tsafe * dA, zero).clamp(0.0, 1.0)
    best_v = torch.where(valid, G[:, 11] + tsafe * dB, zero).clamp(0.0, 1.0)
    bary = torch.stack([1.0 - best_u - best_v, best_u, best_v], dim=-1).clamp(0.0, 1.0)
    bary = bary / torch.clamp(bary.sum(-1, keepdim=True), min=1e-12)
    hits = Hits(t=best_t / dir_norm.reshape(-1), face_idx=face_idx, bary=bary, valid=valid)
    return (hits, dirs) if return_dirs else hits


def intersect_coords_pinhole(vertices, faces, camCv2world, K, coords, *, W, H,
                             device="cuda", coord_hull=None, sort_method="argsort"):
    """Nearest-hit trace of the pinhole rays through pixel `coords` [L,2].

    Rays are generated internally (ray_gen semantics); the candidate set
    comes from projective binning. W/H size the tile grid. Inputs may be
    numpy or tensors; they are moved to `device`. sort_method: "argsort"
    (torch.sort), "radix", "bitonic" or "bitonic_vmem" (the CUDA kernel on
    the card). Returns a dense Hits (t in unit-direction parameterization)."""
    from .. import resolve_device

    check_pinhole_K(K)
    dev = resolve_device(device)
    verts = torch.as_tensor(np.asarray(vertices, np.float32), device=dev)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    coords = torch.as_tensor(np.asarray(coords, np.float32), device=dev)
    return intersect_coords_pinhole_core(
        verts, faces, np.asarray(camCv2world), np.asarray(K), coords, W=W, H=H,
        coord_hull=coord_hull, sort_method=sort_method,
    )
