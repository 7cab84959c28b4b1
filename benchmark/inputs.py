"""What a run feeds both sides, made from --seed: the mesh, the cameras,
the eigenfunction basis, the cached hits, the targets and the initial
weights. Large arrays are drawn on the run's device by one torch.Generator
in a few bulk calls; the same seed gives the same inputs. Nothing here
imports the program: the harness hands these to the program and to the
reference alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def icosphere(subdivisions):
    """The unit icosphere: an icosahedron whose faces are split in four
    `subdivisions` times, new vertices projected onto the sphere. Returns
    (vertices [V,3] f64, faces [F,3] int64), 20 4^s faces."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.sort(edges, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = len(v) + inv.reshape(3, -1)  # midpoint ids of edges ab, bc, ca per face
        ab, bc, ca = m[0], m[1], m[2]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
        v = np.concatenate([v, mid])
    return v, f


def blob(subdivisions, bump=0.15):
    """The synthetic recipe's blob: the icosphere with a smooth radial bump
    r = 1 + bump (sin 3x cos 2y + 0.5 sin 4z); closed and non-symmetric."""
    v, f = icosphere(subdivisions)
    r = 1.0 + bump * (np.sin(3.0 * v[:, 0]) * np.cos(2.0 * v[:, 1])
                      + 0.5 * np.sin(4.0 * v[:, 2]))
    return v * r[:, None], f


def mesh_arrays(spec):
    if spec["kind"] != "blob":
        raise ValueError(f"unknown mesh kind {spec['kind']!r}")
    return blob(spec["subdivisions"], spec.get("bump", 0.15))


def face_normals(vertices, faces):
    """Unit normals [F,3] f64 by the right-hand rule over (v1-v0) x (v2-v0)."""
    t = vertices[faces]
    n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)


def look_at(eye, up=(0.0, 0.0, 1.0)):
    """OpenCV camera-to-world [3,4] looking at the origin: +z forward, +x
    right, +y down."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.concatenate([np.stack([right, down, fwd], 1), eye[:, None]], 1).astype(np.float32)


def orbit(traffic, seed):
    """The orbit's cameras: `views` look-at cameras on a ring of `radius` at
    `height` x radius above the equator, evenly spaced from a start angle
    drawn from the seed (every seed renders the same number of views)."""
    phase = np.random.default_rng(int(seed) % (1 << 63)).uniform(0.0, 2.0 * np.pi)
    n, r = traffic["views"], traffic["radius"]
    return [look_at(r * np.array([np.cos(phase + 2 * np.pi * i / n),
                                  np.sin(phase + 2 * np.pi * i / n), traffic["height"]]))
            for i in range(n)]


def intrinsics(H, W, focal):
    """Square-pixel pinhole intrinsics, principal point at the image centre."""
    return np.array([[focal * W, 0.0, (W - 1) / 2.0], [0.0, focal * W, (H - 1) / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def initial_weights(shapes, gen, device):
    """{name: tensor} for a field's state-dict shapes: every matrix
    Xavier-uniform, every bias zero; one uniform draw for all matrices."""
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(a * b for a, b in mats.values())
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, o = {}, 0
    for name, s in shapes.items():
        if len(s) != 2:
            out[name] = torch.zeros(s, dtype=torch.float32, device=device)
            continue
        n = s[0] * s[1]
        out[name] = (u[o:o + n] * math.sqrt(6.0 / (s[0] + s[1]))).view(s).contiguous()
        o += n
    return out


def train_arrays(cfg, seed, device):
    """The cached training hits of a configuration, on `device`:
    {"basis" [V,k] f32, "vids" [N,3] int64, "bary" [N,3] f32, "rgbs" [N,3]
    f32} and, for a view-dependent field, {"dirs" [N,3] unit f32, "face_idxs"
    [N] int64, "vertices", "faces" (host numpy)}."""
    td, k = cfg["train_data"], cfg["k"]
    g = generator(seed, device)
    N = td["num_hits"]
    out = {}
    if "mesh" in td:
        v, f = mesh_arrays(td["mesh"])
        V = len(v)
        out["vertices"], out["faces"] = v, f
    else:
        V = td["num_vertices"]
    out["basis"] = torch.randn(V, k, generator=g, device=device)
    if "mesh" in td:
        face_idxs = torch.randint(0, len(f), (N,), generator=g, device=device)
        out["face_idxs"] = face_idxs
        out["vids"] = torch.as_tensor(f, device=device)[face_idxs]
    else:
        out["vids"] = torch.randint(0, V, (N, 3), generator=g, device=device)
    e = torch.empty(N, 3, device=device).exponential_(generator=g)
    out["bary"] = e / e.sum(1, keepdim=True)
    out["rgbs"] = torch.rand(N, 3, generator=g, device=device)
    if "mesh" in td:
        d = torch.randn(N, 3, generator=g, device=device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        n = torch.as_tensor(face_normals(v, f), dtype=torch.float32, device=device)
        facing = (d * n[out["face_idxs"]]).sum(1, keepdim=True) > 0
        out["dirs"] = torch.where(facing, -d, d)  # rays come at the face's front
    return out


def check_rows(seed, num_blocks, count):
    """The blocks the check steps train, distinct, drawn from the seed."""
    rng = np.random.default_rng((int(seed) + 0x5EED) % (1 << 63))
    return [int(b) for b in rng.choice(num_blocks, size=count, replace=False)]


def epoch_order(seed, size):
    """The check epoch's order: a permutation of its `size` blocks drawn
    from the seed, int64 numpy."""
    rng = np.random.default_rng((int(seed) + 0x0DE5) % (1 << 63))
    return rng.permutation(size).astype(np.int64)


def sample_frames(seed, below, count):
    """Window frame indices whose images the check keeps, distinct, below
    `below` (a run renders more frames than that), drawn from the seed."""
    rng = np.random.default_rng((int(seed) + 0xF4A3E) % (1 << 63))
    return sorted(int(i) for i in rng.choice(below, size=count, replace=False))
