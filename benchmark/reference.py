"""The plain reference: the intrinsic texture field, its L1 train step with
optax's Adam, the first-hit tracer and the composite, in plain torch. It
imports nothing of the program and takes nothing the program made: it
reads the benchmark's inputs (inputs.py) and works out again what the
program derives from them (the hit-feature table, the view encoding, the
hits of a view). Matmuls run in float32 with TF32 off; the tracer runs in
float64.

`q`, where a function takes it, rounds every matmul operand (features,
weights, activations and the deltas of the backward) before the product,
accumulating in float32: None is the reference itself, `fp8` the control
(float8 e4m3 with one scale per tensor, the step below the configuration's
bfloat16).
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E4M3_MAX = 448.0
# trace_view's triangle-test tolerance: BARY_TOL, plus COND_TOL times the
# face's condition (an f32 tracer's barycentrics err by ~1e-3 at a grazing
# face; the port's own tolerance is 1e-4)
BARY_TOL = 3e-4
COND_TOL = 5e-5


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value."""
    amax = x.detach().abs().amax()
    s = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


PRECISIONS = {"float32": None, "float8_e4m3fn": fp8}


class _QLinear(torch.autograd.Function):
    """x @ W^T + b with every operand of the forward and the backward
    rounded by q."""

    @staticmethod
    def forward(ctx, x, w, b, q):
        qx, qw = q(x), q(w)
        ctx.save_for_backward(qx, qw)
        ctx.q = q
        return qx @ qw.t() + b

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = ctx.q(g)
        return qg @ qw, qg.t() @ qx, g.sum(0), None


def linear(x, w, b, q=None):
    return x @ w.t() + b if q is None else _QLinear.apply(x, w, b, q)


def field_forward(p, cfg, x, venc=None, q=None):
    """The texture field of the configuration on its torch state dict `p`
    (the upstream model.py's names): relu hidden layers, the skip layer
    relu(Lx h + Ly x), a sigmoid RGB head; a view-dependent field's spatial
    part ends in a relu bottleneck, concatenated with the view encoding and
    fed through Linear, relu, Linear, sigmoid."""
    m = cfg["model"]
    n, skip = m["num_layers"], m["skip_layer_idx"]
    vd = m.get("view_dependence")
    pre = "" if vd is None else "spatial_mlp."
    def lin(h, name):
        return linear(h, p[f"{pre}layers.{name}.weight"], p[f"{pre}layers.{name}.bias"], q)

    h = x
    for i in range(n - 1):
        if i == skip:
            h = torch.relu(lin(h, f"{i}.Lx") + lin(x, f"{i}.Ly"))
        else:
            h = torch.relu(lin(h, f"{i}.0"))
    head = lin(h, f"{n - 1}.0")
    if vd is None:
        return torch.sigmoid(head)
    h = torch.cat([torch.relu(head), venc], 1)
    h = torch.relu(linear(h, p["directional_mlp.0.weight"], p["directional_mlp.0.bias"], q))
    return torch.sigmoid(linear(h, p["directional_mlp.2.weight"], p["directional_mlp.2.bias"], q))


def view_encoding(dirs, normals, vd):
    """The intrinsic view encoding: a, the angle between the flipped unit
    ray and the hit face's normal, as [cos(a f) | sin(a f) | a] over the
    bands f = 2^i pi, i < embed_size."""
    if vd["strategy"] != "intrinsic" or vd["in_dim_view_dir"] != 1:
        raise ValueError("the reference encodes the intrinsic view angle only")
    cos = (-dirs * normals).sum(1) / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=1) * torch.linalg.vector_norm(normals, dim=1),
        min=1e-12)
    a = torch.arccos(torch.clamp(cos, -1.0, 1.0))[:, None]
    bands = torch.tensor([2.0 ** i * math.pi for i in range(vd["embed_size"])],
                         dtype=torch.float32, device=dirs.device)
    parts = [torch.cos(a * bands), torch.sin(a * bands)]
    if vd["include_view_dir"]:
        parts.append(a)
    return torch.cat(parts, 1)


def interpolate(basis, vids, bary):
    """Barycentric interpolation of per-vertex rows at the hits, f32."""
    return (basis[vids] * bary[..., None]).sum(1)


def train_steps(p0, cfg, batches, q=None, fault=None, keep=(), epoch_from=None):
    """Follow L1 train steps with optax's Adam from the state dict p0, one
    per item of `batches`: (x [B,k], venc [B,v] or None, target [B,3]).
    Returns {"losses": [float], "grad1": {leaf: tensor}, "params": {step:
    state dict after that step, for each step in keep}, "params_end",
    "mu_end": the parameters and Adam's first moment after the last step}.
    fault (for the control's checks): "unchanged" leaves the parameters and
    moments as they are, "half_batch" takes the loss over the first half of
    each batch, "hyper_row0" gives every step from step `epoch_from` on the
    bias corrections of that first step (an epoch that reads its first
    hyper row throughout)."""
    t = cfg["training"]
    lr, b1, b2, eps = (torch.tensor(v, dtype=torch.float32) for v in (t["lr"], 0.9, 0.999, 1e-8))
    p = {k: v.detach().clone().float() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": [], "grad1": None, "params": {}}
    for step, (x, venc, gt) in enumerate(batches, 1):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        if fault == "half_batch":
            h = x.shape[0] // 2
            x, gt, venc = x[:h], gt[:h], None if venc is None else venc[:h]
        pred = field_forward(leaves, cfg, x.float(), None if venc is None else venc.float(), q)
        loss = (pred - gt).abs().mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out["losses"].append(loss.detach())
        g = dict(zip(leaves, grads))
        if step == 1:
            out["grad1"] = {k: v.detach().clone() for k, v in g.items()}
        if fault != "unchanged":
            bias_step = epoch_from if fault == "hyper_row0" and step >= epoch_from else step
            with torch.no_grad():
                c1 = 1.0 - b1 ** bias_step
                c2 = 1.0 - b2 ** bias_step
                for k in p:
                    mu[k] = b1 * mu[k] + (1.0 - b1) * g[k]
                    nu[k] = b2 * nu[k] + (1.0 - b2) * g[k] * g[k]
                    p[k] = p[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        if step in keep:
            out["params"][step] = {k: v.clone() for k, v in p.items()}
    out["losses"] = [float(v) for v in out["losses"]]
    out["params_end"], out["mu_end"] = p, mu
    return out


# ------------------------------------------------------------------ tracer


def trace_view(vertices, faces, cam, K, H, W):
    """First hits of the rays through every pixel (x, y) of an H x W view:
    direction R K^-1 [x, y, 1], origin the camera centre (cam: OpenCV
    camera-to-world [3,4]). Each face is tested, by Moller-Trumbore in f64,
    against the pixels of its projected bounding box grown by one pixel
    (every face in front of the camera; a face reaching behind it against
    all pixels). A hit counts with its barycentrics inside the triangle by
    more than a tolerance (strict), or within it (loose): BARY_TOL, plus
    COND_TOL times the pair's condition |d| |e1| |e2| / |det|, which grows
    as the ray grazes the face. A pixel whose strict and loose first hits
    differ lies on an edge or a silhouette within an f32 tracer's error and
    is ambiguous.

    vertices [V,3] f64, faces [F,3] int64 (torch, one device). Returns
    (face [H*W] int64, -1 on a miss; bary [H*W,3] f64; ambiguous [H*W] bool),
    row-major pixels, from the strict hits."""
    dev = vertices.device
    f64 = dict(dtype=torch.float64, device=dev)
    cam = torch.as_tensor(cam, **f64)
    K = torch.as_tensor(K, **f64)
    R, C = cam[:, :3], cam[:, 3]
    M = R @ torch.linalg.inv(K)
    pc = (vertices - C) @ R  # camera-frame vertices
    z = pc[:, 2]
    front = z > 1e-6
    zs = torch.where(front, z, torch.ones_like(z))
    px = K[0, 0] * pc[:, 0] / zs + K[0, 1] * pc[:, 1] / zs + K[0, 2]
    py = K[1, 1] * pc[:, 1] / zs + K[1, 2]
    fx, fy = px[faces], py[faces]
    all_front = front[faces].all(1)
    x0 = torch.where(all_front, torch.floor(fx.min(1).values) - 1, torch.zeros_like(fx[:, 0]))
    x1 = torch.where(all_front, torch.ceil(fx.max(1).values) + 1, torch.full_like(fx[:, 0], W - 1))
    y0 = torch.where(all_front, torch.floor(fy.min(1).values) - 1, torch.zeros_like(fy[:, 0]))
    y1 = torch.where(all_front, torch.ceil(fy.max(1).values) + 1, torch.full_like(fy[:, 0], H - 1))
    x0, x1 = x0.clamp(0, W - 1).long(), x1.clamp(-1, W - 1).long()
    y0, y1 = y0.clamp(0, H - 1).long(), y1.clamp(-1, H - 1).long()
    w = (x1 - x0 + 1).clamp(min=0)
    h = (y1 - y0 + 1).clamp(min=0)
    counts = w * h
    fid = torch.repeat_interleave(torch.arange(len(faces), device=dev), counts)
    start = torch.cumsum(counts, 0) - counts
    off = torch.arange(len(fid), device=dev) - start[fid]
    pxi = x0[fid] + off % w[fid]
    pyi = y0[fid] + torch.div(off, w[fid], rounding_mode="floor")
    pid = pyi * W + pxi

    d = (torch.stack([pxi.double(), pyi.double(), torch.ones_like(pxi, dtype=torch.float64)], 1)
         @ M.t())
    tri = vertices[faces[fid]]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    pvec = torch.linalg.cross(d, e2)
    det = (e1 * pvec).sum(1)
    scale = torch.linalg.vector_norm(d, dim=1) * torch.linalg.vector_norm(e1, dim=1) \
        * torch.linalg.vector_norm(e2, dim=1)
    ok = det.abs() > 1e-12 * scale
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = C - v0
    u = (tvec * pvec).sum(1) * inv
    qvec = torch.linalg.cross(tvec, e1)
    v = (d * qvec).sum(1) * inv
    t = (e2 * qvec).sum(1) * inv
    ok = ok & (t > 1e-6)
    # the tolerance grows with the face's condition |d| |e1| |e2| / |det|:
    # at a grazing face an f32 tracer's barycentrics err by that much more
    tol = BARY_TOL + COND_TOL * scale / det.abs().clamp(min=1e-300)
    loose = ok & (u >= -tol) & (v >= -tol) & (u + v <= 1.0 + tol)
    strict = ok & (u >= tol) & (v >= tol) & (u + v <= 1.0 - tol)

    P = H * W
    inf = torch.tensor(float("inf"), **f64)

    def first(mask):
        tm = torch.where(mask, t, inf)
        best = torch.full((P,), float("inf"), **f64).scatter_reduce(0, pid, tm, "amin")
        win = mask & (tm == best[pid])
        big = torch.full((P,), len(faces), dtype=torch.int64, device=dev)
        face = big.scatter_reduce(0, pid, torch.where(win, fid, big[pid]), "amin")
        face = torch.where(face == len(faces), torch.full_like(face, -1), face)
        return face, win & (fid == face[pid])

    face_l, _ = first(loose)
    face_s, win_s = first(strict)
    bary = torch.zeros((P, 3), **f64)
    sel = win_s.nonzero().squeeze(1)
    bary[pid[sel]] = torch.stack([1.0 - u[sel] - v[sel], u[sel], v[sel]], 1)
    return face_s, bary, face_l != face_s


def render_u8(p, cfg, basis, faces, hit_face, bary, background=1.0, q=None, chunk=1 << 16):
    """[P,3] uint8 colours of a traced view: the field at the interpolated
    features of every hit pixel (the basis rounded by q first, the table's
    precision), the background elsewhere; round(clamp(c, 0, 1) 255)."""
    P = hit_face.shape[0]
    out = torch.full((P, 3), background, dtype=torch.float32, device=basis.device)
    table = basis if q is None else q(basis)
    hit = (hit_face >= 0).nonzero().squeeze(1)
    with torch.no_grad():
        for s in range(0, len(hit), chunk):
            rows = hit[s:s + chunk]
            x = interpolate(table, faces[hit_face[rows]], bary[rows].float())
            out[rows] = field_forward(p, cfg, x, None, q)
    return torch.round(out.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
