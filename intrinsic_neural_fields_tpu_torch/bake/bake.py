"""Texture baking: evaluate a trained field at every texel of a UV-unwrapped
mesh and write a standard diffuse texture (the JAX package's bake/bake.py;
reference bake_texture_field.py).

Flow (reverse UV lookup, matching the reference):
  1. Load the UV mesh (MeshLab tri export, vertices duplicated on seams) and
     the field mesh; match UV-mesh vertices to field-mesh vertices by exact
     position (KD-tree query, reference :350-353).
  2. For every texel center, find its containing UV triangle: KD-tree over
     triangle centroids + point-in-triangle test on the nearest candidates,
     degenerate (area < 1e-4 px^2) triangles excluded (reference :96-161).
  3. Barycentric coords in UV space with an exact-reconstruction assert
     (reference :196-228).
  4. Evaluate the field at the corresponding field-mesh surface points:
     8,192-point chunks through the feature interpolation and the fused MLP
     (the forward kernel on the card, its plain twin on the CPU).
  5. Fill texel holes with a normalized binomial-kernel blur (reference
     :245-263), write colormap-debug + baked textures with .obj/.mtl copies.

The host parts (steps 1-3 and 5) are copies of the JAX package's
(bake/bake.py:30-139, :201-312), with two changes so the port needs neither
OpenCV nor matplotlib: PNGs are written through Pillow (the same 8-bit
pixels cv2.imwrite stores), and the debug colormap is a degree-6 polynomial
fit of matplotlib's viridis (within 0.02 of its 256-entry table per
channel).
"""
from __future__ import annotations

import os
import shutil
import warnings

import numpy as np
from scipy.signal import convolve2d
from scipy.spatial import cKDTree

_CHUNK = 1 << 13  # texels per feature-gather + MLP launch, as the renderer's


def area_tri_2d(a, b, c):
    v0 = a - c
    v1 = b - c
    return 0.5 * (v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0])


def _sign(p1, p2, p3):
    return (p1[..., 0] - p3[..., 0]) * (p2[..., 1] - p3[..., 1]) - (
        p2[..., 0] - p3[..., 0]
    ) * (p1[..., 1] - p3[..., 1])


def point_in_tri_matched(p, a, b, c):
    """p [N,2] vs per-point candidate triangles a/b/c [N,T,2] -> [N,T] bool.

    NOTE: boundary-EXCLUSIVE (texels exactly on a triangle edge are rejected
    and later filled by uv_fill_holes) — same behavior as the reference's
    point_in_tri_matched (bake_texture_field.py:66-93)."""
    p = p[:, None, :]
    d1 = _sign(p, a, b)
    d2 = _sign(p, b, c)
    d3 = _sign(p, c, a)
    has_neg = (d1 <= 0) | (d2 <= 0) | (d3 <= 0)
    has_pos = (d1 >= 0) | (d2 >= 0) | (d3 >= 0)
    return ~(has_neg & has_pos)


def find_containing_triangles(p, a, b, c, num_neigh=10, min_area=1e-4):
    """For each 2D point, the index of a containing triangle or -1.

    KD-tree over centroids of non-degenerate triangles; the num_neigh nearest
    candidates are point-in-triangle tested (reference get_tris_fast :133-161).
    """
    areas = np.abs(area_tri_2d(a, b, c))
    good = np.where(areas >= min_area)[0]
    ag, bg, cg = a[good], b[good], c[good]

    centroids = (ag + bg + cg) / 3.0
    tree = cKDTree(centroids)
    _, idx_partial = tree.query(p, k=min(num_neigh, len(good)))
    if idx_partial.ndim == 1:
        idx_partial = idx_partial[:, None]

    mask = point_in_tri_matched(p, ag[idx_partial], bg[idx_partial], cg[idx_partial])
    num_hits = mask.sum(-1)
    if num_hits.max() > 1:
        warnings.warn(
            f"{int((num_hits > 1).sum())} texels matched more than one triangle; "
            "picking the nearest-centroid one."
        )
    first = np.argmax(mask, axis=-1)
    hit = mask[np.arange(len(mask)), first]
    idx = idx_partial[np.arange(len(first)), first]
    out = np.where(hit, good[idx], -1)
    return out


def barycentric_2d_matched(p, a, b, c):
    """Barycentric coordinates of p [N,2] in matched triangles (a,b,c) [N,2],
    with an exact reconstruction check (reference bary_matched :196-228).

    The solve runs in np.longdouble (x86 80-bit, the same extended precision
    the reference's np.float128 alias gives it at bake_texture_field.py:358):
    near-degenerate UV triangles on seam-heavy atlases make the 2x2 Cramer
    denominator catastrophically small, eroding f64's reconstruction margin
    against the allclose gate (measured on 200k synthetic slivers down to
    1e-4 px height in a 1024px atlas: worst f64 texel error 8.3e-5 px vs
    2.9e-8 px in longdouble — ~2900x more headroom; RESULTS.md bake
    precision note). Outputs are cast back to f64 for interpolation."""
    p = np.asarray(p, np.longdouble)
    a = np.asarray(a, np.longdouble)
    b = np.asarray(b, np.longdouble)
    c = np.asarray(c, np.longdouble)
    v0, v1, v2 = b - a, c - a, p - a
    d00 = np.sum(v0 * v0, -1)
    d01 = np.sum(v0 * v1, -1)
    d11 = np.sum(v1 * v1, -1)
    d20 = np.sum(v2 * v0, -1)
    d21 = np.sum(v2 * v1, -1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    rec = u[:, None] * a + v[:, None] * b + w[:, None] * c
    assert np.allclose(
        rec.astype(np.float64), p.astype(np.float64)
    ), "barycentric reconstruction failed"
    return u.astype(np.float64), v.astype(np.float64), w.astype(np.float64)


def uv_fill_holes(img):
    """Fill zero texels with a normalized 5x5 binomial blur of their non-zero
    neighborhood (reference uv_fill_holes :245-263)."""
    assert img.ndim == 3 and img.shape[-1] == 3
    kernel = np.array([1.0, 4, 6, 4, 1])
    kernel = kernel[:, None] * kernel[None, :]
    kernel /= kernel.sum()

    blurred = np.stack(
        [convolve2d(img[..., i], kernel, mode="same", boundary="fill", fillvalue=0.0)
         for i in range(3)],
        -1,
    )
    out = img.copy()
    mask = np.any(img != 0, axis=-1)
    weight = convolve2d(mask, kernel, mode="same", boundary="fill", fillvalue=0.0)
    fill = ~mask & (weight > 0)
    out[fill] = blurred[fill] / weight[fill, None]
    return out


def _field_rgbs(mesh, config, vids, bary, chunk=_CHUNK, device="cuda", infer=None):
    """Evaluate the trained field (the out_dir's weights:
    utils/checkpoint.resolve_weights_path, model.pt or the JAX package's
    model.ckpt) at surface points given by (face vertex ids [n,3], barycentric
    coords [n,3]): `chunk` points per feature interpolation and fused MLP
    call, on an f32 feature table (the JAX bake's, bake/bake.py:140-195):
    the eigenfunctions, or for xyz / ff / rff the mesh's vertex positions,
    encoded per chunk by the model's own encoder before the kernel. infer:
    as for the Renderer (ops/field_infer.py): "kernel" (the default on
    CUDA) or "plain" (the default on the CPU, the kernel's plain twin);
    unset, a field the kernels do not compute (sine) runs its module's f32
    forward, as the JAX bake's model.apply does. Returns [n, 3] float32."""
    import torch

    from .. import resolve_device
    from ..models.factory import make_model
    from ..ops.field_infer import FieldInfer
    from ..ops.interpolate import interpolate_vertex_features
    from ..spectral.features import load_first_k_eigenfunctions
    from ..utils.checkpoint import load_trained_weights, resolve_weights_path

    dev = resolve_device(device)
    feature_strategy = config["model"].get("feature_strategy", "efuncs")
    if config["model"].get("view_dependence") is not None:
        raise NotImplementedError("Texture baking does not support view dependence.")
    if feature_strategy == "efuncs":
        features = load_first_k_eigenfunctions(
            config["data"]["eigenfunctions_path"],
            config["model"].get("k"),
            rescale_strategy=config["data"].get("rescale_strategy", "standard"),
            embed_strategy=config["data"].get("embed_strategy"),
            eigenvalues_path=config["data"].get("eigenvalues_path"),
            ts=config["model"].get("hks_timesteps", 128),
        )
    elif feature_strategy in ("xyz", "ff", "rff"):
        features = mesh.vertices
    else:
        raise ValueError(f"Unknown feature strategy: {feature_strategy}")
    model = make_model(config["model"], device=dev, mesh=mesh)
    model.load_state_dict(load_trained_weights(
        resolve_weights_path(config["training"]["out_dir"]), config["model"]))
    field = FieldInfer(model, dev, infer)

    E = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    vids_d = torch.as_tensor(np.asarray(vids, np.int64), device=dev)
    bary_d = torch.as_tensor(np.asarray(bary, np.float32), device=dev)
    out = torch.empty((vids_d.shape[0], 3), dtype=torch.float32, device=dev)
    for s in range(0, vids_d.shape[0], chunk):
        sl = slice(s, s + chunk)
        out[sl] = field(interpolate_vertex_features(E, vids_d[sl], bary_d[sl]))
    return out.cpu().numpy()


# matplotlib's viridis, fitted by a degree-6 polynomial per channel
_VIRIDIS_POLY = np.array([
    [0.2777273272234177, 0.005407344544966578, 0.3340998053353061],
    [0.1050930431085774, 1.404613529898575, 1.384590162594685],
    [-0.3308618287255563, 0.214847559468213, 0.09509516302823659],
    [-4.634230498983486, -5.799100973351585, -19.33244095627987],
    [6.228269936347081, 14.17993336680509, 56.69055260068105],
    [4.776384997670288, -13.74514537774601, -65.35303263337234],
    [-5.435455855934631, 4.645852612178535, 26.3124352495832],
])


def viridis(val):
    """[n] values in [0, 1] -> [n, 3] RGB in [0, 1] (the debug colormap)."""
    t = np.clip(np.asarray(val, np.float64), 0.0, 1.0)[:, None]
    out = np.zeros((t.shape[0], 3))
    for c in _VIRIDIS_POLY[::-1]:
        out = out * t + c
    return np.clip(out, 0.0, 1.0)


def _write_u8(path, img):
    """[H,W,3] float in [0,1] -> an 8-bit PNG, truncating as the JAX bake's
    cv2.imwrite((255 * img).astype(np.uint8)) does."""
    from ..utils.io import imwrite

    imwrite(path, (255 * img).astype(np.uint8))


def _diffuse_map_name(uv_mesh_path):
    mtl_file_path = uv_mesh_path + ".mtl"
    with open(mtl_file_path, "r") as fh:
        lines = [l for l in fh.readlines() if l.startswith("map_Kd")]
    if len(lines) != 1:
        raise ValueError(f".mtl file {mtl_file_path} is missing 'map_Kd'")
    return os.path.basename(lines[0].split()[1].strip())


def bake_texture(out_dir, uv_mesh_path, config_path, texture_size=None, device="cuda",
                 infer=None):
    """Bake the trained field of `config_path` into the UV layout of
    `uv_mesh_path` (reference bake_texture :334-439). device, infer: where
    and how the field is evaluated (see _field_rgbs). Returns the path of
    the baked texture."""
    from ..geometry.mesh import load_mesh
    from ..geometry.mesh_io import read_obj_with_uv
    from ..train.config import load_config
    from ..utils.io import imread

    assert not os.path.exists(out_dir), f"out_dir exists: {out_dir}"
    os.makedirs(out_dir)

    config = load_config(config_path)

    uv_verts, uv_faces, uv_coords, _ = read_obj_with_uv(uv_mesh_path)
    m_efs = load_mesh(config["data"]["mesh_path"])

    assert uv_faces.shape == m_efs.faces.shape
    assert len(uv_verts) >= len(m_efs.vertices)
    print(f"UV mesh adds {len(uv_verts) - len(m_efs.vertices)} seam-duplicated vertices")

    # UV-mesh vertex -> field-mesh vertex by exact position match.
    tree_efs = cKDTree(m_efs.vertices)
    dist, idx_uv_to_ef = tree_efs.query(uv_verts)
    assert np.allclose(dist, 0.0), "UV mesh vertices do not coincide with field mesh"

    # Texture resolution: from the existing diffuse map, else --texture_size.
    diffuse_name = _diffuse_map_name(uv_mesh_path)
    existing = os.path.join(os.path.dirname(uv_mesh_path), diffuse_name)
    if texture_size is not None:
        H = W = int(texture_size)
    else:
        tex = imread(existing)
        H, W = tex.shape[:2]

    # Texel-space triangle corners (image convention: v flipped).
    pu = (W - 1) * uv_coords[:, 0]
    pv = (H - 1) * (1.0 - uv_coords[:, 1])
    puvs = np.stack([pu, pv], -1)
    a = puvs[uv_faces[:, 0]]
    b = puvs[uv_faces[:, 1]]
    c = puvs[uv_faces[:, 2]]

    PX, PY = np.meshgrid(np.arange(W), np.arange(H))
    p = np.stack([PX.ravel(), PY.ravel()], -1).astype(np.float64)

    chunk = 1 << 15
    idx = np.concatenate(
        [find_containing_triangles(p[s : s + chunk], a, b, c)
         for s in range(0, p.shape[0], chunk)]
    )

    hit = idx >= 0
    p_val = p[hit]
    idx_val = idx[hit]
    u, v, w = barycentric_2d_matched(p_val, a[idx_val], b[idx_val], c[idx_val])
    bari = np.stack([u, v, w], -1)
    # Clamp boundary round-off so downstream invariants hold.
    bari = np.clip(bari, 0.0, None)
    bari /= bari.sum(-1, keepdims=True)

    faces = uv_faces[idx_val]

    # Debug z-colormap bake.
    xyz_rec = np.einsum("nj,njk->nk", bari, uv_verts[faces])
    val = xyz_rec[:, 2]
    val = (val - val.min()) / max(val.max() - val.min(), 1e-12)
    cols = viridis(val)
    cols_all = np.zeros([p.shape[0], 3])
    cols_all[hit] = cols
    colormap = uv_fill_holes(cols_all.reshape(H, W, 3))

    os.makedirs(os.path.join(out_dir, "colormap"))
    shutil.copyfile(uv_mesh_path, os.path.join(out_dir, "colormap", os.path.basename(uv_mesh_path)))
    shutil.copyfile(uv_mesh_path + ".mtl",
                    os.path.join(out_dir, "colormap", os.path.basename(uv_mesh_path) + ".mtl"))
    _write_u8(os.path.join(out_dir, "colormap", diffuse_name), colormap)

    # Field evaluation at the texel surface points.
    faces_index_efs = idx_uv_to_ef[faces]
    print(f"Computing RGBs for {len(bari)} texels")
    rgbs = _field_rgbs(m_efs, config, faces_index_efs, bari, device=device, infer=infer)
    assert rgbs.shape == bari.shape
    assert np.all(rgbs >= 0) and np.all(rgbs <= 1)

    cols_all = np.zeros([p.shape[0], 3])
    cols_all[hit] = rgbs
    baked = uv_fill_holes(cols_all.reshape(H, W, 3))

    os.makedirs(os.path.join(out_dir, "baked"))
    shutil.copyfile(uv_mesh_path, os.path.join(out_dir, "baked", os.path.basename(uv_mesh_path)))
    shutil.copyfile(uv_mesh_path + ".mtl",
                    os.path.join(out_dir, "baked", os.path.basename(uv_mesh_path) + ".mtl"))
    _write_u8(os.path.join(out_dir, "baked", diffuse_name), baked)
    return os.path.join(out_dir, "baked", diffuse_name)
