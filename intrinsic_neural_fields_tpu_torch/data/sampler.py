"""Device-resident ray dataset and batch assembly.

All cached hit records and the per-vertex feature table live on the device
as tensors. ``create_ray_data`` shuffles the records once at load time (so
contiguous blocks are uniform samples, the precondition of the streaming
``blocks`` shuffle) and, within the ``PRECOMPUTE_BYTES_LIMIT`` budget,
interpolates the features at every hit once (``precompute_hit_features``):
the training loop then reads one row per sample, or streams contiguous
batches straight out of the table.

The xyz / ff / rff families take the mesh's f32 vertex positions as the
per-vertex table (JAX data/sampler.py:214-227), and their batches carry
the interpolated position under "xyz". ``pre_embed_ray_data`` replaces a
split's table by the model's encoding of every hit (JAX :142-180), which
the train kernels then stream like eigenfunction rows.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.interpolate import interpolate_vertex_features
from ..spectral.features import load_first_k_eigenfunctions
from ..utils.jax_random import PRNGKey, permutation
from .load import load_preprocessed_data

# Precompute hit features only while the [N,k] matrix stays under this budget
# (bytes in its storage dtype); above it the per-step vertex gather is used.
PRECOMPUTE_BYTES_LIMIT = 6 << 30


@dataclass
class RayData:
    """All ray-hit supervision records, on one device."""

    features: torch.Tensor                  # [V,k] eigenfeatures or [V,3] vertices
    feature_strategy: str                   # "efuncs" | "xyz" | "ff" | "rff"
    vertex_idxs_of_hit_faces: torch.Tensor  # [N,3] int64
    barycentric_coords: torch.Tensor        # [N,3] f32
    expected_rgbs: torch.Tensor             # [N,3] f32
    unit_ray_dirs: Optional[torch.Tensor] = None  # [N,3] f32
    face_idxs: Optional[torch.Tensor] = None      # [N] int64
    # Optional [N,k] features interpolated at every hit (bf16 or f32 storage)
    hit_features: Optional[torch.Tensor] = None
    # Optional [N, venc_w] encoded view directions of every hit (see
    # precompute_hit_vencs): the view-dependent field's train kernels read
    # them beside hit_features, at the same rows
    hit_vencs: Optional[torch.Tensor] = None

    @property
    def n(self):
        return self.vertex_idxs_of_hit_faces.shape[0]


def parse_precompute_dtype(dtype):
    """data.precompute_dtype config value (None / "bfloat16" / "float32" /
    a torch dtype) -> torch dtype or None."""
    if dtype is None or not isinstance(dtype, str):
        return dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]


@torch.no_grad()
def precompute_hit_features(data, chunk=1 << 16, dtype=None):
    """RayData with the per-vertex features interpolated at every cached
    hit, in chunks; interpolation in f32, stored as `dtype` (None: f32).
    bf16 halves the table and the stream; the kernels round their matmul
    operands to bf16 anyway."""
    dtype = torch.float32 if dtype is None else dtype
    n, k = data.n, data.features.shape[1]
    table = torch.empty((n, k), dtype=dtype, device=data.features.device)
    for s in range(0, n, chunk):
        table[s:s + chunk] = interpolate_vertex_features(
            data.features, data.vertex_idxs_of_hit_faces[s:s + chunk],
            data.barycentric_coords[s:s + chunk]).to(dtype)
    return replace(data, hit_features=table)


@torch.no_grad()
def precompute_hit_vencs(view_encoder, data, venc_w, chunk=1 << 16, dtype=None):
    """RayData with hit_vencs = the view-dependent field's view encoding of
    every cached hit, zero-padded to `venc_w` lanes and stored as `dtype`
    (None: f32), in chunks. view_encoder: models.view_encoder_apply(model),
    a fixed function of the cached ray direction and original face id, so
    encoding once per hit is exact."""
    if data.unit_ray_dirs is None or data.face_idxs is None:
        raise ValueError("view-dependent pre-encoding needs the cached ray directions and "
                         "hit face ids (unit_ray_dirs.npy, face_idxs.npy)")
    dtype = torch.float32 if dtype is None else dtype
    table = torch.zeros((data.n, venc_w), dtype=dtype, device=data.unit_ray_dirs.device)
    for s in range(0, data.n, chunk):
        enc = view_encoder(data.unit_ray_dirs[s:s + chunk], data.face_idxs[s:s + chunk])
        table[s:s + chunk, :enc.shape[1]] = enc.to(dtype)
    return replace(data, hit_vencs=table)


@torch.no_grad()
def pre_embed_ray_data(encoder, data, chunk=1 << 16, dtype=None):
    """RayData whose hit_features hold the model's embedded MLP input, one
    row per cached hit: encoder(interpolated position), in chunks on the
    data's device, stored as `dtype` (None: f32). encoder:
    models.input_encoder_apply(model).

    The position is interpolated from the f32 vertex table (never from a
    bf16 precomputed table), so the encoding sees full precision. The
    result reports feature_strategy "efuncs" (its rows feed the MLP as
    they are, under the "eigenfunctions" batch key, as the model's
    mlp_core_view takes them) and a [1, emb_dim] zero placeholder as its
    per-vertex table: its width is the kernels' k_in, and interpolating a
    nonlinear encoding per vertex would be wrong."""
    if data.feature_strategy not in ("xyz", "ff", "rff") or data.features.shape[1] != 3:
        raise ValueError(f"pre-embedding needs a [V, 3] vertex table of an xyz/ff/rff split, "
                         f"got {data.feature_strategy!r} {tuple(data.features.shape)}")
    dtype = torch.float32 if dtype is None else dtype
    verts = data.features.to(torch.float32)
    table = None
    for s in range(0, data.n, chunk):
        emb = encoder(interpolate_vertex_features(
            verts, data.vertex_idxs_of_hit_faces[s:s + chunk],
            data.barycentric_coords[s:s + chunk]))
        if table is None:
            table = torch.empty((data.n, emb.shape[1]), dtype=dtype, device=verts.device)
        table[s:s + chunk] = emb.to(dtype)
    if table is None:
        raise ValueError("pre-embedding an empty split")
    return replace(data, features=torch.zeros((1, table.shape[1]), dtype=torch.float32,
                                              device=verts.device),
                   feature_strategy="efuncs", hit_features=table)


def create_ray_data(preproc_data_path, eigenfunctions_path, k, feature_strategy="efuncs",
                    mesh=None, rescale_strategy="standard", embed_strategy=None,
                    eigenvalues_path=None, hks_timesteps=128, precompute="auto",
                    precompute_dtype=None, shuffle_once=True, seed=0, perm=None,
                    device="cuda"):
    """RayData for one split of a 5-npy ray cache (reference
    ray_dataloader.py:7-54). The per-vertex table is the eigenfunctions
    for "efuncs", the mesh's f32 vertex positions for "xyz", "ff", "rff".

    shuffle_once: permute the records once, by `perm` when given (an [N]
    index array), else by ``permutation(PRNGKey(seed), N)``, the JAX
    package's load-time shuffle (utils/jax_random.py)."""
    dev = resolve_device(device)
    if feature_strategy == "efuncs":
        features = load_first_k_eigenfunctions(
            eigenfunctions_path, k, rescale_strategy=rescale_strategy,
            embed_strategy=embed_strategy, eigenvalues_path=eigenvalues_path, ts=hks_timesteps)
    elif feature_strategy in ("xyz", "ff", "rff"):
        if mesh is None:
            raise ValueError(f"feature_strategy {feature_strategy!r} needs the mesh")
        features = np.asarray(mesh.vertices, dtype=np.float32)
    else:
        raise ValueError(f"Unknown input feature strategy: {feature_strategy}")
    raw = load_preprocessed_data(preproc_data_path)
    n = raw["vertex_idxs_of_hit_faces"].shape[0]
    order = None
    if shuffle_once and n > 1:
        if perm is None:
            perm = permutation(PRNGKey(seed), n)
        order = torch.as_tensor(np.array(perm), dtype=torch.int64)
        if order.shape != (n,):
            raise ValueError(f"perm must have shape ({n},), got {tuple(order.shape)}")

    def put(key, dtype):
        if key not in raw:
            return None
        t = torch.as_tensor(raw[key]).to(dtype)
        if order is not None:
            t = t[order]
        return t.to(dev)

    data = RayData(
        features=torch.as_tensor(features).to(dev),
        feature_strategy=feature_strategy,
        vertex_idxs_of_hit_faces=put("vertex_idxs_of_hit_faces", torch.int64),
        barycentric_coords=put("barycentric_coords", torch.float32),
        expected_rgbs=put("expected_rgbs", torch.float32),
        unit_ray_dirs=put("unit_ray_dirs", torch.float32),
        face_idxs=put("face_idxs", torch.int64),
    )
    dtype = parse_precompute_dtype(precompute_dtype)
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if precompute is True or (
        precompute == "auto" and n * data.features.shape[1] * itemsize <= PRECOMPUTE_BYTES_LIMIT
    ):
        data = precompute_hit_features(data, dtype=dtype)
    return data


def num_train_batches(n, batch_size, drop_last=True):
    return n // batch_size if drop_last else -(-n // batch_size)


def feature_key(data):
    """The batch key of a split's features: "eigenfunctions", or "xyz" for
    the position families (JAX data/sampler.py:_feature_key)."""
    return "eigenfunctions" if data.feature_strategy == "efuncs" else "xyz"


def gather_batch(data, idx):
    """Batch dict for the index tensor `idx` (on the data's device): one row
    gather of the precomputed table, or three vertex rows interpolated."""
    batch = {"expected_rgbs": data.expected_rgbs.index_select(0, idx)}
    key = feature_key(data)
    if data.hit_features is not None:
        batch[key] = data.hit_features.index_select(0, idx)
    else:
        batch[key] = interpolate_vertex_features(
            data.features, data.vertex_idxs_of_hit_faces.index_select(0, idx),
            data.barycentric_coords.index_select(0, idx))
    if data.unit_ray_dirs is not None:
        batch["unit_ray_dirs"] = data.unit_ray_dirs.index_select(0, idx)
        batch["hit_face_idxs"] = data.face_idxs.index_select(0, idx)
    return batch


def slice_batch(data, start, batch_size):
    """Contiguous batch [start, start + batch_size) of the precomputed
    table: views, no copy (the streaming path of blocks-shuffled epochs)."""
    if data.hit_features is None:
        raise ValueError("slice_batch needs precomputed hit features")
    if start < 0 or start + batch_size > data.n:
        raise ValueError(f"batch [{start}, {start + batch_size}) outside [0, {data.n})")
    sl = slice(start, start + batch_size)
    batch = {"expected_rgbs": data.expected_rgbs[sl], feature_key(data): data.hit_features[sl]}
    if data.unit_ray_dirs is not None:
        batch["unit_ray_dirs"] = data.unit_ray_dirs[sl]
        batch["hit_face_idxs"] = data.face_idxs[sl]
    return batch
