"""Device-resident ray dataset and batch assembly.

All cached hit records and the per-vertex feature table live on the device
as tensors. ``create_ray_data`` shuffles the records once at load time (so
contiguous blocks are uniform samples, the precondition of the streaming
``blocks`` shuffle) and, within the ``PRECOMPUTE_BYTES_LIMIT`` budget,
interpolates the features at every hit once (``precompute_hit_features``):
the training loop then reads one row per sample, or streams contiguous
batches straight out of the table.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.interpolate import interpolate_vertex_features
from ..spectral.features import load_first_k_eigenfunctions
from .load import load_preprocessed_data

# Precompute hit features only while the [N,k] matrix stays under this budget
# (bytes in its storage dtype); above it the per-step vertex gather is used.
PRECOMPUTE_BYTES_LIMIT = 6 << 30


@dataclass
class RayData:
    """All ray-hit supervision records, on one device."""

    features: torch.Tensor                  # [V,k] eigenfeatures
    feature_strategy: str                   # "efuncs"
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


def create_ray_data(preproc_data_path, eigenfunctions_path, k, feature_strategy="efuncs",
                    mesh=None, rescale_strategy="standard", embed_strategy=None,
                    eigenvalues_path=None, hks_timesteps=128, precompute="auto",
                    precompute_dtype=None, shuffle_once=True, seed=0, perm=None,
                    device="cuda"):
    """RayData for one split of a 5-npy ray cache (reference
    ray_dataloader.py:7-54).

    shuffle_once: permute the records once, by `perm` when given (an [N]
    index array, e.g. a replayed ``jax.random.permutation``), else by
    ``torch.randperm`` from a generator seeded with `seed`."""
    dev = resolve_device(device)
    if feature_strategy != "efuncs":
        raise NotImplementedError(
            f"feature_strategy {feature_strategy!r} is not ported yet (efuncs only)")
    features = load_first_k_eigenfunctions(
        eigenfunctions_path, k, rescale_strategy=rescale_strategy,
        embed_strategy=embed_strategy, eigenvalues_path=eigenvalues_path, ts=hks_timesteps)
    raw = load_preprocessed_data(preproc_data_path)
    n = raw["vertex_idxs_of_hit_faces"].shape[0]
    order = None
    if shuffle_once and n > 1:
        if perm is None:
            perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
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


def gather_batch(data, idx):
    """Batch dict for the index tensor `idx` (on the data's device): one row
    gather of the precomputed table, or three vertex rows interpolated."""
    batch = {"expected_rgbs": data.expected_rgbs.index_select(0, idx)}
    if data.hit_features is not None:
        batch["eigenfunctions"] = data.hit_features.index_select(0, idx)
    else:
        batch["eigenfunctions"] = interpolate_vertex_features(
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
    batch = {"expected_rgbs": data.expected_rgbs[sl], "eigenfunctions": data.hit_features[sl]}
    if data.unit_ray_dirs is not None:
        batch["unit_ray_dirs"] = data.unit_ray_dirs[sl]
        batch["hit_face_idxs"] = data.face_idxs[sl]
    return batch
