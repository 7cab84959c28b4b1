"""The texture fields as nn.Modules (efuncs input, relu, one input skip).

TextureField: the skip-MLP with a sigmoid RGB head, or a relu feature head
(``return_rgb=False``, the bottleneck of the view-dependent family).
TextureFieldWithViewDependency: a TextureField producing a bottleneck
vector, concatenated with an encoded view direction and fed through a
small directional MLP (reference model.py:123-191).

State-dict keys are the upstream torch implementation's, so its model.pt
files (and the reference package's exports) load directly:
  layers.{i}.0.{weight,bias}       Linear of a plain layer (and the head)
  layers.{skip}.Lx / .Ly           skip layer: Lx on h, Ly on the input
  spatial_mlp.layers.* + directional_mlp.{0,2}.*   the view-dependent field
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .encoders import fourier_feat_dim, fourier_feat_enc

RGB_COLOR_DIM = 3


class _SkipLayer(nn.Module):
    """act(Lx(h) + Ly(features))."""

    def __init__(self, hidden, in_dim):
        super().__init__()
        self.Lx = nn.Linear(hidden, hidden)
        self.Ly = nn.Linear(in_dim, hidden)

    def forward(self, h, features):
        return torch.relu(self.Lx(h) + self.Ly(features))


class TextureField(nn.Module):
    """MLP texture field with one input skip, full f32."""

    def __init__(self, in_dim, num_layers, hidden_dim, skip_layer_idx,
                 out_dim=RGB_COLOR_DIM, return_rgb=True):
        super().__init__()
        if not (num_layers > 2 and 0 < skip_layer_idx < num_layers - 1):
            raise ValueError(
                f"need num_layers > 2 and 0 < skip_layer_idx < num_layers-1, "
                f"got {num_layers}, {skip_layer_idx}"
            )
        self.in_dim = in_dim
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.skip_layer_idx = skip_layer_idx
        self.out_dim = out_dim
        self.return_rgb = return_rgb
        layers = []
        for i in range(num_layers - 1):
            d_in = in_dim if i == 0 else hidden_dim
            if i == skip_layer_idx:
                layers.append(_SkipLayer(hidden_dim, in_dim))
            else:
                layers.append(nn.Sequential(nn.Linear(d_in, hidden_dim), nn.ReLU()))
        head = nn.Sigmoid() if return_rgb else nn.ReLU()
        layers.append(nn.Sequential(nn.Linear(hidden_dim, out_dim), head))
        self.layers = nn.ModuleList(layers)

    def forward(self, features):
        h = features
        for i, layer in enumerate(self.layers):
            h = layer(h, features) if i == self.skip_layer_idx else layer(h)
        return h


def calculate_angle_between_vectors(a, b):
    """Angle between row vectors via the clipped cosine similarity
    (reference model.py:115-120)."""
    cos = (a * b).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


class TextureFieldWithViewDependency(nn.Module):
    """Spatial MLP -> relu bottleneck; [bottleneck | encoded view direction]
    -> Linear, relu, Linear, sigmoid -> RGB.

    view_dir_strategy "intrinsic" encodes the angle between the flipped ray
    and the hit face's normal (face normals are a non-persistent f32 buffer
    from the mesh, so the state dict holds the upstream keys only);
    "extrinsic" encodes the unit ray direction itself."""

    def __init__(self, in_dim, num_layers, hidden_dim, skip_layer_idx, bottleneck_vec_dim,
                 in_dim_view_dir, include_view_dir, view_dir_embedding_size,
                 directional_hidden_dim, face_normals=None, view_dir_strategy="intrinsic"):
        super().__init__()
        want = {"intrinsic": 1, "extrinsic": 3}.get(view_dir_strategy)
        if want is None:
            raise ValueError(f"unknown view_dir_strategy {view_dir_strategy!r}")
        if in_dim_view_dir != want:
            raise ValueError(f"strategy {view_dir_strategy!r} encodes a {want}-d view "
                             f"direction, got in_dim_view_dir={in_dim_view_dir}")
        if view_dir_strategy == "intrinsic" and face_normals is None:
            raise ValueError("the intrinsic strategy needs the mesh's face normals")
        self.in_dim = in_dim
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.skip_layer_idx = skip_layer_idx
        self.bottleneck_vec_dim = bottleneck_vec_dim
        self.include_view_dir = include_view_dir
        self.view_dir_embedding_size = view_dir_embedding_size
        self.directional_hidden_dim = directional_hidden_dim
        self.view_dir_strategy = view_dir_strategy
        self.venc_dim = fourier_feat_dim(in_dim_view_dir, view_dir_embedding_size,
                                         include_view_dir)
        self.spatial_mlp = TextureField(in_dim, num_layers, hidden_dim, skip_layer_idx,
                                        out_dim=bottleneck_vec_dim, return_rgb=False)
        self.directional_mlp = nn.Sequential(
            nn.Linear(bottleneck_vec_dim + self.venc_dim, directional_hidden_dim), nn.ReLU(),
            nn.Linear(directional_hidden_dim, RGB_COLOR_DIM), nn.Sigmoid())
        normals = None if face_normals is None else torch.as_tensor(
            np.asarray(face_normals, np.float32))
        self.register_buffer("face_normals", normals, persistent=False)

    def forward(self, features, unit_ray_dirs, hit_face_idxs):
        venc = view_encoder_apply(self)(unit_ray_dirs, hit_face_idxs)
        return self.directional_mlp(torch.cat([self.spatial_mlp(features), venc], dim=-1))


def view_encoder_apply(model):
    """(unit_ray_dirs [N,3], hit_face_idxs [N]) -> the [N, venc_dim] view
    encoding the model concatenates to its bottleneck (reference
    model.py:175-184). It holds no trainable parameter, so it can run
    outside the network: the renderer feeds it to the fused kernel and the
    trainer precomputes it per cached hit. The model's face normals are
    read at call time, so a refreshed buffer is seen."""
    enc = lambda x: fourier_feat_enc(x, model.view_dir_embedding_size,  # noqa: E731
                                     include_input=model.include_view_dir, use_logspace=True)
    if model.view_dir_strategy == "intrinsic":
        def fn(dirs, face_idxs):
            angles = calculate_angle_between_vectors(-dirs,
                                                     model.face_normals[face_idxs.long()])
            return enc(angles[..., None])
        return fn
    return lambda dirs, face_idxs: enc(dirs)
