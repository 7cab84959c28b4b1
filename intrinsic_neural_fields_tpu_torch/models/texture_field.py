"""The texture fields as nn.Modules (JAX package models/texture_field.py:35-170).

TextureField: the skip-MLP with a sigmoid RGB head, or a relu feature head
(``return_rgb=False``, the bottleneck of the view-dependent family), fed by
one of four inputs: eigenfunction features (``input_feature_embed=None``,
the intrinsic path), the raw hit position ("xyz"), or its Fourier ("ff")
or random Fourier ("rff") encoding, computed by the module itself from the
position (the encoder is registered as ``embedding``); the hidden layers
use ``activation`` "relu" or "sine".
TextureFieldWithViewDependency: a TextureField producing a bottleneck
vector, concatenated with an encoded view direction and fed through a
small directional MLP (reference model.py:123-191).

The input encodings are fixed functions of the position (the RFF
projection is a buffer), so ``input_encoder_apply`` evaluates them outside
the network and ``mlp_core_view`` is the same network over pre-embedded
rows: the renderer encodes each chunk before the forward kernel, and the
Trainer embeds every cached hit once so the train kernels stream the rows
(JAX ``input_encoder_apply`` / ``mlp_core_view``, :118-170).

``batchnorm=True`` puts a BatchNorm after the activation of every hidden
layer (after act(Lx(h) + Ly(x)) at the skip layer), none on the head (JAX
texture_field.py:89-110). Its numerics are flax.linen.BatchNorm's, not
torch's BatchNorm1d's: momentum 0.9 on the running average (running = 0.9
running + 0.1 batch), eps 1e-5, and the BIASED batch variance E[x^2] -
E[x]^2 clamped at 0, for normalising and for the running update alike.
The forward takes ``train`` as the JAX module does: False normalises with
the running statistics, True with the batch's and updates the running
ones in place. ``num_batches_tracked`` stays 0, as the JAX exporter writes
it (flax keeps no step counter).

The forward is written once, as a generator (``steps``) that yields at every
BatchNorm and takes the normalised rows back: ``run_field`` drives one field,
``run_fields_synced`` drives several replicas in step so that their
BatchNorms normalise with statistics over all replicas' rows (sync-BN, the
data-parallel path's; JAX :116-123, the module's ``bn_axis_name``).

State-dict keys are the upstream torch implementation's, so its model.pt
files (and the reference package's exports) load directly:
  layers.{i}.0.{weight,bias}       Linear of a plain layer (and the head)
  layers.{i}.2.*                   its BatchNorm (weight, bias, running_mean,
                                   running_var, num_batches_tracked)
  layers.{skip}.Lx / .Ly           skip layer: Lx on h, Ly on the input
  layers.{skip}.batchnorm.*        the skip layer's BatchNorm
  spatial_mlp.layers.* + directional_mlp.{0,2}.*   the view-dependent field
  embedding.B (spatial_mlp.embedding.B)             the RFF projection
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .encoders import FourierFeatEnc, RandomFourierFeatEnc, fourier_feat_dim, fourier_feat_enc

RGB_COLOR_DIM = 3
ENCODER_FAMILIES = ("xyz", "ff", "rff")
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class Sine(nn.Module):
    def forward(self, x):
        return torch.sin(x)


def _activation_module(name):
    if name == "relu":
        return nn.ReLU()
    if name == "sine":
        return Sine()
    raise NotImplementedError(f"Activation function {name} not implemented.")


def batch_moments(h):
    """[2, C]: the mean over the batch rows of h and of h^2."""
    return torch.stack((h.mean(0), (h * h).mean(0)))


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over the batch axis (see the module docstring),
    holding BatchNorm1d's parameters and buffers."""

    def __init__(self, width):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def normalize(self, h, mean, var):
        """flax's expression order: (h - mean) * (rsqrt(var + eps) * weight) + bias."""
        return (h - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias

    def batch_stats(self, moments):
        """(mean, biased variance) from batch moments [2, C] (one replica's
        or the mean of all replicas'); the running statistics take them in
        place."""
        mean = moments[0]
        var = torch.clamp(moments[1] - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1.0 - BN_MOMENTUM) * mean.detach())
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1.0 - BN_MOMENTUM) * var.detach())
        return mean, var

    def forward(self, h, train=False):
        if train:
            return self.normalize(h, *self.batch_stats(batch_moments(h)))
        return self.normalize(h, self.running_mean, self.running_var)


class _SkipLayer(nn.Module):
    """act(Lx(h) + Ly(features)); its BatchNorm (``batchnorm``) is applied
    by the field's forward."""

    def __init__(self, hidden, in_dim, activation="relu", batchnorm=False):
        super().__init__()
        self.Lx = nn.Linear(hidden, hidden)
        self.Ly = nn.Linear(in_dim, hidden)
        self.act = _activation_module(activation)
        if batchnorm:
            self.batchnorm = BatchNorm(hidden)

    def forward(self, h, features):
        return self.act(self.Lx(h) + self.Ly(features))


def run_field(steps, train=False):
    """Drive one field's forward generator: each BatchNorm normalises with
    its batch's statistics (train) or its running ones."""
    h_out = None
    try:
        while True:
            bn, h = steps.send(h_out)
            h_out = bn(h, train)
    except StopIteration as stop:
        return stop.value


def run_fields_synced(steps, mean_moments):
    """Drive D replicas' forward generators in step, in train mode with
    sync-BN: at each BatchNorm, mean_moments([each replica's batch_moments])
    returns the moments over all replicas (one copy on each replica's
    device, differentiable); every replica normalises with them and updates
    its running statistics from them. Returns the D outputs."""
    outs = [None] * len(steps)
    while True:
        items = []
        for i, s in enumerate(steps):
            try:
                items.append(s.send(outs[i]))
            except StopIteration as stop:
                items.append(stop)
        ended = [isinstance(it, StopIteration) for it in items]
        if all(ended):
            return [it.value for it in items]
        if any(ended):
            raise RuntimeError("the replicas' forwards went out of step")
        moments = mean_moments([batch_moments(h) for _, h in items])
        outs = [bn.normalize(h, *bn.batch_stats(m)) for (bn, h), m in zip(items, moments)]


def _make_encoder(input_feature_embed, embed_dim=None, include_input=True, std=1.0,
                 use_logspace=True, max_freq=None):
    """The encoder module of an input family: FourierFeatEnc ("ff"),
    RandomFourierFeatEnc ("rff", B zeros until the factory loads the
    drawn one), or None (raw eigenfunctions or xyz)."""
    if input_feature_embed == "ff":
        return FourierFeatEnc(embed_dim, include_input=include_input,
                              use_logspace=use_logspace, max_freq=max_freq)
    if input_feature_embed == "rff":
        return RandomFourierFeatEnc(embed_dim, std=std, include_input=include_input)
    if input_feature_embed in (None, "efuncs", "xyz"):
        return None
    raise ValueError(f"Unknown input feature embed: {input_feature_embed}")


class TextureField(nn.Module):
    """MLP texture field with one input skip, full f32.

    in_dim: the MLP's input width (the encoder's output width for "ff" and
    "rff", 3 for "xyz"). input_feature_embed: None / "efuncs" (features
    come in as they are), "xyz", "ff" or "rff" (the input is the [N, 3]
    position); the embed_* arguments configure the encoder as in the JAX
    TextureField."""

    def __init__(self, in_dim, num_layers, hidden_dim, skip_layer_idx,
                 out_dim=RGB_COLOR_DIM, return_rgb=True, input_feature_embed=None,
                 embed_dim=None, embed_include_input=True, embed_std=1.0,
                 embed_use_logspace=True, embed_max_freq=None, activation="relu",
                 batchnorm=False):
        super().__init__()
        if not (num_layers > 2 and 0 < skip_layer_idx < num_layers - 1):
            raise ValueError(
                f"need num_layers > 2 and 0 < skip_layer_idx < num_layers-1, "
                f"got {num_layers}, {skip_layer_idx}"
            )
        if input_feature_embed == "efuncs":
            input_feature_embed = None
        embedding = _make_encoder(input_feature_embed, embed_dim, embed_include_input, embed_std,
                                 embed_use_logspace, embed_max_freq)
        want = 3 if input_feature_embed == "xyz" else getattr(embedding, "out_dim", in_dim)
        if in_dim != want:
            raise ValueError(f"input {input_feature_embed!r} feeds the MLP {want} columns, "
                             f"got in_dim={in_dim}")
        self.in_dim = in_dim
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        self.skip_layer_idx = skip_layer_idx
        self.out_dim = out_dim
        self.return_rgb = return_rgb
        self.input_feature_embed = input_feature_embed
        self.activation = activation
        self.batchnorm = bool(batchnorm)
        if embedding is not None:
            self.embedding = embedding
        layers = []
        for i in range(num_layers - 1):
            d_in = in_dim if i == 0 else hidden_dim
            if i == skip_layer_idx:
                layers.append(_SkipLayer(hidden_dim, in_dim, activation, batchnorm))
            else:
                mods = [nn.Linear(d_in, hidden_dim), _activation_module(activation)]
                layers.append(nn.Sequential(*mods, *([BatchNorm(hidden_dim)] if batchnorm
                                                     else [])))
        head = nn.Sigmoid() if return_rgb else nn.ReLU()
        layers.append(nn.Sequential(nn.Linear(hidden_dim, out_dim), head))
        self.layers = nn.ModuleList(layers)

    def forward(self, features, train=False):
        """features: [N, in_dim] eigenfunction rows, or [N, 3] positions for
        an encoder family. train: BatchNorm on the batch's statistics."""
        return run_field(self.steps(features), train)

    def steps(self, features):
        """The forward as a generator: yields (BatchNorm, its input rows) at
        each BatchNorm, takes the normalised rows back, returns the output."""
        encode = input_encoder_apply(self)
        x = features if encode is None else encode(features)
        h = x
        for i, layer in enumerate(self.layers):
            if i == self.skip_layer_idx:
                h, bn = layer(h, x), getattr(layer, "batchnorm", None)
            else:
                h, bn = layer[1](layer[0](h)), (layer[2] if len(layer) > 2 else None)
            if bn is not None:
                h = yield bn, h
        return h


def input_encoder_apply(model):
    """The fixed [N, 3] position -> MLP input function of a TextureField
    (the spatial field of a view-dependent one), or None when it takes its
    features as they are (JAX ``input_encoder_apply``). It reads the
    model's current buffers when called."""
    m = getattr(model, "spatial_mlp", model)
    embed = getattr(m, "input_feature_embed", None)
    if embed is None:
        return None
    if embed == "xyz":
        return lambda x: x
    return m.embedding


def mlp_core_view(model):
    """The same TextureField over pre-embedded rows: no encoder, the same
    Linear modules (shared, so one set of parameters serves both; JAX
    ``mlp_core_view``). Feed it input_encoder_apply(model)(positions)."""
    view = TextureField(model.in_dim, model.num_layers, model.hidden_dim,
                        model.skip_layer_idx, out_dim=model.out_dim,
                        return_rgb=model.return_rgb, activation=model.activation,
                        batchnorm=model.batchnorm)
    view.layers = model.layers
    return view


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
    "extrinsic" encodes the unit ray direction itself. The spatial field
    takes `activation` and the input family (``input_feature_embed`` and
    the embed_* keywords of TextureField), as in
    the JAX package; the directional hidden layer takes `activation` too.
    ``batchnorm`` puts BatchNorm into the spatial field only (JAX :229, :267)."""

    def __init__(self, in_dim, num_layers, hidden_dim, skip_layer_idx, bottleneck_vec_dim,
                 in_dim_view_dir, include_view_dir, view_dir_embedding_size,
                 directional_hidden_dim, face_normals=None, view_dir_strategy="intrinsic",
                 activation="relu", batchnorm=False, **embed):
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
        self.activation = activation
        self.batchnorm = bool(batchnorm)
        self.spatial_mlp = TextureField(in_dim, num_layers, hidden_dim, skip_layer_idx,
                                        out_dim=bottleneck_vec_dim, return_rgb=False,
                                        activation=activation, batchnorm=batchnorm,
                                        **embed)
        self.input_feature_embed = self.spatial_mlp.input_feature_embed
        self.directional_mlp = nn.Sequential(
            nn.Linear(bottleneck_vec_dim + self.venc_dim, directional_hidden_dim),
            _activation_module(activation),
            nn.Linear(directional_hidden_dim, RGB_COLOR_DIM), nn.Sigmoid())
        normals = None if face_normals is None else torch.as_tensor(
            np.asarray(face_normals, np.float32))
        self.register_buffer("face_normals", normals, persistent=False)

    def forward(self, features, unit_ray_dirs, hit_face_idxs, train=False):
        return run_field(self.steps(features, unit_ray_dirs, hit_face_idxs), train)

    def steps(self, features, unit_ray_dirs, hit_face_idxs):
        """The forward as a generator (see TextureField.steps)."""
        bottleneck = yield from self.spatial_mlp.steps(features)
        venc = view_encoder_apply(self)(unit_ray_dirs, hit_face_idxs)
        return self.directional_mlp(torch.cat([bottleneck, venc], dim=-1))


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
