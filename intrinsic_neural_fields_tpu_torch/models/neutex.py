"""NeuTex baseline as torch modules (JAX package models/neutex.py:45-402):
an AtlasNet sphere-primitive neural texture.

Architecture (primitive_type "sphere", primitive_count 1, the only
released configuration):

  - InverseAtlasnet (3D -> uv): one MLP 3 -> 128 -> 128 -> 128 -> 4 (relu)
    per primitive; the first 3 outputs are L2-normalized onto the unit
    sphere (the norm clamped at 1e-12), the last is the primitive logit,
    softmaxed into mixture weights;
  - Atlasnet (uv -> 3D): one MLP 3 -> 512 -> 512 -> 512 -> 3 (relu or
    softplus) per primitive;
  - TextureMlpMix: per primitive FourierFeatEnc(uv) ([cos | sin | uv],
    3 + 2 * 3 * num_freqs wide) -> Linear(width) -> LeakyReLU(0.2) ->
    num_layers x [Linear(width), LeakyReLU(0.2)] -> Linear(3) -> sigmoid,
    mixed by the inverse mapping's weights;
  - the train loss (``NeuTexTrainWrapper.loss_and_rgbs``) is the color MSE
    plus the inverse-mapping cycle loss
    mean_N sum_p w_p ||xyz - Atlasnet(InverseAtlasnet(xyz))_p||^2.

State-dict keys. The wrapper holds the model as ``neutex``; its three
networks keep the JAX module names (``net_inverse_atlasnet_3d_to_uv``,
``net_atlasnet_uv_to_3d``, ``net_texture``). Inside the mapping networks
the keys are the reference torch checkpoint's, the ones the JAX package's
``_convert_torch_mapping_state`` reads:

  net_inverse_atlasnet_3d_to_uv.encoders.{i}.linear1 | .linear_list.{j} | .last_linear
  net_atlasnet_uv_to_3d.decoder.{i}.linear1 | .linear_list.{j} | .last_linear

(flax: encoder_{i} / decoder_{i} with linear1, linear_{j}, last_linear).
The texture network's keys are this package's own, chosen plainly (the
upstream torch names are not in the repository):

  net_texture.textures.{i}.dense.{j}   flax net_texture/texture_{i}/Dense_{j}

where dense.0 takes the encoding, dense.1 .. dense.{num_layers} are the
hidden layers and dense.{num_layers + 1} is the RGB head. Linear weights
are [out, in], the transpose of a flax kernel.

Initialization: the JAX package's, drawn to its bits by
``utils/jax_random.neutex_params`` (``models/factory.make_model``):
Xavier-uniform, gain 1 except the texture layers a LeakyReLU follows (gain
sqrt(2 / (1 + 0.2^2))), zero biases, each kernel from flax's key for its
module path. The mapping networks are then overwritten by the pretrained
mapping (``load_pretrained_mapping``) and keep training.

Numerics: f32 throughout; the package keeps TF32 off (the mapping is
geometry), and ``chamfer_distance`` is the JAX package's matmul expansion
in f32.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.jax_random import normal
from .encoders import FourierFeatEnc

_LEAKY_SLOPE = 0.2
MAPPING_NETS = ("net_inverse_atlasnet_3d_to_uv", "net_atlasnet_uv_to_3d")


class MappingMLP(nn.Module):
    """linear1 -> num_layers x linear -> last_linear with relu / softplus
    between them."""

    def __init__(self, in_dim, out_dim, hidden_size=128, num_layers=2, activation="relu"):
        super().__init__()
        if activation not in ("relu", "softplus"):
            raise ValueError(f"unknown mapping activation {activation!r}")
        self.activation = activation
        self.linear1 = nn.Linear(in_dim, hidden_size)
        self.linear_list = nn.ModuleList(
            nn.Linear(hidden_size, hidden_size) for _ in range(num_layers))
        self.last_linear = nn.Linear(hidden_size, out_dim)

    def forward(self, x):
        act = torch.relu if self.activation == "relu" else F.softplus
        h = act(self.linear1(x))
        for lin in self.linear_list:
            h = act(lin(h))
        return self.last_linear(h)


class InverseAtlasnet(nn.Module):
    """3D points [..., 3] -> (uv [..., P, 3] on the unit sphere, mixture
    weights [..., P], logits [..., P]) for P sphere primitives."""

    def __init__(self, num_primitives=1):
        super().__init__()
        self.encoders = nn.ModuleList(
            MappingMLP(3, 4, hidden_size=128, num_layers=2) for _ in range(num_primitives))

    def forward(self, points):
        out = torch.stack([enc(points) for enc in self.encoders], dim=-2)
        raw_uv = out[..., :-1]
        uv = raw_uv / torch.clamp(torch.sqrt((raw_uv * raw_uv).sum(-1, keepdim=True)), min=1e-12)
        logits = out[..., -1]
        return uv, torch.softmax(logits, dim=-1), logits


class Atlasnet(nn.Module):
    """Sphere points [..., P, 3] -> 3D surface points [..., P, 3], one
    512-wide decoder per primitive."""

    def __init__(self, num_primitives=1, activation="relu"):
        super().__init__()
        self.decoder = nn.ModuleList(
            MappingMLP(3, 3, hidden_size=512, num_layers=2, activation=activation)
            for _ in range(num_primitives))

    def forward(self, uvs):
        return torch.stack([dec(uvs[..., i, :]) for i, dec in enumerate(self.decoder)], dim=-2)


class TextureMlp(nn.Module):
    """Sphere texture: FourierFeatEnc(uv) -> LeakyReLU(0.2) MLP -> sigmoid RGB."""

    def __init__(self, num_freqs, num_layers=6, width=128, use_logspace=True, max_freq=None):
        super().__init__()
        self.enc = FourierFeatEnc(num_freqs, include_input=True, use_logspace=use_logspace,
                                  max_freq=max_freq, in_dim=3)
        dims = [self.enc.out_dim] + [width] * (num_layers + 1)
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
            + [nn.Linear(width, 3)])

    def forward(self, uv):
        h = self.enc(uv)
        for lin in self.dense[:-1]:
            h = F.leaky_relu(lin(h), _LEAKY_SLOPE)
        return torch.sigmoid(self.dense[-1](h))


class TextureMlpMix(nn.Module):
    def __init__(self, num_primitives, num_freqs, num_layers=6, width=128, use_logspace=True,
                 max_freq=None):
        super().__init__()
        self.textures = nn.ModuleList(
            TextureMlp(num_freqs, num_layers, width, use_logspace, max_freq)
            for _ in range(num_primitives))

    def forward(self, uvs, weights):
        values = torch.stack([tex(uvs[..., i, :]) for i, tex in enumerate(self.textures)],
                             dim=-2)
        return (values * weights[..., None]).sum(-2)


class NeuTex(nn.Module):
    def __init__(self, primitive_count=1, primitive_type="sphere", texture_num_layers=6,
                 texture_decoder_width=128, atlasnet_activation="relu", num_freqs=10,
                 use_logspace=True, max_freq=None):
        super().__init__()
        if primitive_type != "sphere" or primitive_count != 1:
            raise NotImplementedError("NeuTex is released (and ported) for one sphere "
                                      "primitive only")
        self.net_inverse_atlasnet_3d_to_uv = InverseAtlasnet(primitive_count)
        self.net_atlasnet_uv_to_3d = Atlasnet(primitive_count, atlasnet_activation)
        self.net_texture = TextureMlpMix(primitive_count, num_freqs, texture_num_layers,
                                         texture_decoder_width, use_logspace, max_freq)

    def forward(self, points_3d, compute_inverse_mapping=True):
        uv, weights, _ = self.net_inverse_atlasnet_3d_to_uv(points_3d)
        output = {"points_original": points_3d, "rgbs": self.net_texture(uv, weights)}
        if compute_inverse_mapping:
            output["points_inverse"] = self.net_atlasnet_uv_to_3d(uv)
            output["points_inverse_primitive_weights"] = weights
        return output


class NeuTexTrainWrapper(nn.Module):
    """The NeuTex model with its composite train loss (color MSE weight 1,
    inverse-mapping weight 1). It reads the hit position
    (``input_feature_embed`` "xyz": the renderer and the bake feed it the
    interpolated vertex positions) and computes its own loss
    (``computes_loss``: train/steps.py trains it through ``loss_and_rgbs``)."""

    computes_loss = True
    input_feature_embed = "xyz"

    def __init__(self, num_freqs=10, use_logspace=True, max_freq=None, **opt):
        super().__init__()
        self.neutex = NeuTex(num_freqs=num_freqs, use_logspace=use_logspace,
                             max_freq=max_freq, **opt)

    def forward(self, xyz, expected_rgbs=None):
        """The RGB [N, 3] of positions xyz [N, 3]; with expected_rgbs,
        ``loss_and_rgbs`` (so torch.func.functional_call reaches it)."""
        if expected_rgbs is not None:
            return self.loss_and_rgbs(xyz, expected_rgbs)
        return self.neutex(xyz, compute_inverse_mapping=False)["rgbs"]

    def loss_and_rgbs(self, xyz, expected_rgbs):
        """(color MSE + inverse-mapping loss, RGB [N, 3])."""
        output = self.neutex(xyz, compute_inverse_mapping=True)
        loss_color = ((output["rgbs"] - expected_rgbs) ** 2).mean()
        gt_points = output["points_original"]
        dist = ((gt_points[..., None, :] - output["points_inverse"]) ** 2).sum(-1)
        loss_inverse = (dist * output["points_inverse_primitive_weights"]).sum(-1).mean()
        return loss_color + loss_inverse, output["rgbs"]


def make_neutex_train_wrapper_default(model_config):
    """The reference factory's semantics: num_freqs from model.k (default
    10), use_logspace and max_freq from the config; the pretrained mapping
    (model.pretrained_path) is required and must exist."""
    path = model_config.get("pretrained_path")
    if not path:
        raise ValueError("a NeuTex model needs model.pretrained_path (the pretrained sphere "
                         "mapping, e.g. pretrained/blob_pretrained_neutex_mapping.npz)")
    if not os.path.exists(path):
        raise FileNotFoundError(f"NeuTex pretrained mapping {path!r} does not exist")
    return NeuTexTrainWrapper(num_freqs=model_config.get("k", 10),
                              use_logspace=model_config.get("use_logspace", True),
                              max_freq=model_config.get("max_freq"))


# --------------------------------------------------------------------------
# Pretrained mapping weights
# --------------------------------------------------------------------------

def _flax_mlp_sd(tree, prefix):
    """{linear1, linear_{j}, last_linear: {kernel, bias}} -> torch keys."""
    sd = {}
    for name, p in tree.items():
        if name.startswith("linear_") and name[len("linear_"):].isdigit():
            torch_name = f"linear_list.{name[len('linear_'):]}"
        elif name in ("linear1", "last_linear"):
            torch_name = name
        else:
            raise ValueError(f"unexpected mapping layer {prefix}{name!r}")
        sd[f"{prefix}{torch_name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel"], np.float32).T))
        sd[f"{prefix}{torch_name}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return sd


def mapping_state_dicts_from_flax(inverse, atlas):
    """Flax param subtrees of the two mapping networks ({encoder_{i}: ...},
    {decoder_{i}: ...}) -> their torch state dicts (reference keys)."""
    def convert(tree, flax_prefix, torch_prefix):
        sd = {}
        for name, sub in tree.items():
            if not (name.startswith(flax_prefix) and name[len(flax_prefix):].isdigit()):
                raise ValueError(f"unexpected mapping module {name!r}")
            sd.update(_flax_mlp_sd(sub, f"{torch_prefix}.{name[len(flax_prefix):]}."))
        return sd

    return convert(inverse, "encoder_", "encoders"), convert(atlas, "decoder_", "decoder")


def mapping_tree_from_module(net):
    """A mapping network (InverseAtlasnet or Atlasnet) -> its flax param
    subtree of numpy arrays, as ``save_npz_pytree`` writes it."""
    flax_prefix = "encoder_" if isinstance(net, InverseAtlasnet) else "decoder_"
    tree = {}
    for i, mlp in enumerate(net.encoders if isinstance(net, InverseAtlasnet) else net.decoder):
        layers = {"linear1": mlp.linear1, "last_linear": mlp.last_linear,
                  **{f"linear_{j}": lin for j, lin in enumerate(mlp.linear_list)}}
        tree[f"{flax_prefix}{i}"] = {
            name: {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
                   "bias": lin.bias.detach().cpu().numpy().copy()}
            for name, lin in layers.items()}
    return tree


@torch.no_grad()
def load_pretrained_mapping(model, pretrained_path):
    """Overwrite the two mapping networks of `model` (a NeuTexTrainWrapper
    or NeuTex) with a pretrained mapping: this framework's .npz
    (``save_npz_pytree``'s '/'-joined flax keys, as tools/ and
    ``pretrain_neutex_mapping`` write them) or the reference's torch .pt
    ({net_inverse_atlasnet_3d_to_uv, net_atlasnet_uv_to_3d} state dicts,
    read with weights_only=True). Every tensor of both networks must be
    given at its shape."""
    from ..utils.checkpoint import load_npz_pytree

    root = getattr(model, "neutex", model)
    if pretrained_path.endswith(".pt"):
        state = torch.load(pretrained_path, map_location="cpu", weights_only=True)
        sds = [{k: torch.as_tensor(v, dtype=torch.float32) for k, v in state[net].items()}
               for net in MAPPING_NETS]
    else:
        loaded = load_npz_pytree(pretrained_path)
        sds = mapping_state_dicts_from_flax(*(loaded[net] for net in MAPPING_NETS))
    for net, sd in zip(MAPPING_NETS, sds):
        module = getattr(root, net)
        have = module.state_dict()
        if set(sd) != set(have):
            raise ValueError(f"{pretrained_path}: {net} holds {sorted(set(sd) ^ set(have))} "
                             "where the model's keys differ")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(have[k].shape):
                raise ValueError(f"{pretrained_path}: {net}.{k} has shape {tuple(v.shape)}, "
                                 f"the model {tuple(have[k].shape)}")
        module.load_state_dict(sd)
    return model


def sample_sphere_points(key, n, device="cpu"):
    """n uniform points on S^2 [n, 3] on `device`: JAX's
    ``normal(key, (n, 3))`` (utils/jax_random.py), normalized
    (pretraining's template sampling, JAX models/neutex.py:369-374)."""
    p = normal(key, (n, 3), device=torch.device(device))
    return p / torch.sqrt((p * p).sum(-1, keepdim=True))


def chamfer_distance(a, b, chunk=4096):
    """Symmetric mean chamfer between point sets a [N, 3] and b [M, 3] in
    f32, in column chunks so the N x M distance matrix never
    materializes: |x|^2 - 2 x.y + |y|^2, the last chunk padded with a
    distant finite sentinel (1e6: inf would give inf * 0 = NaN inside the
    product), each nearest distance clamped at 0."""
    def one_sided(x, y):
        M = y.shape[0]
        n_chunks = -(-M // chunk)
        pad = n_chunks * chunk - M
        y_p = torch.cat([y, torch.full((pad, 3), 1e6, dtype=y.dtype, device=y.device)])
        xx = (x * x).sum(-1, keepdim=True)
        best = None
        for yc in y_p.view(n_chunks, chunk, 3):
            d = xx - 2.0 * (x @ yc.T) + (yc * yc).sum(-1)[None, :]
            dmin = d.min(dim=1).values
            best = dmin if best is None else torch.minimum(best, dmin)
        return torch.clamp(best, min=0.0).mean()

    return one_sided(a, b) + one_sided(b, a)
