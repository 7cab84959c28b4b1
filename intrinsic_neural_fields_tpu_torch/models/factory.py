"""Model factory: config dict -> TextureField, or TextureFieldWithViewDependency
when the config has a ``view_dependence`` section, or the NeuTex train
wrapper for ``type: neutex`` (reference model.py:199-258; JAX package
models/factory.py:23-110).

``feature_strategy`` "xyz" / "ff" / "rff" feed the position (raw, or encoded
by the model's own encoder, width from ``k``, ``embed_include_input``,
``embed_std``, ``use_logspace`` and ``max_freq``); anything else is the
intrinsic eigenfunction path. ``activation`` is "relu" or "sine".

Every Linear weight is Xavier-uniform and every bias zero, drawn from a
seeded torch.Generator in module order (the reference package's init; the
two frameworks' random streams differ, so equal seeds do not give equal
weights); RFF's B is drawn from a second generator seeded seed + 1, as the
JAX package draws its buffers from PRNGKey(seed + 1).

``type: neutex`` builds ``models/neutex.NeuTexTrainWrapper`` (num_freqs
from ``k``), initializes it from the seeded generator (Xavier-uniform with
the reference's per-layer gains) and loads ``pretrained_path``'s mapping
networks, which must exist. Any other ``type`` raises.

``batchnorm: true`` puts BatchNorm after every hidden activation
(models/texture_field.py); such a field trains through the eager step, as
in the JAX package (the kernels have no batch statistics).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .encoders import fourier_feat_dim
from .texture_field import ENCODER_FAMILIES, TextureField, TextureFieldWithViewDependency


def in_dim_from_config(model_config):
    """The MLP's input width: 3 for xyz, the encoder's width for ff / rff,
    hks_timesteps when configured, else k (or len(k) for an index list)."""
    strategy = model_config.get("feature_strategy", "efuncs")
    include = model_config.get("embed_include_input", True)
    if strategy == "xyz":
        return 3
    if strategy == "ff":
        return fourier_feat_dim(3, model_config["k"], include)
    if strategy == "rff":
        return 2 * model_config["k"] + (3 if include else 0)
    if "hks_timesteps" in model_config:
        return model_config["hks_timesteps"]
    k = model_config["k"]
    return len(k) if isinstance(k, list) else int(k)


def make_model(model_config, seed=0, device="cuda", mesh=None):
    """Build the configured model with seeded Xavier-uniform weights on
    `device` (drawn on the CPU, so a seed gives the same weights on every
    device). `mesh` supplies the face normals of the intrinsic view
    strategy."""
    dev = resolve_device(device)
    if model_config.get("type") == "neutex":
        from .neutex import (init_neutex_weights, load_pretrained_mapping,
                             make_neutex_train_wrapper_default)

        model = make_neutex_train_wrapper_default(model_config)
        init_neutex_weights(model, torch.Generator().manual_seed(seed))
        load_pretrained_mapping(model, model_config["pretrained_path"])
        return model.to(dev)
    if model_config.get("type"):
        raise NotImplementedError(f"model type {model_config['type']!r} is not ported")
    strategy = model_config.get("feature_strategy", "efuncs")
    activation = model_config.get("activation", "relu")
    if activation not in ("relu", "sine"):
        raise NotImplementedError(f"Activation function {activation} not implemented.")
    common = dict(in_dim=in_dim_from_config(model_config),
                  num_layers=model_config["num_layers"],
                  hidden_dim=model_config["mlp_hidden_dim"],
                  skip_layer_idx=model_config["skip_layer_idx"],
                  input_feature_embed=strategy if strategy in ENCODER_FAMILIES else None,
                  embed_dim=model_config.get("k"),
                  embed_include_input=model_config.get("embed_include_input", True),
                  embed_std=model_config.get("embed_std", 1.0),
                  embed_use_logspace=model_config.get("use_logspace", True),
                  embed_max_freq=model_config.get("max_freq"),
                  activation=activation,
                  batchnorm=bool(model_config.get("batchnorm", False)),
                  generator=torch.Generator().manual_seed(seed + 1))
    vd = model_config.get("view_dependence")
    if vd is None:
        model = TextureField(**common)
    else:
        if vd["strategy"] == "intrinsic" and mesh is None:
            raise ValueError("a view-dependent model with the intrinsic strategy needs the mesh")
        model = TextureFieldWithViewDependency(
            bottleneck_vec_dim=vd["bottleneck_vec_dim"], in_dim_view_dir=vd["in_dim_view_dir"],
            include_view_dir=vd["include_view_dir"], view_dir_embedding_size=vd["embed_size"],
            directional_hidden_dim=vd["directional_hidden_dim"],
            face_normals=None if mesh is None else np.asarray(mesh.face_normals, np.float32),
            view_dir_strategy=vd["strategy"], **common)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                fan_out, fan_in = mod.weight.shape
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                mod.weight.uniform_(-bound, bound, generator=g)
                mod.bias.zero_()
    return model.to(dev)
