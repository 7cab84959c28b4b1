"""Model factory: config dict -> TextureField, or TextureFieldWithViewDependency
when the config has a ``view_dependence`` section, or the NeuTex train
wrapper for ``type: neutex`` (reference model.py:199-258; JAX package
models/factory.py:23-110).

``feature_strategy`` "xyz" / "ff" / "rff" feed the position (raw, or encoded
by the model's own encoder, width from ``k``, ``embed_include_input``,
``embed_std``, ``use_logspace`` and ``max_freq``); anything else is the
intrinsic eigenfunction path. ``activation`` is "relu" or "sine".

The weights are the JAX package's ``init_model(model, config, seed)``, to
the bit: every Linear weight Xavier-uniform from flax's key for its module
path under PRNGKey(seed), every bias zero, RFF's B drawn from
PRNGKey(seed + 1) (within a few ulps: see utils/jax_random.normal), a
BatchNorm's scale one and its statistics (0, 1); ``init_params`` draws
the flax tree from ``utils/jax_random``'s keys and draws, and
``utils/weights.state_dict_from_flax`` maps it onto the module.

``type: neutex`` builds ``models/neutex.NeuTexTrainWrapper`` (num_freqs
from ``k``), initializes it as the JAX package does (Xavier-uniform with
the reference's per-layer gains) and loads ``pretrained_path``'s mapping
networks, which must exist. Any other ``type`` raises.

``batchnorm: true`` puts BatchNorm after every hidden activation
(models/texture_field.py); such a field trains through the eager step, as
in the JAX package (the kernels have no batch statistics).
"""
from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..utils.jax_random import (PRNGKey, flax_key, rff_projection, xavier_uniform,
                                xavier_uniform_gain)
from ..utils.weights import state_dict_from_flax
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
    """Build the configured model with the JAX package's initial weights
    for `seed` on `device` (drawn on the host, so a seed gives the same
    weights on every device). `mesh` supplies the face normals of the
    intrinsic view strategy."""
    dev = resolve_device(device)
    if model_config.get("type") == "neutex":
        from .neutex import load_pretrained_mapping, make_neutex_train_wrapper_default

        model = make_neutex_train_wrapper_default(model_config)
        model.load_state_dict(state_dict_from_flax(init_params(model_config, seed), model_config))
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
                  batchnorm=bool(model_config.get("batchnorm", False)))
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
    model.load_state_dict(state_dict_from_flax(init_params(model_config, seed), model_config))
    return model.to(dev)


# ------------------------------------------- the JAX package's initial variables


def _dense(root, path, fan_in, fan_out, init=xavier_uniform, **kw):
    return {"kernel": init(flax_key(root, *path, 1), fan_in, fan_out, **kw),
            "bias": np.zeros(fan_out, np.float32)}


def _texture_field(root, prefix, in_dim, model_config, out_dim):
    """A TextureField's params and BatchNorm statistics (JAX
    models/texture_field.py:91-118): Dense_{c} in creation order, two at
    the skip layer (Lx on the hidden state, then Ly on the input)."""
    hidden, skip = model_config["mlp_hidden_dim"], model_config["skip_layer_idx"]
    bn = model_config.get("batchnorm", False)
    params, stats, c, h = {}, {}, 0, in_dim
    for i in range(model_config["num_layers"] - 1):
        ins = (h, in_dim) if i == skip else (h,)
        for fan_in in ins:
            params[f"Dense_{c}"] = _dense(root, (*prefix, f"Dense_{c}"), fan_in, hidden)
            c += 1
        h = hidden
        if bn:
            params[f"BatchNorm_{i}"] = {"scale": np.ones(hidden, np.float32),
                                        "bias": np.zeros(hidden, np.float32)}
            stats[f"BatchNorm_{i}"] = {"mean": np.zeros(hidden, np.float32),
                                       "var": np.ones(hidden, np.float32)}
    params[f"Dense_{c}"] = _dense(root, (*prefix, f"Dense_{c}"), hidden, out_dim)
    return params, stats


_LEAKY_GAIN = float(np.sqrt(2.0 / (1.0 + 0.2 ** 2)))


def _mapping_mlp(root, path, fan_in, hidden, out_dim, num_layers=2):
    names = ["linear1", *(f"linear_{i}" for i in range(num_layers)), "last_linear"]
    dims = [fan_in, *([hidden] * (num_layers + 1)), out_dim]
    return {name: _dense(root, (*path, name), a, b, xavier_uniform_gain)
            for name, a, b in zip(names, dims[:-1], dims[1:])}


def neutex_params(root, num_freqs=10, prefix=("neutex",), texture=True):
    """The NeuTex networks' params (JAX models/neutex.py:71-232) under the
    params key `root`: the wrapper's tree at ``prefix`` ("neutex"), or the
    pretraining's (prefix (), texture=False: the two mapping networks)."""
    inv, atlas = "net_inverse_atlasnet_3d_to_uv", "net_atlasnet_uv_to_3d"
    tree = {inv: {"encoder_0": _mapping_mlp(root, (*prefix, inv, "encoder_0"), 3, 128, 4)},
            atlas: {"decoder_0": _mapping_mlp(root, (*prefix, atlas, "decoder_0"), 3, 512, 3)}}
    if texture:
        path = (*prefix, "net_texture", "texture_0")
        dims = [3 * 2 * num_freqs + 3, *([128] * 7), 3]
        tree["net_texture"] = {"texture_0": {
            f"Dense_{j}": _dense(root, (*path, f"Dense_{j}"), a, b, xavier_uniform_gain,
                                 gain=_LEAKY_GAIN if j < 7 else 1.0)
            for j, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}
    return tree


def init_params(model_config, seed=0):
    """The variables the JAX package's ``init_model(make_model(config),
    config, seed)`` returns, as numpy arrays: {"params"[, "buffers"][,
    "batch_stats"]}, init keys PRNGKey(seed) for params and PRNGKey(seed + 1)
    for buffers. A NeuTex model's tree is its fresh init, before
    ``pretrained_path``'s mapping networks replace theirs."""
    root = PRNGKey(seed)
    if model_config.get("type") == "neutex":
        return {"params": {"neutex": neutex_params(root, model_config.get("k", 10))}}
    vd = model_config.get("view_dependence")
    prefix = () if vd is None else ("spatial_mlp",)
    out_dim = 3 if vd is None else vd["bottleneck_vec_dim"]
    params, stats = _texture_field(root, prefix, in_dim_from_config(model_config),
                                   model_config, out_dim)
    buffers = {}
    if model_config.get("feature_strategy") == "rff":
        scope = (*prefix, "RandomFourierFeatEnc_0")
        buffers = {"RandomFourierFeatEnc_0": {"B": rff_projection(
            PRNGKey(seed + 1), model_config["k"], model_config.get("embed_std", 1.0),
            scope=scope)}}
    if vd is not None:
        d = 1 if vd["strategy"] == "intrinsic" else 3
        venc = d * 2 * vd["embed_size"] + (d if vd["include_view_dir"] else 0)
        hid = vd["directional_hidden_dim"]
        params = {"spatial_mlp": params,
                  "Dense_0": _dense(root, ("Dense_0",), vd["bottleneck_vec_dim"] + venc, hid),
                  "Dense_1": _dense(root, ("Dense_1",), hid, 3)}
        stats = {"spatial_mlp": stats} if stats else {}
        buffers = {"spatial_mlp": buffers} if buffers else {}
    out = {"params": params}
    if buffers:
        out["buffers"] = buffers
    if stats:
        out["batch_stats"] = stats
    return out
