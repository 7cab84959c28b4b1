"""The weight carry between the JAX package and the port.

Weights cross in the upstream torch layout (``layers.{i}.0.*``,
``layers.{skip}.Lx/.Ly``, and ``spatial_mlp.*`` + ``directional_mlp.{0,2}.*``
for the view-dependent field; Linear weights [out, in]).
``state_dict_from_flax`` maps a flax variables tree (numpy leaves) onto the
port's state dict and ``adam_state_from_optax`` the optimizer state with
it. Both read the JAX package's own files as ``utils/flax_msgpack.py``
decodes them (``utils/checkpoint.load_trained_weights``,
``load_jax_train_checkpoint``), so a JAX-trained out_dir needs no export;
``load_reference_weights`` reads a torch ``model.pt``, the port's own or
the JAX package's export (``tools/export_reference_checkpoint.py``), which
carries weights the other way, to the upstream torch code.

A NeuTex model (``type: neutex``) crosses under ``neutex.`` in the keys of
``models/neutex.py``: its mapping networks in the reference torch names,
its texture network's ``Dense_{j}`` as ``textures.{i}.dense.{j}``.
"""
from __future__ import annotations

import numpy as np
import torch


def _np32(a):
    """An f32 numpy copy of a leaf: a numpy array or scalar, or the torch
    bfloat16 tensor utils/flax_msgpack.py gives for a bfloat16 leaf."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(a, np.float32)


def _dense(p):
    """A flax Dense's (weight [out, in], bias) as f32 tensors."""
    return (torch.from_numpy(np.ascontiguousarray(_np32(p["kernel"]).T)),
            torch.from_numpy(_np32(p["bias"])))


def _texture_field_sd(params, model_config, prefix="", batch_stats=None):
    """Flax TextureField params -> {prefix + upstream key: f32 tensor}.
    Dense modules are numbered in creation order: one per layer, two at the
    skip layer (the h-projection Lx, then the input projection Ly). With
    ``batchnorm``, BatchNorm_{i} (scale, bias; and from ``batch_stats`` its
    mean and var, num_batches_tracked written as 0 as the JAX exporter does)
    goes to layers.{i}.2 (layers.{skip}.batchnorm at the skip layer)."""
    num_layers = model_config["num_layers"]
    skip = model_config["skip_layer_idx"]
    batchnorm = model_config.get("batchnorm", False)
    sd = {}
    f32 = lambda a: torch.from_numpy(_np32(a))  # noqa: E731

    def put(torch_prefix, flax_name):
        sd[prefix + torch_prefix + ".weight"], sd[prefix + torch_prefix + ".bias"] = _dense(
            params[flax_name])

    def put_bn(torch_prefix, flax_name):
        key = prefix + torch_prefix
        sd[key + ".weight"] = f32(params[flax_name]["scale"])
        sd[key + ".bias"] = f32(params[flax_name]["bias"])
        if batch_stats is not None:
            sd[key + ".running_mean"] = f32(batch_stats[flax_name]["mean"])
            sd[key + ".running_var"] = f32(batch_stats[flax_name]["var"])
            sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    c = 0
    for i in range(num_layers):
        if i == skip:
            put(f"layers.{i}.Lx", f"Dense_{c}")
            put(f"layers.{i}.Ly", f"Dense_{c + 1}")
            c += 2
            if batchnorm:
                put_bn(f"layers.{i}.batchnorm", f"BatchNorm_{i}")
        else:
            put(f"layers.{i}.0", f"Dense_{c}")
            c += 1
            if batchnorm and i < num_layers - 1:
                put_bn(f"layers.{i}.2", f"BatchNorm_{i}")
    expected = {f"Dense_{j}" for j in range(c)}
    if batchnorm:
        expected |= {f"BatchNorm_{i}" for i in range(num_layers - 1)}
    if set(params) != expected:
        raise ValueError(
            f"flax params {sorted(params)} do not match the config's layers "
            f"{sorted(expected)}"
        )
    return sd


def _rff_buffer_sd(buffers, prefix):
    """{prefix + "embedding.B": B} from a flax "buffers" collection holding
    RandomFourierFeatEnc_0/B (JAX utils/torch_convert.py:117-118), else {}."""
    rff = buffers.get("RandomFourierFeatEnc_0") if buffers else None
    if rff is None:
        return {}
    return {prefix + "embedding.B": torch.from_numpy(_np32(rff["B"]))}


def _neutex_sd(params):
    """Flax NeuTexTrainWrapper params ({"neutex": {net_inverse_atlasnet_3d_to_uv,
    net_atlasnet_uv_to_3d, net_texture}}) -> the port's state dict."""
    from ..models.neutex import mapping_state_dicts_from_flax

    root = params.get("neutex", params)
    nets = ("net_inverse_atlasnet_3d_to_uv", "net_atlasnet_uv_to_3d", "net_texture")
    if set(root) != set(nets):
        raise ValueError(f"flax params {sorted(root)} are not a NeuTex model's")
    inverse, atlas = mapping_state_dicts_from_flax(root[nets[0]], root[nets[1]])
    sd = {f"neutex.{nets[0]}.{k}": v for k, v in inverse.items()}
    sd.update({f"neutex.{nets[1]}.{k}": v for k, v in atlas.items()})
    for tex, dense in root[nets[2]].items():
        i = tex[len("texture_"):]
        for name, p in dense.items():
            j = name[len("Dense_"):]
            if not (tex.startswith("texture_") and name.startswith("Dense_") and i.isdigit()
                    and j.isdigit()):
                raise ValueError(f"unexpected texture module {tex}/{name}")
            key = f"neutex.{nets[2]}.textures.{i}.dense.{j}"
            sd[key + ".weight"], sd[key + ".bias"] = _dense(p)
    return sd


def state_dict_from_flax(params, model_config):
    """Flax TextureField[WithViewDependency] params (nested dicts of numpy
    arrays: Dense_{c} with kernel [in, out] and bias, BatchNorm_{i} with
    scale and bias), or the whole variables dict {"params", "buffers",
    "batch_stats"} -> the port's state dict (f32 tensors; a BatchNorm's
    running statistics come from "batch_stats"). The view-dependent tree
    is {"spatial_mlp": {...}, "Dense_0", "Dense_1"}: the spatial field under ``spatial_mlp.`` and the directional
    Linears as ``directional_mlp.0`` and ``directional_mlp.2`` (the JAX
    package's export_reference_state_dict). An RFF field's projection,
    ``buffers/RandomFourierFeatEnc_0/B``, goes to ``embedding.B``
    (``spatial_mlp.embedding.B`` for a view-dependent field). A NeuTex
    model's tree (``type: neutex``) maps to ``models/neutex.py``'s keys."""
    if model_config.get("type") == "neutex":
        return _neutex_sd(params.get("params", params))
    whole = "params" in params
    buffers = params.get("buffers", {}) if whole else {}
    stats = (params.get("batch_stats") or None) if whole else None  # a checkpoint's {}
    params = params.get("params", params)
    if model_config.get("view_dependence") is None:
        return {**_rff_buffer_sd(buffers, ""),
                **_texture_field_sd(params, model_config, batch_stats=stats)}
    if set(params) != {"spatial_mlp", "Dense_0", "Dense_1"}:
        raise ValueError(f"flax params {sorted(params)} are not a view-dependent field's")
    sd = _rff_buffer_sd(buffers.get("spatial_mlp", {}), "spatial_mlp.")
    sd.update(_texture_field_sd(params["spatial_mlp"], model_config, prefix="spatial_mlp.",
                                batch_stats=None if stats is None else stats["spatial_mlp"]))
    for c, name in enumerate(("directional_mlp.0", "directional_mlp.2")):
        sd[name + ".weight"], sd[name + ".bias"] = _dense(params[f"Dense_{c}"])
    return sd


def load_reference_weights(path):
    """State dict (name -> f32 tensor) from a reference-layout model.pt.

    Accepts a raw state_dict or a ``{"model_state_dict": ...}`` checkpoint
    and strips torch.nn.DataParallel's ``module.`` prefix. Loads with
    ``weights_only=True``: a file that needs arbitrary unpickling is refused."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {
        (k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
        for k, v in obj.items()
    }


def adam_state_from_optax(opt_state, model_config):
    """An ``optax.inject_hyperparams(optax.adam)`` state -> the port's Adam
    dict {count, mu, nu (state dicts in the upstream torch layout), lr, b1,
    b2, eps, eps_root} that ``train.steps.TrainState.from_torch`` takes.
    The state is the optax object converted to numpy (``jax.device_get``)
    or the dict a flax msgpack file decodes to ({count, hyperparams,
    hyperparams_states, inner_state: {"0": {count, mu, nu}, "1": {}}}).
    Read by structure: the hyperparams dict and the ScaleByAdamState (mu,
    nu, count) first in the inner state. The moments mirror the params
    tree, a BatchNorm's scale and bias included."""
    if isinstance(opt_state, dict):
        hp = opt_state.get("hyperparams")
        adam = (opt_state.get("inner_state") or {}).get("0")
        if not (isinstance(hp, dict) and isinstance(adam, dict)
                and set(adam) == {"count", "mu", "nu"}):
            raise ValueError("not an inject_hyperparams(adam) state: "
                             f"{sorted(opt_state)}, inner state {adam and sorted(adam)}")
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
    else:
        hp, adam = dict(opt_state.hyperparams), opt_state.inner_state[0]
        count, mu, nu = adam.count, adam.mu, adam.nu
    return {
        "count": int(np.asarray(count)),
        "mu": state_dict_from_flax(mu, model_config),
        "nu": state_dict_from_flax(nu, model_config),
        **{ours: float(np.asarray(hp[theirs])) for ours, theirs in (
            ("lr", "learning_rate"), ("b1", "b1"), ("b2", "b2"), ("eps", "eps"),
            ("eps_root", "eps_root"))},
    }
