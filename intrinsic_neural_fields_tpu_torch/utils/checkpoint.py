"""Checkpoints in the upstream torch layout, written atomically.

  model.pt, model_last_epoch.pt, best_model_checkpoint_<e>.pt
      a raw state dict (Linear weights [out, in]; an RFF field's projection
      as ``embedding.B``, a buffer, so no optimizer state refers to it);
  checkpoint.pt, checkpoint_<e>.pt
      {"epoch", "model_state_dict", "optimizer_state_dict", "rng_key"}, the
      optimizer state in torch.optim.Adam's layout: state[i] = {step,
      exp_avg, exp_avg_sq} per parameter in module order, one param group
      {lr, betas, eps, ...}; rng_key the run's base key (int64 [2], the
      words of utils/jax_random.Key), which the upstream trainer's files
      lack.

The reference package's ``load_reference_train_checkpoint`` reads these
files, and this module reads its exports, so training moves between the
two packages in both directions. Adam's eps_root is not part of torch's
state: the port's optimizer keeps it at 0, as optax.adam does by default.

A NeuTex model's train state holds all its parameters in module order
(train/steps.py:ModuleLayout), so its checkpoint.pt's state[i] follow
``named_parameters()``.

``save_npz_pytree`` / ``load_npz_pytree`` are the JAX package's
template-free format (utils/checkpoint.py:67-96 there): nested dicts of
arrays as an .npz with '/'-joined keys, the pretrained NeuTex mapping's
file in both packages.

The JAX package's own files, flax msgpack (``utils/flax_msgpack.py``), are
read as well: ``model.ckpt`` / ``model_last_epoch.ckpt`` /
``best_model_checkpoint_<e>.ckpt`` hold its variables {params[, buffers][,
batch_stats]}, ``checkpoint.ckpt`` / ``checkpoint_<e>.ckpt`` {epoch, params,
buffers, opt_state, batch_stats, rng_key}. ``load_trained_weights`` tells
the two formats apart by their first bytes, never by the suffix, and
``resolve_weights_path`` finds an out_dir's weights file.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from .flax_msgpack import is_flax_msgpack, load_flax_msgpack
from .jax_random import Key


def _atomic_save(obj, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # readers never see a partial file


def save_model(path, state_dict):
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def _param_names(state_dict):
    # parameters in module order: every tensor ending in .weight/.bias
    return [k for k in state_dict if k.endswith(".weight") or k.endswith(".bias")]


def save_train_checkpoint(path, epoch, state, rng_key=None):
    """`state`: a train/steps.TrainState; `rng_key`: the run's base key
    (a utils/jax_random.Key), stored when given."""
    if state.hyper.eps_root != 0.0:
        raise ValueError("torch's Adam layout cannot hold eps_root != 0")
    sd = state.state_dict("cpu")
    mu, nu = state.layout.state_dict(state.mu, "cpu"), state.layout.state_dict(state.nu, "cpu")
    names = _param_names(sd)
    h = state.hyper
    step = torch.tensor(float(state.count))
    extra = {} if rng_key is None else {
        "rng_key": torch.tensor([rng_key.hi, rng_key.lo], dtype=torch.int64)}
    _atomic_save({
        **extra,
        "epoch": int(epoch),
        "model_state_dict": sd,
        "optimizer_state_dict": {
            "state": {i: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                      for i, name in enumerate(names)},
            "param_groups": [{
                "lr": h.learning_rate, "betas": (h.b1, h.b2), "eps": h.eps,
                "weight_decay": 0, "amsgrad": False, "maximize": False, "foreach": None,
                "capturable": False, "differentiable": False, "fused": None,
                "params": list(range(len(names))),
            }],
        },
    }, path)


def load_train_checkpoint(path):
    """{"epoch", "model_state_dict", "adam": {count, mu, nu, lr, b1, b2,
    eps}, "rng_key"} from a checkpoint.pt of either package (or of the
    upstream torch trainer; its DataParallel ``module.`` prefix is
    stripped). rng_key: the stored utils/jax_random.Key, else None."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "optimizer_state_dict" in obj):
        raise ValueError(f"{path}: not a training checkpoint (no optimizer_state_dict)")
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in obj["model_state_dict"].items()}
    names = _param_names(sd)
    osd = obj["optimizer_state_dict"]
    if len(osd["param_groups"]) != 1:
        raise ValueError(f"{path}: expected one Adam param group")
    group = osd["param_groups"][0]
    if float(group.get("weight_decay", 0.0) or 0.0) != 0.0 or group.get("amsgrad") \
            or group.get("maximize"):
        raise ValueError(f"{path}: only plain Adam (no weight decay, amsgrad, maximize)")
    if len(group["params"]) != len(names):
        raise ValueError(f"{path}: optimizer covers {len(group['params'])} params, "
                         f"the model has {len(names)}")
    mu, nu, steps = {}, {}, set()
    for i, name in zip(group["params"], names):
        st = osd["state"].get(i, osd["state"].get(str(i)))
        if st is None:  # torch creates Adam state lazily: 0 steps taken
            mu[name], nu[name] = torch.zeros_like(sd[name]), torch.zeros_like(sd[name])
            steps.add(0)
            continue
        mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        steps.add(int(st["step"]))
    if len(steps) != 1:
        raise ValueError(f"{path}: per-parameter Adam step counts disagree: {sorted(steps)}")
    b1, b2 = group["betas"]
    key = obj.get("rng_key")
    return {"epoch": int(obj["epoch"]), "model_state_dict": sd,
            "rng_key": None if key is None else Key.of(np.asarray(key)),
            "adam": {"count": steps.pop(), "mu": mu, "nu": nu, "lr": float(group["lr"]),
                     "b1": float(b1), "b2": float(b2), "eps": float(group["eps"])}}


def is_torch_checkpoint(data):
    """torch.save's zip archives start with "PK", its legacy files are
    pickles (0x80, protocol 2-5); a flax msgpack checkpoint starts with a
    map header, which collides with neither (JAX utils/checkpoint.py:61-65)."""
    return data[:2] == b"PK" or (len(data) > 1 and data[0] == 0x80 and data[1] in (2, 3, 4, 5))


def resolve_weights_path(out_dir, weights_name=None):
    """The trained weights of an out_dir: by default the port's
    ``model.pt``, or the JAX package's ``model.ckpt`` when there is no
    ``model.pt``. A file the caller names is that file, present or not: it
    is never swapped for another (JAX utils/checkpoint.py:44-58)."""
    if weights_name is not None:
        return os.path.join(out_dir, weights_name)
    path = os.path.join(out_dir, "model.pt")
    jax_path = os.path.join(out_dir, "model.ckpt")
    if not os.path.exists(path) and os.path.exists(jax_path):
        return jax_path
    return path


def _read(path):
    with open(path, "rb") as f:  # FileNotFoundError for a missing file
        return f.read()


def load_trained_weights(path, model_config):
    """The port's state dict from a weights file of either package: a
    torch state dict or checkpoint (model.pt, checkpoint.pt, or the
    upstream trainer's), or a flax msgpack file of the JAX package (its
    variables or its train checkpoint), mapped by
    ``utils/weights.state_dict_from_flax`` for `model_config`. A file that
    is neither raises ValueError."""
    from .weights import load_reference_weights, state_dict_from_flax

    data = _read(path)
    if is_torch_checkpoint(data):
        return load_reference_weights(io.BytesIO(data))
    if is_flax_msgpack(data):
        return state_dict_from_flax(load_flax_msgpack(data), model_config)
    raise ValueError(f"{path}: neither a torch checkpoint nor a flax msgpack file")


def load_jax_train_checkpoint(path, model_config):
    """``load_train_checkpoint``'s dict {"epoch", "model_state_dict",
    "adam"} from the JAX package's checkpoint.ckpt: its params, buffers
    (RFF's B) and batch_stats as the state dict, its
    ``inject_hyperparams(adam)`` state as the Adam dict (count, moments,
    lr, betas, eps, eps_root), and its ``rng_key`` as a
    utils/jax_random.Key (None when the file has none)."""
    from .weights import adam_state_from_optax, state_dict_from_flax

    data = _read(path)
    if not is_flax_msgpack(data):
        raise ValueError(f"{path}: not a flax msgpack file")
    tree = load_flax_msgpack(data)
    missing = {"epoch", "params", "opt_state"} - set(tree)
    if missing:
        raise ValueError(f"{path}: not a JAX train checkpoint (no {sorted(missing)})")
    key = tree.get("rng_key")
    return {"epoch": int(tree["epoch"]),
            "rng_key": None if key is None else Key.of(key),
            "model_state_dict": state_dict_from_flax(tree, model_config),
            "adam": adam_state_from_optax(tree["opt_state"], model_config)}


def save_npz_pytree(path, tree):
    """Nested dicts of arrays -> an .npz whose keys are the '/'-joined paths."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_npz_pytree(path):
    """Inverse of save_npz_pytree: .npz -> nested dicts of numpy arrays."""
    out = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = out
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = flat[key]
    return out
