"""YAML config and factories: the reference schema (seed / data.* / model.*
/ training.*), so an experiment config runs unchanged in either package.

Differences from the JAX package's config.py:
  - the optimizer is ``AdamHyper``, Adam with optax's numerics
    (``inject_hyperparams(optax.adam)``): the lr lives in the train state,
    so the plateau scheduler changes it between epochs;
  - ``training.fused_interleave`` is read and ignored: on the TPU it split
    a batch tile into independent chains, which only changes the f32
    summation order;
  - ``training.sorted_gather: true`` and ``training.profile_dir`` raise
    NotImplementedError (not ported yet);
  - there is no ``--num_devices``: one GPU.
"""
from __future__ import annotations

import os
from shutil import copyfile

import yaml

from ..data.sampler import create_ray_data
from ..models.factory import make_model
from ..spectral.features import load_first_k_eigenfunctions
from .steps import AdamHyper


def _pretty_print_config(config, path):
    print("----------------------------------------------------------------")
    print(f"Loaded Config from {path}")
    print("================================================================")
    print(yaml.dump(config, default_flow_style=False))
    print("================================================================\n")


def _normalize_k(config):
    """Expand ``k: {ranges: [[a, b], ...]}`` (half-open) into the index list."""
    k = config.get("model", {}).get("k")
    if isinstance(k, dict) and "ranges" in k:
        config["model"]["k"] = [i for a, b in k["ranges"] for i in range(a, b)]
    return config


def load_config_file(path, allow_checkpoint_loading=False):
    """Load a config, refuse to reuse an existing out_dir unless resuming,
    and copy the config into out_dir (reference config.py:26-36)."""
    with open(path, "r") as f:
        config = _normalize_k(yaml.safe_load(f))
    out_dir = config["training"]["out_dir"]
    if os.path.exists(out_dir) and not allow_checkpoint_loading:
        raise RuntimeError(f"out_dir '{out_dir}' exists. Exit to not overwrite old results.")
    _pretty_print_config(config, path)
    os.makedirs(out_dir, exist_ok=True)
    dst = os.path.join(out_dir, "config.yaml")
    if os.path.abspath(path) != os.path.abspath(dst):
        copyfile(path, dst)
    return config


def load_config(path):
    with open(path, "r") as f:
        return _normalize_k(yaml.safe_load(f))


def get_seed(config):
    return config.get("seed", 0)


def check_training_config(config):
    """Raise on training options the port does not have yet."""
    training = config["training"]
    if training.get("sorted_gather", False):
        raise NotImplementedError("training.sorted_gather is not ported yet")
    if training.get("profile_dir") is not None:
        raise NotImplementedError("training.profile_dir is not ported yet")
    # training.fused_interleave: a TPU schedule knob, ignored (see above)


def _make_split_data(config, split_key, device):
    return create_ray_data(
        config["data"][split_key],
        config["data"].get("eigenfunctions_path"),
        config["model"].get("k"),
        config["model"].get("feature_strategy", "efuncs"),
        rescale_strategy=config["data"].get("rescale_strategy", "standard"),
        embed_strategy=config["data"].get("embed_strategy"),
        eigenvalues_path=config["data"].get("eigenvalues_path"),
        hks_timesteps=config["model"].get("hks_timesteps", 128),
        precompute=config["data"].get("precompute_hit_features", "auto"),
        precompute_dtype=config["data"].get("precompute_dtype"),
        seed=get_seed(config),
        device=device,
    )


def get_data(config, mesh=None, device="cuda"):
    """RayData per split on `device` (reference config.py:56-99); `mesh`
    is unused by the efuncs strategy and kept for the reference signature."""
    data = {
        "train": _make_split_data(config, "preproc_data_path_train", device),
        "val": _make_split_data(config, "preproc_data_path_eval", device),
    }
    if "preproc_data_path_test" in config["data"]:
        data["test"] = _make_split_data(config, "preproc_data_path_test", device)
    return data


def get_model_and_optim(config, mesh=None, device="cuda"):
    """(the configured model seeded from the config seed, AdamHyper at
    training.lr); `mesh` gives the view-dependent field its face normals."""
    model = make_model(config["model"], seed=get_seed(config), device=device, mesh=mesh)
    return model, AdamHyper(learning_rate=config["training"]["lr"])


def get_renderer(config, model, mesh, device="cuda"):
    from ..render.renderer import Renderer

    feature_strategy = config["model"].get("feature_strategy", "efuncs")
    if feature_strategy != "efuncs":
        raise NotImplementedError(f"feature_strategy {feature_strategy!r} is not ported yet")
    E = load_first_k_eigenfunctions(
        config["data"]["eigenfunctions_path"],
        config["model"]["k"],
        rescale_strategy=config["data"].get("rescale_strategy", "standard"),
        embed_strategy=config["data"].get("embed_strategy"),
        eigenvalues_path=config["data"].get("eigenvalues_path"),
        ts=config["model"].get("hks_timesteps", 128),
    )
    # The vis renders use an f32 feature table whatever the training table's
    # dtype, as the reference Trainer's renderer does.
    return Renderer(model, mesh, E, H=config["data"]["img_height"],
                    W=config["data"]["img_width"], device=device)
