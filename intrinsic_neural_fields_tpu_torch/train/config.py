"""YAML config and factories: the reference schema (seed / data.* / model.*
/ training.*), so an experiment config runs unchanged in either package.

Differences from the JAX package's config.py:
  - the optimizer is ``AdamHyper``, Adam with optax's numerics
    (``inject_hyperparams(optax.adam)``): the lr lives in the train state,
    so the plateau scheduler changes it between epochs;
  - ``training.fused_interleave`` is read and ignored: on the TPU it split
    a batch tile into independent chains, which only changes the f32
    summation order;
  - ``training.sorted_gather`` is read and ignored, for the same reason:
    on the TPU it sorted each full-shuffle batch's rows for gather
    locality, which changes only the f32 summation order, and it lost
    there at the widths the configs use (JAX train/steps.py:279-288);
  - ``training.profile_dir`` (with ``profile_epoch``, default 1) writes a
    torch.profiler trace of that epoch where the JAX Trainer writes a
    jax.profiler trace;
  - ``--num_devices`` trains data-parallel in one process over a device
    list (``parallel/``), where the JAX package shard_maps over a mesh.
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


def _make_split_data(config, mesh, split_key, device):
    return create_ray_data(
        config["data"][split_key],
        config["data"].get("eigenfunctions_path"),
        config["model"].get("k"),
        config["model"].get("feature_strategy", "efuncs"),
        mesh=mesh,
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
    """RayData per split on `device` (reference config.py:56-99). The
    xyz / ff / rff strategies take the mesh's vertex positions as their
    table (loaded from data.mesh_path when `mesh` is None)."""
    strategy = config["model"].get("feature_strategy", "efuncs")
    if mesh is None and strategy != "efuncs":
        from ..geometry.mesh import load_mesh

        mesh = load_mesh(config["data"]["mesh_path"])
    data = {
        "train": _make_split_data(config, mesh, "preproc_data_path_train", device),
        "val": _make_split_data(config, mesh, "preproc_data_path_eval", device),
    }
    if "preproc_data_path_test" in config["data"]:
        data["test"] = _make_split_data(config, mesh, "preproc_data_path_test", device)
    return data


def get_model_and_optim(config, mesh=None, device="cuda"):
    """(the configured model seeded from the config seed, AdamHyper at
    training.lr); `mesh` gives the view-dependent field its face normals."""
    model = make_model(config["model"], seed=get_seed(config), device=device, mesh=mesh)
    return model, AdamHyper(learning_rate=config["training"]["lr"])


def get_renderer(config, model, mesh, device="cuda"):
    """The Trainer's vis renderer (JAX train/config.py:137-165): the
    eigenfunction table, or for xyz / ff / rff the mesh's vertices."""
    from ..render.renderer import Renderer

    feature_strategy = config["model"].get("feature_strategy", "efuncs")
    if feature_strategy in ("xyz", "ff", "rff"):
        return Renderer(model, mesh, None, H=config["data"]["img_height"],
                        W=config["data"]["img_width"], device=device)
    if feature_strategy != "efuncs":
        raise ValueError(f"Unknown feature strategy: {feature_strategy}")
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
