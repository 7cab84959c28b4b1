"""Model factory: config dict -> TextureField, or TextureFieldWithViewDependency
when the config has a ``view_dependence`` section (reference model.py:199-258).

Every Linear weight is Xavier-uniform and every bias zero, drawn from a
seeded torch.Generator in module order (the reference package's init; the
two frameworks' random streams differ, so equal seeds do not give equal
weights).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .texture_field import TextureField, TextureFieldWithViewDependency


def in_dim_from_config(model_config):
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
    unsupported = [key for key in ("batchnorm", "type") if model_config.get(key)]
    strategy = model_config.get("feature_strategy", "efuncs")
    if unsupported or strategy != "efuncs" or model_config.get("activation", "relu") != "relu":
        raise NotImplementedError(
            "the port covers the efuncs/relu texture fields only "
            f"(got feature_strategy={strategy!r}, extra keys {unsupported})"
        )
    common = dict(in_dim=in_dim_from_config(model_config),
                  num_layers=model_config["num_layers"],
                  hidden_dim=model_config["mlp_hidden_dim"],
                  skip_layer_idx=model_config["skip_layer_idx"])
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
