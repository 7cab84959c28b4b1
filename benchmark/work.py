"""The work of a train step and of a frame, counted from a configuration's
shapes, and the card's peaks: the yardstick of the roofline and mfu
metrics. Nothing here depends on how the program splits the work into
kernels.

A texture field is a chain of Linear layers (the intrinsic field of the
paper, reference model.py): an input layer on the k eigenfunction
features, hidden layers of `mlp_hidden_dim`, a skip layer that adds a
second Linear on the k features, and a head. The view-dependent field
ends its spatial part in a relu bottleneck and adds a directional MLP on
[bottleneck | view encoding]. A train step costs, per ray, the forward's
MACs, the same again for the weight gradients, and the input gradients of
every layer whose input is computed by the network (the k-wide inputs and
the view encoding need none); 2 FLOPs per MAC.
"""
from __future__ import annotations

# Dense bf16 tensor-core FLOP/s and HBM bytes/s of the card, by the name
# torch.cuda.get_device_name() gives (NVIDIA's H100 SXM5 datasheet). A card
# not in the table has no roofline or mfu: its readers return nothing.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def peaks(kind):
    """The card's peaks, or None for a card the table does not know."""
    return PEAKS.get(kind)


def venc_lanes(vd):
    """Lanes of the view encoding: d (2 embed_size + include_view_dir)."""
    d = vd["in_dim_view_dir"]
    return d * 2 * vd["embed_size"] + (d if vd["include_view_dir"] else 0)


def layers(cfg):
    """[(fan_in, fan_out, input_is_computed)] of every Linear, in forward
    order; input_is_computed is False where the layer reads the features
    or the view encoding (no input gradient is needed there)."""
    m, k = cfg["model"], cfg["k"]
    hidden, skip, n = m["mlp_hidden_dim"], m["skip_layer_idx"], m["num_layers"]
    vd = m.get("view_dependence")
    out = []
    for i in range(n - 1):
        if i == 0:
            out.append((k, hidden, False))
        elif i == skip:
            out += [(hidden, hidden, True), (k, hidden, False)]
        else:
            out.append((hidden, hidden, True))
    if vd is None:
        out.append((hidden, 3, True))
        return out
    out.append((hidden, vd["bottleneck_vec_dim"], True))
    # [bottleneck | venc] -> directional hidden: the bottleneck rows take an
    # input gradient, the view rows none
    out.append((vd["bottleneck_vec_dim"], vd["directional_hidden_dim"], True))
    out.append((venc_lanes(vd), vd["directional_hidden_dim"], False))
    out.append((vd["directional_hidden_dim"], 3, True))
    return out


def forward_macs(cfg):
    return sum(a * b for a, b, _ in layers(cfg))


def input_grad_macs(cfg):
    return sum(a * b for a, b, computed in layers(cfg) if computed)


def forward_flops_per_ray(cfg):
    return 2 * forward_macs(cfg)


def train_flops_per_ray(cfg):
    """Forward, weight gradients (the forward's MACs again) and input
    gradients, 2 FLOPs per MAC."""
    return 2 * (2 * forward_macs(cfg) + input_grad_macs(cfg))


def param_count(cfg):
    """Weights and biases of every Linear (the directional layer's two row
    blocks share one bias)."""
    n = sum(a * b + b for a, b, _ in layers(cfg))
    vd = cfg["model"].get("view_dependence")
    return n if vd is None else n - vd["directional_hidden_dim"]


def row_bytes(cfg):
    """Bytes of one ray's input row at the table's stored precision: the k
    features, and the view encoding of a view-dependent field."""
    size = ITEMSIZE[cfg["precision"]["table"]]
    vd = cfg["model"].get("view_dependence")
    return size * (cfg["k"] + (0 if vd is None else venc_lanes(vd)))


def train_step_bytes(cfg, batch):
    """The least bytes a step moves: its rows of the table, its f32 targets,
    and the f32 parameters and both Adam moments, each read and written once."""
    return batch * (row_bytes(cfg) + 3 * 4) + 2 * 3 * 4 * param_count(cfg)


def forward_bytes(cfg, rays):
    """The least bytes a forward over `rays` moves: their input rows and the
    f32 RGB out, and the f32 parameters read once."""
    return rays * (row_bytes(cfg) + 3 * 4) + 4 * param_count(cfg)


def least_seconds(flops, nbytes, kind):
    """The roofline: the larger of the compute time at the bf16 peak and the
    memory time at the HBM peak (None for a card without peaks)."""
    p = peaks(kind)
    if p is None:
        return None
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes_per_s"])
