"""The work of a NeuTex train step, counted from the configuration's
widths, and the card's float32 peak: the yardstick of neutex.train_mfu.
Nothing here depends on how the program splits the work into kernels.

NeuTex (models/neutex.py, one sphere primitive) is three chains of Linear
layers: the inverse map 3 -> 128 -> 128 -> 128 -> 4, the atlas
3 -> 512 -> 512 -> 512 -> 3, and the texture network on the Fourier
encoding of the sphere point (3 + 2 * 3 * k lanes) through seven Linear
layers of width 128 and a 3-wide head. The widths but k are fixed by the
published model; k (the encoding's bands) is the configuration's. A train
step costs, per ray, the forward's MACs, the same again for the weight
gradients, and the input gradients of every layer whose input is computed
(every layer but the inverse map's first, which reads the positions);
2 FLOPs per MAC.

The step runs in float32 with TF32 off (the program's package default), so
its peak is the card's float32 rate outside the tensor cores.
"""
from __future__ import annotations

# float32 FLOP/s outside the tensor cores, by the name
# torch.cuda.get_device_name() gives (NVIDIA's H100 SXM5 datasheet). A card
# not in the table has no mfu: its reader returns nothing.
F32_PEAKS = {"NVIDIA H100 80GB HBM3": 67e12}

INVERSE = (3, 128, 128, 128, 4)  # the inverse map's widths, input to output
ATLAS = (3, 512, 512, 512, 3)
TEXTURE_WIDTH, TEXTURE_LAYERS = 128, 7  # LeakyReLU layers, then the RGB head


def f32_peak(kind):
    """The card's float32 FLOP/s, or None for a card the table does not know."""
    return F32_PEAKS.get(kind)


def chain(widths, first_computed):
    return [(a, b, first_computed or i > 0)
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]


def layers(cfg):
    """[(fan_in, fan_out, input_is_computed)] of every Linear: the inverse
    map (its first layer reads the positions), the atlas, the texture
    network."""
    enc = 3 + 2 * 3 * cfg["model"]["k"]
    texture = (enc,) + (TEXTURE_WIDTH,) * TEXTURE_LAYERS + (3,)
    return chain(INVERSE, False) + chain(ATLAS, True) + chain(texture, True)


def forward_macs(cfg):
    return sum(a * b for a, b, _ in layers(cfg))


def train_flops_per_ray(cfg):
    """Forward, weight gradients (the forward's MACs again) and input
    gradients, 2 FLOPs per MAC."""
    igrad = sum(a * b for a, b, computed in layers(cfg) if computed)
    return 2 * (2 * forward_macs(cfg) + igrad)
