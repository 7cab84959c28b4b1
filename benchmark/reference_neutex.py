"""The plain reference of NeuTex (Xiang, Xu, Hasan and Su, "NeuTex: Neural
Texture Mapping for Volumetric Neural Rendering", CVPR 2021,
arXiv:2103.00762) as the intrinsic-neural-fields release trains it for
texture reconstruction: the forward of its three networks, its composite
loss and optax-Adam steps, in plain torch float32 with TF32 off. It
imports nothing of the program: it reads the parameters by the program's
state-dict key names, as strings, and takes the positions the benchmark
works out from its inputs.

For surface points x [N, 3] and target colours y [N, 3]:

  inverse map  o = M_inv(x), Linear 3 -> 128 -> 128 -> 128 -> 4 with relu
               between the layers; uv = o[:3] / max(|o[:3]|, 1e-12), a
               point of the unit sphere; w = softmax over the primitives
               of o[3] (one primitive: w = 1, and no gradient reaches o[3])
  atlas        x' = M_atlas(uv), Linear 3 -> 512 -> 512 -> 512 -> 3, relu
  texture      e = [cos(uv_d f_j) | sin(uv_d f_j) | uv] with the bands
               f_j = 2^(6 j / 170) pi, j < 170 (use_logspace false,
               max_freq 6: 2^linspace(0, 6, 171)[:-1] pi, rounded to f32
               once): 3 + 2 * 3 * 170 = 1023 lanes; h = LeakyReLU_0.2 of
               seven Linear layers (1023 -> 128, then 128 -> 128 six
               times); rgb = w sigmoid(Linear 128 -> 3 of h)
  loss         mean over N and the channels of (rgb - y)^2
               + mean over N of sum_p w_p |x - x'_p|^2 (the cycle term,
               the only one that reaches the atlas)

The encoding's lanes are in the order of the program's models/encoders.py,
which keeps the JAX package's: each input coordinate's 170 bands
contiguous (uv_0 f_0 .. uv_0 f_169, uv_1 f_0, ...), cosines, then sines,
then uv itself. The one departure from the paper's description is the
release's: one sphere primitive (the paper's atlas may hold several).
The release applies NeuTex to the mesh's surface points, so the paper's
volume rendering is not part of the model here.

`q`, where a function takes it, rounds every matmul operand (inputs,
weights, activations and the deltas of the backward) before the product,
accumulating in float32: None is the reference itself, `tf32` the control
(TensorFloat-32's 10-bit mantissa, the precision below the
configuration's float32).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .reference import linear

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

INVERSE = "neutex.net_inverse_atlasnet_3d_to_uv.encoders.0."
ATLAS = "neutex.net_atlasnet_uv_to_3d.decoder.0."
TEXTURE = "neutex.net_texture.textures.0.dense."
MAPPING_LAYERS = ("linear1", "linear_list.0", "linear_list.1", "last_linear")
TEXTURE_LAYERS = 7  # LeakyReLU layers before the RGB head
LEAKY_SLOPE = 0.2


def tf32(x):
    """x rounded to TensorFloat-32 (1 sign, 8 exponent and 10 mantissa
    bits, to nearest, ties to even), held as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


PRECISIONS = {"float32": None, "tfloat32": tf32}


def bands(cfg, device):
    """The encoding's frequency bands, computed in float64 and rounded to
    float32 once."""
    m = cfg["model"]
    k = m["k"]
    if m["use_logspace"]:
        f = 2.0 ** np.arange(k) * np.pi
    else:
        f = 2.0 ** np.linspace(0.0, m["max_freq"], k + 1)[:-1] * np.pi
    return torch.tensor(f.astype(np.float32), device=device)


def mapping(p, prefix, x, q=None):
    """A mapping network: its four Linear layers with relu between them."""
    h = x
    for i, name in enumerate(MAPPING_LAYERS):
        h = linear(h, p[f"{prefix}{name}.weight"], p[f"{prefix}{name}.bias"], q)
        if i < len(MAPPING_LAYERS) - 1:
            h = torch.relu(h)
    return h


def forward(p, cfg, x, q=None):
    """(rgb [N, 3], the atlas's point x' [N, 3], the mixture weight w
    [N, 1]) of surface points x [N, 3]."""
    o = mapping(p, INVERSE, x, q)
    raw = o[:, :3]
    uv = raw / torch.clamp(torch.sqrt((raw * raw).sum(1, keepdim=True)), min=1e-12)
    w = torch.softmax(o[:, 3:], dim=1)
    back = mapping(p, ATLAS, uv, q)
    a = (uv[:, :, None] * bands(cfg, x.device)).reshape(len(uv), -1)
    h = torch.cat([torch.cos(a), torch.sin(a), uv], 1)
    for j in range(TEXTURE_LAYERS):
        h = F.leaky_relu(linear(h, p[f"{TEXTURE}{j}.weight"], p[f"{TEXTURE}{j}.bias"], q),
                         LEAKY_SLOPE)
    rgb = torch.sigmoid(linear(h, p[f"{TEXTURE}{TEXTURE_LAYERS}.weight"],
                               p[f"{TEXTURE}{TEXTURE_LAYERS}.bias"], q))
    return rgb * w, back, w


def loss(p, cfg, x, y, q=None, cycle=True):
    """The colour MSE plus (with `cycle`) the weighted cycle term."""
    rgb, back, w = forward(p, cfg, x, q)
    out = ((rgb - y) ** 2).mean()
    if cycle:
        out = out + (((x - back) ** 2).sum(1) * w[:, 0]).mean()
    return out


def train_steps(p0, cfg, batches, q=None, fault=None, keep=(), epoch_from=None):
    """Follow NeuTex's train steps with optax's Adam from the state dict p0,
    one per item of `batches`: (x [B, 3] surface points, None, target
    [B, 3]). Returns {"losses": [float], "grad1": {leaf: tensor},
    "params": {step: state dict after that step, for each step in keep},
    "params_end", "mu_end": the parameters and Adam's first moment after
    the last step}, as reference.train_steps does. fault (for the control's
    checks): "unchanged" leaves the parameters and moments as they are,
    "half_batch" takes the loss over the first half of each batch,
    "hyper_row0" gives every step from step `epoch_from` on the bias
    corrections of that first step, "cycle_dropped" trains on the colour
    term alone (the atlas then gets no gradient)."""
    t = cfg["training"]
    lr, b1, b2, eps = (torch.tensor(v, dtype=torch.float32) for v in (t["lr"], 0.9, 0.999, 1e-8))
    p = {k: v.detach().clone().float() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": [], "grad1": None, "params": {}}
    for step, (x, _, gt) in enumerate(batches, 1):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        if fault == "half_batch":
            h = x.shape[0] // 2
            x, gt = x[:h], gt[:h]
        value = loss(leaves, cfg, x.float(), gt, q, cycle=fault != "cycle_dropped")
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
        out["losses"].append(value.detach())
        g = {k: torch.zeros_like(p[k]) if v is None else v for k, v in zip(leaves, grads)}
        if step == 1:
            out["grad1"] = {k: v.detach().clone() for k, v in g.items()}
        if fault != "unchanged":
            bias_step = epoch_from if fault == "hyper_row0" and step >= epoch_from else step
            with torch.no_grad():
                c1 = 1.0 - b1 ** bias_step
                c2 = 1.0 - b2 ** bias_step
                for k in p:
                    mu[k] = b1 * mu[k] + (1.0 - b1) * g[k]
                    nu[k] = b2 * nu[k] + (1.0 - b2) * g[k] * g[k]
                    p[k] = p[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        if step in keep:
            out["params"][step] = {k: v.clone() for k, v in p.items()}
    out["losses"] = [float(v) for v in out["losses"]]
    out["params_end"], out["mu_end"] = p, mu
    return out
