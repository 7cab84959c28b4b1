"""LPIPS with the AlexNet backbone in torch (the JAX package's
evaluation/lpips_jax.py:22-37, 67-119; the reference's eval.py scores with
the `lpips` pip package, x100).

Both images (used as-is, as the reference's call passes [0,1] tensors
without normalize=True) are shifted and scaled by the LPIPS input
normalisation and pushed through AlexNet's five conv stages; each stage's
activation is unit-normalised along channels, the squared difference is
weighted by the learned 1x1 calibration, averaged over space and summed
over stages.

Weights are read only from a local .npz with keys conv{i}_w, conv{i}_b and
lin{i}_w (the JAX package's `convert_torch_weights` writes that file where
the `lpips` checkpoint exists; this package does not convert). Without one,
`available()` is False and the eval CLI's LPIPS column stays NaN.

The convolutions run in f32 with TF32 off, so the card computes the same
metric as the CPU (cuDNN would otherwise take TF32 on Hopper).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# Input normalisation of the LPIPS reference implementation.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature extractor: (out_ch, kernel, stride, pad, maxpool before)
ALEX_CFG = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]


def alex_features(weights, x):
    """The five stage activations of x [N,3,H,W] (weights: the npz's
    arrays as tensors on x's device)."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    feats = []
    for i, (_, _, stride, pad, pool_before) in enumerate(ALEX_CFG):
        if pool_before:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
        h = F.relu(F.conv2d(h, weights[f"conv{i}_w"], weights[f"conv{i}_b"],
                            stride=stride, padding=pad))
        feats.append(h)
    return feats


def _unit_normalize(a):
    # the lpips package's normalize_tensor: eps outside the sqrt
    return a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)


def lpips_distance(weights, x0, x1):
    """LPIPS of two [N,3,H,W] batches -> [N]."""
    total = 0.0
    for i, (a, b) in enumerate(zip(alex_features(weights, x0), alex_features(weights, x1))):
        diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        lin = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + torch.sum(diff * lin, dim=1).mean(dim=(1, 2))
    return total


class LPIPS:
    """The metric on [H,W,3] images in [0,1], as the eval CLI calls it."""

    def __init__(self, weights_path=None, device="cuda"):
        self.weights_path = weights_path
        self._weights = None
        if weights_path is not None and os.path.exists(weights_path):
            self.device = resolve_device(device)
            with np.load(weights_path) as z:
                self._weights = {name: torch.as_tensor(np.asarray(z[name], np.float32),
                                                       device=self.device) for name in z.files}

    def available(self):
        return self._weights is not None

    def __call__(self, fake_img, real_img):
        if not self.available():
            raise RuntimeError(f"no LPIPS weights at {self.weights_path!r}")

        def to_nchw(im):
            return torch.as_tensor(np.asarray(im, np.float32), device=self.device) \
                .permute(2, 0, 1)[None].contiguous()

        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            d = lpips_distance(self._weights, to_nchw(fake_img), to_nchw(real_img))
        return float(d[0])
