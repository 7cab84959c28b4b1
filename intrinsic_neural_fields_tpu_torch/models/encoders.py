"""Input feature encoders (reference layers.py:6-47; JAX package
models/encoders.py:18-68).

The JAX package's column order is kept: each input dimension's bands are
contiguous (``(x[..., None] * bands).reshape(...)``), then the encoding is
``[cos | sin | x]``. A band-major order would permute the rows of the
first directional Linear of an extrinsic (3-d input) model.

``RandomFourierFeatEnc`` keeps its projection ``B`` [in_dim, k] as a
persistent, non-trainable buffer (state-dict key ``embedding.B`` inside a
TextureField), as the reference's torch module does. Its contraction
``(2 pi x) @ B`` is three products summed in f32, written out term by term
so that no matmul path (TF32 on the card) rounds the phases: at std 8 they
reach hundreds of radians, where an f32 ulp is already ~3e-5.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def fourier_freq_bands(k, use_logspace=False, max_freq=None):
    """Frequency bands as f32: 2^i pi (logspace) or 2^linspace(0, max_freq,
    k+1)[:-1] pi, computed in f64 and rounded once, as the reference does."""
    if use_logspace:
        bands = 2.0 ** np.arange(0, k) * np.pi
    else:
        if max_freq is None:
            raise ValueError("max_freq is required when use_logspace=False")
        bands = 2.0 ** np.linspace(0.0, max_freq, num=k + 1)[:-1] * np.pi
    return torch.from_numpy(bands.astype(np.float32))


def fourier_feat_enc(x, k, include_input=True, use_logspace=False, max_freq=None):
    """[..., d] -> [..., d*2k (+ d)] cos/sin positional encoding."""
    bands = fourier_freq_bands(k, use_logspace, max_freq).to(x.device)
    return _cos_sin(x, (x[..., None] * bands).reshape(*x.shape[:-1], -1), include_input)


def fourier_feat_dim(in_dim, k, include_input=True):
    return in_dim * 2 * k + (in_dim if include_input else 0)


def _cos_sin(x, embed, include_input):
    parts = [torch.cos(embed), torch.sin(embed)]
    if include_input:
        parts.append(x)
    return torch.cat(parts, dim=-1)


class FourierFeatEnc(nn.Module):
    """cos/sin positional encoding of a [..., in_dim] input (JAX
    ``FourierFeatEnc``); output width ``out_dim`` = in_dim * 2k (+ in_dim).
    The bands are constants, not part of the state dict."""

    def __init__(self, k, include_input=True, use_logspace=False, max_freq=None, in_dim=3):
        super().__init__()
        self.k, self.include_input = k, include_input
        self.out_dim = fourier_feat_dim(in_dim, k, include_input)
        self.register_buffer("bands", fourier_freq_bands(k, use_logspace, max_freq),
                             persistent=False)

    def forward(self, x):
        embed = (x[..., None] * self.bands).reshape(*x.shape[:-1], -1)
        return _cos_sin(x, embed, self.include_input)


class RandomFourierFeatEnc(nn.Module):
    """Gaussian random Fourier features (JAX ``RandomFourierFeatEnc``):
    ``[cos | sin | x]`` of ``(2 pi x) @ B``, B ~ N(0, std^2) of shape
    [in_dim, k]. B starts at zero: ``models/factory.make_model`` loads the
    one the JAX package draws (``utils/jax_random.rff_projection``). B is
    a persistent buffer: checkpoints carry it and gradients never reach it."""

    def __init__(self, k, std=1.0, in_dim=3, include_input=True):
        super().__init__()
        self.k, self.include_input = k, include_input
        self.out_dim = 2 * k + (in_dim if include_input else 0)
        self.register_buffer("B", torch.zeros((in_dim, k), dtype=torch.float32))

    def forward(self, x):
        x2 = (2.0 * math.pi) * x
        B = self.B
        embed = x2[..., 0:1] * B[0]
        for d in range(1, B.shape[0]):
            embed = embed + x2[..., d:d + 1] * B[d]
        return _cos_sin(x, embed, self.include_input)
