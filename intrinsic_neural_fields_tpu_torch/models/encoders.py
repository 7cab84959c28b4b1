"""Fourier feature encoding (reference layers.py:6-26).

The JAX package's column order is kept: each input dimension's bands are
contiguous (``(x[..., None] * bands).reshape(...)``), then the encoding is
``[cos | sin | x]``. A band-major order would permute the rows of the
first directional Linear of an extrinsic (3-d input) model.
"""
from __future__ import annotations

import numpy as np
import torch


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
    embed = (x[..., None] * bands).reshape(*x.shape[:-1], -1)
    parts = [torch.cos(embed), torch.sin(embed)]
    if include_input:
        parts.append(x)
    return torch.cat(parts, dim=-1)


def fourier_feat_dim(in_dim, k, include_input=True):
    return in_dim * 2 * k + (in_dim if include_input else 0)
