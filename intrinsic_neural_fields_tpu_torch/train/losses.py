"""Training losses (reference config.py:113-122): L1, L2, cauchy.

``elementwise_loss`` returns the per-element loss map (for weighted and
masked batches), ``get_loss_fn`` the scalar mean the train step optimizes.
"""
from __future__ import annotations

import torch

_CAUCHY_C2 = (20.0 / 255.0) ** 2


def elementwise_loss(loss_type):
    if loss_type == "L2":
        return lambda pred, gt: (pred - gt) ** 2
    if loss_type == "L1":
        return lambda pred, gt: torch.abs(pred - gt)
    if loss_type == "cauchy":
        return lambda pred, gt: _CAUCHY_C2 * torch.log1p((pred - gt) ** 2 / _CAUCHY_C2)
    raise RuntimeError(
        f"Unknown loss function: {loss_type}. Please use either 'L1', 'L2' or 'cauchy'"
    )


def get_loss_fn(loss_type):
    elem = elementwise_loss(loss_type)
    return lambda pred, gt: torch.mean(elem(pred, gt))
