"""PyTorch + CUDA port of intrinsic_neural_fields_tpu (training, render, eval)
of the plain and the view-dependent texture field.

The JAX package beside this one is the reference; this package imports
nothing of it (and no jax/flax/optax). Entry points run on the GPU unless
the caller passes ``device="cpu"``; there is no silent CPU fallback.

Numerics: geometry (ray generation, tracing, interpolation) runs in full
float32. TF32 is switched off for CUDA matmuls and cuDNN convolutions when
this package is imported, because bf16/TF32-rounded ray math visibly costs
image quality (a 5.6 dB drop was measured for bf16 ray matmuls in the
reference). The MLP kernel feeds bf16 operands to the tensor cores on
purpose, exactly like the reference's Pallas kernel.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda"):
    """torch.device for an entry point. ``"cuda"`` (the default everywhere)
    raises when CUDA is unavailable; CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# Public API (imported after resolve_device, which these modules use).
from .evaluation.eval_cli import evaluate_views  # noqa: E402
from .models import TextureField, TextureFieldWithViewDependency, make_model  # noqa: E402
from .ops.fused_mlp import (  # noqa: E402
    FusedMLPSpec,
    ViewDepTailSpec,
    fused_apply,
    fused_apply_plain,
    fused_apply_viewdep,
    fused_apply_viewdep_plain,
    pack_weights,
)
from .render.renderer import Renderer, make_renderer_from_config  # noqa: E402

__all__ = [
    "resolve_device", "Renderer", "make_renderer_from_config", "TextureField",
    "TextureFieldWithViewDependency", "make_model", "evaluate_views", "FusedMLPSpec",
    "ViewDepTailSpec", "fused_apply", "fused_apply_plain", "fused_apply_viewdep",
    "fused_apply_viewdep_plain", "pack_weights",
]
