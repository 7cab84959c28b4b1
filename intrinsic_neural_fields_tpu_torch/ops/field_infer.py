"""A trained field evaluated on interpolated per-vertex features, for every
caller that does so outside training (the Renderer, the bake): one place
decides how the field runs.

  - "kernel": the fused forward kernel (``fused_mlp_fwd``, or
    ``fused_mlp_fwd_viewdep`` for a view-dependent field); the default on
    CUDA. An xyz / ff / rff field's positions are encoded by the model's
    own encoder first and the kernel runs at the embedded width (JAX
    render/renderer.py:221-262, 283-300);
  - "plain": the kernel's plain torch twin, the same steps; the default on
    the CPU;
  - "module": the module's f32 forward, encoder inside, for a field the
    kernels do not compute (a sine field; NeuTex, ``model(xyz)`` on the
    interpolated hit positions, as the JAX renderer's XLA path applies it,
    render/renderer.py:603-612 there). It is taken only when the caller
    leaves ``infer`` unset, as the JAX renderer's ``infer="auto"`` takes
    its XLA path for such a field; an explicit "kernel" or "plain" for it
    raises, as the JAX renderer's ``infer="fused"`` asserts. No kernel
    layout is built in this mode.
"""
from __future__ import annotations

import torch

from ..models.texture_field import input_encoder_apply, view_encoder_apply
from .fused_mlp import (
    fused_apply,
    fused_apply_plain,
    fused_apply_viewdep,
    fused_apply_viewdep_plain,
    fused_mlp_eligible,
    fused_pre_embed_eligible,
    fused_viewdep_eligible,
    layout_for_model,
)


class FieldInfer:
    """``field(features [n, k_in] f32[, dirs [n, 3], faces [n]])`` -> [n, 3]
    f32 RGB of a TextureField, a TextureFieldWithViewDependency (dirs and
    faces: the unit ray directions and original face ids of the hits) or
    a NeuTex model (features: the hit positions). ``mode``: "kernel",
    "plain" or "module" (see the module docstring); ``layout`` and
    ``weights``: the kernel's parameter layout and packed weights (None in
    "module" mode), repacked by ``update_variables``."""

    def __init__(self, model, device, infer=None):
        eligible = (fused_mlp_eligible(model) or fused_pre_embed_eligible(model)
                    or fused_viewdep_eligible(model))
        if infer is None:
            infer = ("kernel" if device.type == "cuda" else "plain") if eligible else "module"
        elif infer not in ("kernel", "plain"):
            raise ValueError(f"infer must be 'kernel' or 'plain', got {infer!r}")
        if infer == "kernel" and device.type != "cuda":
            raise ValueError(f"infer='kernel' needs a CUDA device, got {device} (the kernel "
                             "needs CUDA; the CPU takes 'plain')")
        if infer != "module" and not eligible:
            raise ValueError(
                f"infer={infer!r}: the forward kernels do not compute this field (they "
                "need relu, a sigmoid RGB head and widths that are multiples of 128); "
                "leave infer unset to run its module's f32 forward")
        self.mode = infer
        self.model = model
        self.device = device
        self.layout = None if infer == "module" else layout_for_model(model)
        self.viewdep = hasattr(model, "spatial_mlp")
        self.encode = input_encoder_apply(model)
        self.view_fn = view_encoder_apply(model) if self.viewdep else None
        kernel, plain = ((fused_apply_viewdep, fused_apply_viewdep_plain) if self.viewdep
                         else (fused_apply, fused_apply_plain))
        self._apply = {"kernel": kernel, "plain": plain}.get(infer)
        self.weights = None
        self.update_variables(model.state_dict())

    def update_variables(self, state_dict):
        """Load new weights (the model's whole state dict, RFF's embedding.B
        included) into the model, whose encoder and, in "module" mode,
        forward run here, and pack them for the kernel once."""
        self.model.load_state_dict(state_dict)
        if self.mode != "module":
            self.weights = self.layout.pack(
                self.layout.flat_from_state_dict(state_dict, self.device))

    @torch.no_grad()
    def __call__(self, features, dirs=None, faces=None):
        if self.mode == "module":
            return (self.model(features, dirs, faces) if self.viewdep
                    else self.model(features))
        x = features if self.encode is None else self.encode(features)
        if self.viewdep:
            return self._apply(self.weights, x, self.view_fn(dirs, faces).contiguous())
        return self._apply(self.weights, x)
