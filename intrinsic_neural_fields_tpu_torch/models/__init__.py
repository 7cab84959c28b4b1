"""Texture-field models: the plain field and the view-dependent field."""
from .factory import make_model
from .texture_field import TextureField, TextureFieldWithViewDependency, view_encoder_apply

__all__ = ["TextureField", "TextureFieldWithViewDependency", "make_model",
           "view_encoder_apply"]
