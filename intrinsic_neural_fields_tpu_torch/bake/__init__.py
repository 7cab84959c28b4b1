from .bake import bake_texture
