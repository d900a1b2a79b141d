"""Materials — mirrors ``CRTMaterial`` (reference: CRTMaterial.{h,cpp}).

Counterpart of ``directx_raytracer_tpu/models/material.py`` (``Material``,
``MaterialType``), copied unchanged (numpy only).

The enum order matches CRTMaterial.h:4-11 so material tables serialized from
either implementation agree.  A material's albedo is either a constant color
or the *name* of a texture — the reference encodes "texture" as a non-empty
``textureName`` (CRTMaterial.cpp:23-26), produced by the parser when the JSON
``albedo`` field is a string (CRTSceneParser.cpp:380-384).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class MaterialType(enum.IntEnum):
    INVALID = 0
    DIFFUSE = 1
    REFLECTIVE = 2
    REFRACTIVE = 3
    CONSTANT = 4


@dataclass
class Material:
    type: MaterialType = MaterialType.INVALID
    albedo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    texture_name: str = ""
    smooth_shading: bool = False
    ior: float = 1.0
    # Blinn-Phong extension (BASELINE.json config 3; optional scene keys
    # "specular"/"shininess" — the reference's 4-type material model carries
    # neither, so 0.0 specular keeps exact reference semantics).
    specular: float = 0.0
    shininess: float = 32.0

    def is_texture(self) -> bool:
        """CRTMaterial::isTexture — texture iff the name is non-empty."""
        return len(self.texture_name) > 0
