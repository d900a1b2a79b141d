"""Scene model: counterpart of ``directx_raytracer_tpu/models/__init__.py``."""

from .camera import Camera
from .light import Light
from .material import Material, MaterialType
from .mesh import Mesh
from .scene import (
    DeviceScene,
    Geometry,
    LightTable,
    MaterialTable,
    Scene,
    SceneSettings,
    TextureTable,
    build_device_scene,
    scene_from_numpy,
)
from .texture import Texture, TextureType

__all__ = [
    "Camera",
    "Light",
    "Material",
    "MaterialType",
    "Mesh",
    "Scene",
    "SceneSettings",
    "DeviceScene",
    "Geometry",
    "MaterialTable",
    "TextureTable",
    "LightTable",
    "Texture",
    "TextureType",
    "build_device_scene",
    "scene_from_numpy",
]
