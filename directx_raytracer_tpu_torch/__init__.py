"""directx_raytracer_tpu_torch — the PyTorch + CUDA port of
directx_raytracer_tpu, for NVIDIA Hopper GPUs.

It has the JAX package's module paths and names (``models/scene.py``,
``render/debug.py``, ...); the JAX package stays beside it as the reference
it is tested against.  It imports torch and numpy and never jax.  Its
hand-written CUDA kernels live in ``csrc/`` and are compiled on first use.
"""

__version__ = "0.1.0"

from .models import (  # noqa: F401
    Camera,
    DeviceScene,
    Light,
    Material,
    MaterialType,
    Mesh,
    Scene,
    SceneSettings,
    Texture,
    TextureType,
    build_device_scene,
)
