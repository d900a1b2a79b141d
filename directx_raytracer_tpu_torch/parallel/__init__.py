"""Multi-device rendering over ``torch.distributed``: counterpart of
``directx_raytracer_tpu/parallel/``."""

from .launch import launch, local_device
from .multihost import global_mesh_shape, init_distributed, make_global_mesh
from .sharding import (
    Mesh,
    make_mesh,
    pathtrace_multichip,
    pathtrace_shard,
    render_whitted_multichip,
    untile_multichip,
    whitted_shard,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "render_whitted_multichip",
    "pathtrace_multichip",
    "untile_multichip",
    "whitted_shard",
    "pathtrace_shard",
    "init_distributed",
    "global_mesh_shape",
    "make_global_mesh",
    "launch",
    "local_device",
]
