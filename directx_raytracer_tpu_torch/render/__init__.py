"""Renderers: counterpart of ``directx_raytracer_tpu/render/__init__.py``
(the debug renderer; Whitted comes with its slice)."""

from .debug import render_debug, untile
from .renderer import Renderer

__all__ = ["Renderer", "render_debug", "untile"]
