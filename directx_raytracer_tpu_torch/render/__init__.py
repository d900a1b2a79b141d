"""Renderers: counterpart of ``directx_raytracer_tpu/render/__init__.py``
(the debug and Whitted renderers; callers of the path tracer import
``render.pathtrace``, as in the JAX package)."""

from .debug import render_debug, untile
from .renderer import Renderer
from .whitted import render_whitted, render_whitted_checked

__all__ = ["Renderer", "render_debug", "render_whitted",
           "render_whitted_checked", "untile"]
