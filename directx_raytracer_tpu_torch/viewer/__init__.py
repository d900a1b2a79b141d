"""Viewer CLI: counterpart of ``directx_raytracer_tpu/viewer/``."""
