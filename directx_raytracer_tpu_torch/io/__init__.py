"""Scene IO: counterpart of ``directx_raytracer_tpu/io/``."""
