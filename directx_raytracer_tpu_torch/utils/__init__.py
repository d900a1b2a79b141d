"""Host utilities: counterpart of ``directx_raytracer_tpu/utils/``."""
