"""Ray and shading operations: counterpart of ``directx_raytracer_tpu/ops/``."""
