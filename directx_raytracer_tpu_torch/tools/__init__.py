"""Command-line tools of the port (counterparts of the repository's
``tools/``): ``python -m directx_raytracer_tpu_torch.tools.<name>``."""
