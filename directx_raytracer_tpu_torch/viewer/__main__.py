"""``python -m directx_raytracer_tpu_torch.viewer``: counterpart of
``directx_raytracer_tpu/viewer/__main__.py``."""

from .app import main

if __name__ == "__main__":
    raise SystemExit(main())
