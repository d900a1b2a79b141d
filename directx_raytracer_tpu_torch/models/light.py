"""Point light — mirrors ``CRTLight`` (reference: CRTLight.h:4-16):
a world position plus a scalar intensity.

Counterpart of ``directx_raytracer_tpu/models/light.py`` (``Light``), copied
unchanged (numpy only)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Light:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    intensity: float = 0.0
