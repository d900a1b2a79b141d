"""Procedural + bitmap textures.

Counterpart of ``directx_raytracer_tpu/models/texture.py`` (``Texture``,
``TextureType``), copied unchanged (numpy only; Pillow only for bitmaps).

Mirrors the ``CRTTexture`` hierarchy (reference: CRTTexture*.{h,cpp}) as a
tagged union so the whole texture table lives in flat device arrays and the
shade kernel dispatches with vectorized selects instead of virtual calls:

* ALBEDO  — constant color (CRTTextureAlbedo.cpp:8-11).
* EDGES   — *barycentric*-space edges: edge color if ``u < w`` or ``v < w``
            or ``1-u-v < w`` (CRTTextureEdges.cpp:9-15).
* CHECKER — checker over UV with ``width = int(1/square_size)`` and parity of
            ``floor(u*width) + floor(v*width)`` (CRTTextureChecker.cpp:9-20).
* BITMAP  — nearest-neighbor sample, UVs clamped to [0,1], v flipped
            (``(1-v)*(h-1)``), channels>2 ? RGB : (r, g, 0)
            (CRTTextureBitmap.cpp:13-36).  Bitmap is also the parser's
            *fallback* type for unknown type strings (CRTSceneParser.cpp:292-303).

``get_color`` is the host-side scalar sampler used in tests; the batched
device sampler lives in ``ops.shading``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class TextureType(enum.IntEnum):
    ALBEDO = 0
    EDGES = 1
    CHECKER = 2
    BITMAP = 3


@dataclass
class Texture:
    name: str = ""
    type: TextureType = TextureType.ALBEDO
    # ALBEDO: color_a = albedo.  EDGES: color_a = edge, color_b = inner.
    # CHECKER: color_a / color_b.
    color_a: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color_b: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # EDGES: edge_width.  CHECKER: square_size.
    scalar: float = 0.0
    # BITMAP
    file_path: str = ""
    image: np.ndarray | None = None  # (H, W, C) uint8, loaded lazily

    def load(self, base_dir: str = ".") -> None:
        if self.type == TextureType.BITMAP and self.image is None:
            import os

            from PIL import Image

            path = self.file_path
            if not os.path.isabs(path):
                path = os.path.join(base_dir, path)
            self.image = np.asarray(Image.open(path))
            if self.image.ndim == 2:
                self.image = self.image[:, :, None]

    def get_color(self, u: float, v: float) -> np.ndarray:
        if self.type == TextureType.ALBEDO:
            return self.color_a.copy()
        if self.type == TextureType.EDGES:
            w = self.scalar
            if u < w or v < w or (1.0 - u - v) < w:
                return self.color_a.copy()
            return self.color_b.copy()
        if self.type == TextureType.CHECKER:
            width = int(1.0 / self.scalar)
            u2 = int(np.floor(u * width))
            v2 = int(np.floor(v * width))
            return self.color_a.copy() if (u2 + v2) % 2 == 0 else self.color_b.copy()
        # BITMAP
        img = self.image
        u = min(max(u, 0.0), 1.0)
        v = min(max(v, 0.0), 1.0)
        h, w, c = img.shape
        row = int((1.0 - v) * (h - 1))
        col = int(u * (w - 1))
        px = img[row, col].astype(np.float32) / 255.0
        r = px[0]
        g = px[1] if c > 1 else 0.0
        b = px[2] if c > 2 else 0.0
        return np.array([r, g, b], dtype=np.float32)
