"""Framebuffer conversion + image IO.

Counterpart of ``directx_raytracer_tpu/utils/image.py`` (``to_u8``,
``write_png``).  ``to_u8`` keeps the same UNORM rounding and also takes a
torch tensor on any device.  ``write_png`` encodes with the standard
library (zlib) instead of Pillow, so a GPU host without Pillow can still
save frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_u8(img) -> np.ndarray:
    """Clamp [0,1] float image to uint8 (UNORM-style round-to-nearest)."""
    arr = _host(img).astype(np.float32, copy=False)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, img) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) image as an 8-bit PNG."""
    arr = _host(img)
    if arr.dtype != np.uint8:
        arr = to_u8(arr)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate(  # filter byte 0 ("None") before every scanline
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
