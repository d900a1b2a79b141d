"""Framebuffer conversion + image IO.

Counterpart of ``directx_raytracer_tpu/utils/image.py`` (``to_u8``,
``write_png``, ``read_png``).  ``to_u8`` keeps the same UNORM rounding and
also takes a torch tensor on any device.  ``write_png`` and ``read_png``
code with the standard library (zlib) instead of Pillow, so a GPU host
without Pillow can still save and load frames.
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


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters; ``raw`` is (H, 1 + stride) u8
    (filter byte first), ``bpp`` the bytes per pixel."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        else:  # Sub, Average, Paeth: each byte leans on the one bpp before
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                elif kind == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"PNG filter type {kind}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray, RGB or RGBA PNG (what
    ``write_png`` writes, with any scanline filter) as an (H, W) or
    (H, W, C) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA "
                         f"PNGs are read (depth {depth}, color type "
                         f"{color_type}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = _unfilter(raw.reshape(h, 1 + w * channels), channels)
    return pixels.reshape((h, w) if channels == 1 else (h, w, channels))
