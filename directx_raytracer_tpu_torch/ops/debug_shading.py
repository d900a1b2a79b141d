"""The reference's 7 procedural debug shading modes, vectorized.

Counterpart of ``directx_raytracer_tpu/ops/debug_shading.py``
(``MISS_COLOR``, ``MODE_NAMES``, ``shade_debug``).  Each mode keeps the
JAX package's float-op order; the mode is a Python int, so only the
selected mode's formula runs.

Formula-equivalent port of the ``closestHit`` shader's mode switch
(HLSL/ray_tracing_shaders.hlsl:78-169) and the ``miss`` shader's constant
cyan (hlsl:72-76).  The DXR intrinsics map to hit-record fields:

* ``PrimitiveIndex()``  -> geometry.local_id[tri]  (triangle index in mesh)
* ``InstanceID()``      -> geometry.mesh_id[tri]   (instance ID = mesh index,
                           DXRTRenderer.cpp:700)
* ``WorldRayOrigin() + WorldRayDirection() * RayTCurrent()`` -> o + d*t
* ``attr.barycentrics`` -> (u, v)

Mode names follow the UI combo box (DXRTMainWindow.cpp:98-121).

Precision note: the hash family ``frac(sin(k * id) * 43758.5453)`` is
evaluated in f32 with arguments up to ~1e10 (mode 1 hashes a uint32 into
``sin``).  ``sin`` implementations disagree in ULPs at such magnitudes, so
hash-colored pixels (modes 0-2) are deterministic per backend but not
bit-equal across backends; the geometric modes (3 barycentric, 4 height,
5 distance, 6 world checker) are directly comparable.
"""

from __future__ import annotations

import torch

MISS_COLOR = (0.0, 1.0, 1.0)  # hlsl:75 — ignores the scene's background_color

MODE_NAMES = (
    "Triangle Random Colors",
    "Object Spatial Shading",
    "Object Triangle Shades",
    "Barycentric Heatmap",
    "World-Space Height Gradient",
    "Distance to Camera Debug",
    "Checker Pattern",
)
NUM_MODES = len(MODE_NAMES)


def _frac(x):
    return x - torch.floor(x)


def _hash_sin(k, mul, scale=43758.5453):
    return _frac(torch.sin(k * mul) * scale)


def _u32_hash(w, mul):
    """``uint(int(floor(w / 2)) * mul)`` with int32 wrap-around, as a
    non-negative int64 (the JAX package's int32 product cast to uint32)."""
    return (torch.floor(w / 2.0).to(torch.int64) * mul) & 0xFFFFFFFF


def shade_debug(mode: int, origins, dirs, t, u, v, local_id, mesh_id):
    """Per-ray debug color for hits; caller overlays the miss color.

    Args:
      mode: shading mode 0..6 (values > 6 behave like 6, matching the
        shader's trailing ``else``; values < 0 like 0).
      origins, dirs: (N, 3); t, u, v: (N,); local_id, mesh_id: (N,) i32.
    Returns (N, 3) f32 colors.
    """
    mode = min(max(int(mode), 0), NUM_MODES - 1)
    wx = origins[:, 0] + dirs[:, 0] * t
    wy = origins[:, 1] + dirs[:, 1] * t
    wz = origins[:, 2] + dirs[:, 2] * t

    if mode in (0, 2):  # hlsl:84-92 — mode 2's triangle shade is the same hash
        tri_f = local_id.to(torch.float32)
        s0r = _hash_sin(tri_f, 12.9898)
        if mode == 0:
            rgb = (s0r, _hash_sin(tri_f, 78.233), _hash_sin(tri_f, 45.164))
    if mode in (1, 2):  # object base color (hlsl:97-101 / 115-120)
        obj_f = mesh_id.to(torch.float32)
        base = (_hash_sin(obj_f, 12.9898), _hash_sin(obj_f, 78.233, 12345.6789),
                _hash_sin(obj_f, 39.425, 34567.8901))
    if mode == 1:  # hlsl:93-112: hashed 2-unit world grid cell variation
        h1 = (_u32_hash(wx, 73856093) ^ _u32_hash(wy, 19349663)
              ^ _u32_hash(wz, 83492791)).to(torch.float32)
        var = _hash_sin(h1, 12.9898)
        inv_var = 1.0 - var
        rgb = tuple(b * 0.7 * inv_var + b * 1.3 * var for b in base)
    elif mode == 2:  # hlsl:113-124: base * (0.6 (1 - shade) + 1.0 shade)
        f2 = 0.6 * (1.0 - s0r) + 1.0 * s0r
        rgb = tuple(b * f2 for b in base)
    elif mode == 3:  # hlsl:125-134
        rgb = (1.0 - u - v, u, v)
    elif mode == 4:  # hlsl:135-147: lerp(lo, hi, world height)
        h4 = torch.clamp((wy + 10.0) / 20.0, 0.0, 1.0)
        inv_h4 = 1.0 - h4
        rgb = (0.1 * inv_h4 + 0.9 * h4, 0.2 * inv_h4 + 0.9 * h4,
               0.6 * inv_h4 + 0.9 * h4)
    elif mode == 5:  # hlsl:148-154
        c5 = torch.clamp(t * 0.05, 0.0, 1.0)
        rgb = (c5, c5, c5)
    elif mode == 6:  # hlsl:155-166
        checker = (torch.floor(wx).to(torch.int64)
                   ^ torch.floor(wz).to(torch.int64)) & 1
        c6 = torch.where(checker != 0, 0.9, 0.2).to(torch.float32)
        rgb = (c6, c6, c6)
    return torch.stack(rgb, dim=-1)
