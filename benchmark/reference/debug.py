"""The debug frame of single pixels: the closest hit of the pixel's primary
ray, shaded by the reference application's ``closestHit`` shader in its
"Distance to Camera Debug" mode (HLSL/ray_tracing_shaders.hlsl:148-154:
grey ``clamp(0.05 t, 0, 1)``), a miss in the ``miss`` shader's cyan
(hlsl:72-76).  The other modes are not reproduced: no traffic uses them."""

from __future__ import annotations

import torch

from benchmark.reference.camera import primary_rays

MISS_COLOR = (0.0, 1.0, 1.0)


def render_pixels(tris, data: dict, pose, px, py, args: dict):
    """(N, 3) colours in [0, 1] of pixels (px, py) at ``pose``."""
    if int(args["mode"]) != 5:
        raise ValueError(f"debug mode {args['mode']} has no plain reference")
    o, d = primary_rays(pose, data["width"], data["height"], px, py, tris.dtype)
    t, tri, _, _ = tris.closest(o, d)
    grey = (t * 0.05).clamp(0.0, 1.0)[:, None].expand(-1, 3)
    miss = torch.tensor(MISS_COLOR, dtype=t.dtype, device=t.device)
    return torch.where((tri >= 0)[:, None], grey, miss)
