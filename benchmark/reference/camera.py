"""Primary rays of single pixels, as the reference application's ray
generation shader makes them (HLSL/ray_tracing_shaders.hlsl:21-70): the
pixel's centre (+0.5) over the image size, mapped to [-1, 1] with y flipped,
x scaled by the aspect ratio, the camera-space direction (x, y, -1)
normalised, rotated by the camera's rotation (columns right, up, forward)
and normalised again; the origin is the camera's position."""

from __future__ import annotations

import torch


def primary_rays(pose, width: int, height: int, px, py, dtype=torch.float64):
    """Origins and directions (N, 3) for pixels (px, py) (N,) of the
    (width x height) frame seen from ``pose`` = (position, rotation)."""
    dev = px.device
    pos = torch.as_tensor(pose[0], device=dev).to(dtype)
    rot = torch.as_tensor(pose[1], device=dev).to(dtype)
    x = (2.0 * ((px.to(dtype) + 0.5) / width) - 1.0) * (width / height)
    y = 1.0 - 2.0 * ((py.to(dtype) + 0.5) / height)
    c = torch.stack([x, y, -torch.ones_like(x)], dim=1)
    c = c / torch.linalg.vector_norm(c, dim=1, keepdim=True)
    d = c @ rot.T
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return pos.expand(d.shape[0], 3).contiguous(), d
