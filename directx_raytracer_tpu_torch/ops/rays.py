"""Camera ray generation — batched counterpart of the DXR raygen shader.

Counterpart of ``directx_raytracer_tpu/ops/rays.py`` (``T_MIN``/``T_MAX``,
``pick_schedule``, ``pick_tile``, ``generate_rays_tiled``, ``tile_perm``,
``generate_rays``, ``RGSS_OFFSETS``), with the same float-op order,
row-band arguments (``row_start``, ``rows``) included.

Reproduces HLSL/ray_tracing_shaders.hlsl:21-70, vectorized over the whole
pixel grid:

* pixel center offset +0.5, normalize by width/height,
* NDC mapping x -> 2x-1, y -> 1-2y (y flip),
* aspect scaling of x by width/height,
* camera-space direction normalize((x, y, -1)),
* world direction = normalize(R @ dir) with the camera rotation applied as a
  column-vector product (``mul(cameraRotation, v)`` on a row_major-uploaded
  matrix, hlsl:47 + DXRTRenderer.cpp:258-265),
* TMin = 0.001, TMax = 10000 (hlsl:51-52).

Unlike the reference, width/height are parameters (the reference hard-codes
1920x1080 in the shader, hlsl:24-25).
"""

from __future__ import annotations

import torch

T_MIN = 0.001
T_MAX = 10000.0


def pick_schedule(rows: int, width: int):
    """(pixel tile, ray-chunk tile_r) for PRIMARY passes.

    Square-ish pixel tiles keep each chunk's ray hull tight, so a chunk
    bins fewer clusters; the chunk is the whole pixel tile.  Preference:
    24x32, 20x32, 16x32, 12x32; other sizes fall back to ``pick_tile``'s
    divisibility search with 256-ray chunks.  Same choice as the JAX
    package, so both packages bin the same tiles.
    """
    for th, tw in ((24, 32), (20, 32), (16, 32), (12, 32)):
        if rows % th == 0 and width % tw == 0:
            return (th, tw), th * tw
    return pick_tile(rows, width), 256


def pick_tile(rows: int, width: int, tile_h: int = 8, tile_w: int = 32):
    """Largest (th, tw) <= (tile_h, tile_w) dividing the image, or None."""

    def pick(total, want):
        for c in (want, 32, 24, 16, 12, 8, 6, 4, 3, 2):
            if c <= want and total % c == 0:
                return c
        return 1

    th = pick(rows, tile_h)
    tw = pick(width, tile_w)
    if th * tw < 16:  # degenerate tiling buys nothing
        return None
    return th, tw


def _world_dirs(x, y, rotation):
    """normalize(R @ normalize((x, y, -1))) componentwise, as the JAX
    package evaluates it."""
    inv_len = torch.rsqrt(x * x + y * y + 1.0)
    dx, dy, dz = x * inv_len, y * inv_len, -inv_len
    r = rotation
    wx = r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz
    wy = r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz
    wz = r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz
    wlen = torch.rsqrt(wx * wx + wy * wy + wz * wz)
    return torch.stack([wx * wlen, wy * wlen, wz * wlen], dim=-1)


def _camera(position, rotation, device):
    pos = torch.as_tensor(position, dtype=torch.float32).to(device)
    rot = torch.as_tensor(rotation, dtype=torch.float32).to(device)
    return pos, rot


def _offset(offset, device):
    """The sub-pixel offset as f32, rounded as the JAX package rounds it."""
    return torch.as_tensor(offset, dtype=torch.float32).to(device)


def generate_rays_tiled(position, rotation, width: int, height: int,
                        tile_h: int, tile_w: int, offset=(0.5, 0.5),
                        row_start=0, rows: int | None = None, device="cuda"):
    """Primary rays in TILE-MAJOR order, computed arithmetically.

    Pixel (px, py) lands at flat index
    ((ty*tiles_x + tx) * tile_h + ry) * tile_w + rx, so each run of
    tile_h*tile_w rays is one pixel tile.  ``offset`` is the sub-pixel
    sample position, (0.5, 0.5) the pixel center.  ``row_start``/``rows``
    cut the full-width band of pixel rows [row_start, row_start + rows) out
    of the (width x height) frame (None: every row); tiles are counted
    inside the band.  Returns origins, dirs (N, 3) f32 on ``device``.
    """
    pos, rot = _camera(position, rotation, device)
    off = _offset(offset, device)
    rows = height if rows is None else rows
    ty_n, tx_n = rows // tile_h, width // tile_w
    n = ty_n * tx_n * tile_h * tile_w

    i = torch.arange(n, dtype=torch.int32, device=device)
    rx = i % tile_w
    t1 = i // tile_w
    ry = t1 % tile_h
    t2 = t1 // tile_h
    tx = t2 % tx_n
    ty = t2 // tx_n
    px = (tx * tile_w + rx).to(torch.float32)
    py = (ty * tile_h + ry).to(torch.float32) + row_start

    x = (2.0 * ((px + off[0]) / width) - 1.0) * (width / height)
    y = 1.0 - 2.0 * ((py + off[1]) / height)
    dirs = _world_dirs(x, y, rot)
    origins = pos.expand(n, 3).contiguous()
    return origins, dirs


def tile_perm(rows: int, width: int, tile_h: int = 8, tile_w: int = 32):
    """Permutation regrouping row-major pixels into (tile_h x tile_w) tiles.

    Returns an (rows*width,) i32 numpy permutation p such that rays[p] is
    tile-major (``generate_rays`` order -> ``generate_rays_tiled`` order),
    or None if no reasonable tile size divides the image (callers then keep
    row order).
    """
    import numpy as np

    t = pick_tile(rows, width, tile_h, tile_w)
    if t is None:
        return None
    th, tw = t
    idx = np.arange(rows * width, dtype=np.int32).reshape(rows, width)
    return (
        idx.reshape(rows // th, th, width // tw, tw)
        .transpose(0, 2, 1, 3)
        .reshape(-1)
    )


# 4x rotated-grid supersampling offsets (BASELINE config 4); spp=1 uses the
# reference's pixel-center +0.5 (hlsl:35-36).
RGSS_OFFSETS = ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875))


def generate_rays(position, rotation, width: int, height: int,
                  offset=(0.5, 0.5), row_start=0, rows: int | None = None,
                  device="cuda"):
    """Primary rays for every pixel of the full-width band of pixel rows
    [row_start, row_start + rows) (None: the whole frame), in row-major
    pixel order (pixel (px, py) at index (py - row_start)*width + px, the
    reference's UAV layout for the whole frame), sampled at sub-pixel
    ``offset``.  ``width``/``height`` are the full frame's (the projection).
    Returns origins, dirs (rows*W, 3) f32 on ``device``."""
    pos, rot = _camera(position, rotation, device)
    off = _offset(offset, device)
    rows = height if rows is None else rows
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    py = (torch.arange(rows, dtype=torch.float32, device=device)
          + row_start)[:, None]

    x = (px + off[0]) / width
    y = (py + off[1]) / height
    x = 2.0 * x - 1.0
    y = 1.0 - 2.0 * y
    x = x * (width / height)

    x = x.expand(rows, width)
    y = y.expand(rows, width)
    dirs = _world_dirs(x, y, rot).reshape(-1, 3)
    origins = pos.expand(rows * width, 3).contiguous()
    return origins, dirs
