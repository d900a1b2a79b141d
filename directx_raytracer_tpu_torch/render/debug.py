"""Debug-mode frame renderer — the analog of the reference's DXR dispatch
path (``renderFrame``, DXRTRenderer.cpp:1370-1408): one primary ray per
pixel, closest hit, 7-mode procedural shade, miss = constant cyan.

Counterpart of ``directx_raytracer_tpu/render/debug.py``
(``isect_kwargs``, ``untile``, ``render_debug``).  The frame is a plain function of (scene tensors,
camera snapshot, mode) returning an (H, W, 3) f32 image on the scene's
device.  Rays are generated in tile-major order (coherent tiles feed the
binned intersector), per-hit attributes come from ONE packed-record
gather, and the tile -> raster reorder at the end is a reshape/permute.
"""

from __future__ import annotations

import torch

from ..models.scene import DeviceScene
from ..ops.debug_shading import MISS_COLOR, shade_debug
from ..ops.intersect import hit_record, intersect_bruteforce
from ..ops.rays import generate_rays, generate_rays_tiled, pick_schedule


def isect_kwargs(fn, tile_r):
    """Kwargs to pass a primary-schedule ray-chunk override to ``fn``.

    Intersect fns are user-supplied callables; only those that declare a
    ``tile_r`` parameter (the BVH closures, the brute-force default) get
    the override — third-party fns with the plain ``(origins, dirs,
    geometry)`` signature keep working."""
    import inspect

    if tile_r is None:
        return {}
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return {}
    return {"tile_r": tile_r} if "tile_r" in params else {}


def untile(flat, width: int, height: int, tile):
    """Tile-major (H*W, C) -> raster (H, W, C) via reshape/permute."""
    if tile is None:
        return flat.reshape(height, width, -1)
    th, tw = tile
    c = flat.shape[-1]
    return (
        flat.reshape(height // th, width // tw, th, tw, c)
        .permute(0, 2, 1, 3, 4)
        .reshape(height, width, c)
    )


def render_debug(dscene: DeviceScene, cam_position, cam_rotation, mode: int,
                 width: int, height: int, intersect_fn=None,
                 fetch_record: bool = True):
    """Render one debug-shaded frame.

    Args:
      dscene: device scene tensors; the frame runs on their device.
      cam_position, cam_rotation: camera snapshot ((3,), (3,3)).
      mode: shading mode 0..6.
      intersect_fn: optional ``(origins, dirs, geometry, tile_r=None) ->
        Hit`` (e.g. the BVH intersector; ``tile_r`` is passed only to
        callables that declare it); defaults to brute force.
      fetch_record: fetch the fused hit record (exact t/u/v + ids, needed
        by modes 0-3).  Modes 4-6 read only the hit distance, so callers
        that know the mode pass ``mode <= 3`` to skip the frame's largest
        gather.

    Returns:
      (H, W, 3) f32 image in [0, 1].
    """
    geo = dscene.geometry
    device = geo.woop.device
    tile, tile_r = pick_schedule(height, width)
    if tile is None:
        origins, dirs = generate_rays(cam_position, cam_rotation, width,
                                      height, device=device)
    else:
        origins, dirs = generate_rays_tiled(cam_position, cam_rotation, width,
                                            height, tile[0], tile[1],
                                            device=device)
    if intersect_fn is None:
        hit = intersect_bruteforce(origins, dirs, geo.woop)
    else:
        hit = intersect_fn(origins, dirs, geo,
                           **isect_kwargs(intersect_fn, tile_r))

    if fetch_record:
        hit2, local_id, mesh_id, _, _ = hit_record(origins, dirs, geo.packed,
                                                   hit)
        t, u, v = hit2.t, hit2.u, hit2.v
    else:
        zero = torch.zeros_like(hit.tri)
        t, u, v, local_id, mesh_id = hit.t, hit.u, hit.v, zero, zero

    color = shade_debug(mode, origins, dirs, t, u, v, local_id, mesh_id)
    miss = torch.tensor(MISS_COLOR, dtype=torch.float32, device=device)
    color = torch.where(hit.mask[:, None], color, miss)
    return untile(color, width, height, tile)
