"""Culling granularity: scheduled pairs per ray against the ray-tile size.

Counterpart of the repository's ``tools/cull_stats.py``.  For
``bench_scene(ntris)``'s 1080p primary rays in 8x32 pixel tiles, and for
tiles of ``tile_r`` in (64, 128, 256, 768) consecutive rays, ``bin_lists``
lists each tile's overlapping clusters; it prints the scheduled (ray,
triangle) pairs per ray (mean listed clusters x K), the mean, 99th
percentile and largest clusters per tile, and the work items
``closest_hit`` would take at its ``CLOSEST_CHUNK`` (these replace the JAX
tool's step counts at visit groups g in {4, 8}: the TPU's schedule).  How
much finer tiles cull, and what each size pays in work items.

    python -m directx_raytracer_tpu_torch.tools.cull_stats [ntris ...]
        [--device cuda]

``--device cpu`` bins with the kernel's plain version, in chunks of tiles.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import testscenes
from ..bvh import cuda_intersect as ci
from ..ops.rays import generate_rays_tiled
from ..render.renderer import Renderer
from .exec_stats import HEIGHT, WIDTH, work_items
from .precision_micro import card_label

TILE_RS = (64, 128, 256, 768)
CHUNK = 2048  # tiles per bin_lists call


def counts_at(origins, dirs, cb, tile_r: int, srows=None) -> torch.Tensor:
    """(T,) i32 clusters listed by each tile of ``tile_r`` consecutive rays
    (``bin_lists`` over ``cluster_rows`` ``cb``, in chunks of ``CHUNK``
    tiles); a ragged tail of rays is dropped."""
    tiles = origins.shape[0] // tile_r
    n = tiles * tile_r
    tp = ci.tile_params(origins[:n], dirs[:n], tile_r)
    return torch.cat([ci.bin_lists(tp[s:s + CHUNK], cb, srows)[2]
                      for s in range(0, tiles, CHUNK)])


def stats(counts: torch.Tensor, k: int) -> dict:
    c = counts.double()
    return dict(pairs_per_ray=float(c.mean()) * k, mean=float(c.mean()),
                p99=float(torch.quantile(c, 0.99)), max=int(counts.max()),
                items=work_items(counts))


def run(r: Renderer, tile_rs=TILE_RS) -> dict:
    """The curve for ``r``'s camera and BVH; prints and returns it."""
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, r.width, r.height, 8, 32,
                               device=r.device)
    cs = r.bvh.clusters
    cb = ci.cluster_rows(cs)
    card = card_label(r.device)
    print(f"ntris={r.dscene.geometry.n_tris} C={cb.shape[1]} k={cs.k} "
          f"rays={o.shape[0]} (8x32 pixel tiles) [{card}]", flush=True)
    out = {}
    for tile_r in tile_rs:
        s = out[tile_r] = stats(counts_at(o, d, cb, tile_r, r.bvh.srows), cs.k)
        print(f"  tile_r={tile_r:4d}: pairs/ray={s['pairs_per_ray']:7.1f} "
              f"clusters/tile mean={s['mean']:6.2f} p99={s['p99']:5.0f} "
              f"max={s['max']:5d} work items={s['items']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.cull_stats",
        description="scheduled pairs per ray by ray-tile size")
    ap.add_argument("ntris", type=int, nargs="*", default=[100_000, 1_000_000])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the binning kernel, default) or cpu (its "
                         "plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("cull_stats: no CUDA device", file=sys.stderr)
        return 1
    for n_tris in args.ntris:
        scene = testscenes.bench_scene(n_tris, WIDTH, HEIGHT)
        run(Renderer(scene, WIDTH, HEIGHT, device=device, use_bvh=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
