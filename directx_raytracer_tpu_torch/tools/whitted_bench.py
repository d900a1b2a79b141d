"""Whitted frame timing: ms per frame of ``Renderer.render_whitted_frame``.

Counterpart of the repository's ``tools/whitted_bench.py`` (1080p, depth 3,
4 lights, ``bench_scene(100_000)``).  Builds the scene's ``Renderer`` (the
kernel-backed intersector and occluder), takes 3 warm frames, times
``--frames`` frames one by one with CUDA events and prints the median,
fastest and slowest frame, frames per second and primary Mrays/s beside
the card's name and power limit.

    python -m directx_raytracer_tpu_torch.tools.whitted_bench
        [--width 1920] [--height 1080] [--depth 3] [--tris 100000]
        [--frames 3] [--spp 1] [--isect-tile-r R] [--device cuda]

``--isect-tile-r`` sets the rays per tile of the bounce passes' closest-hit
queries (the port's bounce tile, 256 by default, at most 768); the primary
pass keeps its own schedule.  The JAX tool's ``--occ-tile-r``,
``--occ-budget`` and ``--chunk-div`` tune the TPU's fixed visit budget and
its bounce chunking, which the port does not have, so they are left out.
The tool needs a CUDA device unless ``--device cpu`` is given (the
kernels' plain versions on the host's clock: a check of the path, not a
measurement).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import testscenes
from ..render.renderer import Renderer
from .bench import frame_times
from .precision_micro import card_label

FRAMES = 3


def bounce_tile(r: Renderer, isect_tile_r: int | None) -> None:
    """Make ``r``'s bounce passes query ``isect_tile_r`` rays a tile (the
    primary pass names its own tile_r and keeps it); None leaves ``r``."""
    if isect_tile_r is None:
        return
    isect = r.intersect_fn

    def intersect(o, d, geo, tile_r=None):
        return isect(o, d, geo, tile_r=tile_r or isect_tile_r)

    r.intersect_fn = intersect


def run(r: Renderer, depth: int = 3, spp: int = 1, frames: int = FRAMES) -> dict:
    """Time ``frames`` Whitted frames of ``r``; prints and returns the
    frame times."""
    ms = frame_times(lambda: r.render_whitted_frame(depth, spp), frames,
                     r.device)
    med = float(np.median(ms))
    rays = r.width * r.height * spp
    out = dict(ms=med, min_ms=min(ms), max_ms=max(ms), frames=frames,
               fps=1e3 / med, mprimary=rays / med / 1e3)
    print(f"whitted {r.width}x{r.height} depth={depth} spp={spp} "
          f"tris={r.dscene.geometry.n_tris}: {med:.4f} ms/frame median of "
          f"{frames} (min {out['min_ms']:.4f}, max {out['max_ms']:.4f}) "
          f"({out['fps']:.2f} FPS, {out['mprimary']:.1f} Mprimary/s) "
          f"[{card_label(r.device)}]", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.whitted_bench",
        description="ms per Whitted frame (the JAX tool's --occ-tile-r, "
                    "--occ-budget and --chunk-div tune the TPU's visit budget "
                    "and bounce chunking, which the port does not have)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--isect-tile-r", type=int, default=None,
                    help="rays per tile of the bounce passes' closest-hit "
                         "queries (default 256, at most 768)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("whitted_bench: no CUDA device", file=sys.stderr)
        return 1
    scene = testscenes.bench_scene(args.tris, args.width, args.height)
    r = Renderer(scene, args.width, args.height, device=device,
                 use_kernels=True)
    bounce_tile(r, args.isect_tile_r)
    run(r, args.depth, args.spp, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
