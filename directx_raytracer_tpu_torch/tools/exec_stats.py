"""Executed against scheduled visits of the closest-hit kernel.

Counterpart of the repository's ``tools/exec_stats.py``, with the port's
own schedule: each tile's visit list from ``bin_lists`` (near to far, every
overlapping cluster), walked by ``closest_hit`` in work items of
``CLOSEST_CHUNK`` positions.  The JAX tool's rank table, visit budget and
visit group ``g`` are the TPU's schedule and have no counterpart here.

For ``bench_scene(ntris)``'s 1080p primary batch (``Renderer``'s camera
and tile schedule, the rays seeded as ``intersect_fused`` seeds them) it
launches the kernel's counting build (``closest_hit(count_exec=True)``)
and prints, per scene: the scheduled visits (the listed clusters,
``counts.sum()``), the visits the kernel's items executed and their share,
the visits of the plain in-order walk (``closest_hit_plain``), scheduled
and executed (ray, triangle) pairs per ray, the work items, and the cull
share: the 32-ray groups of the executed visits whose triangle tests the
kernel skipped, 1 - tested / (executed x ceil(tile_r / 32)), beside the
plain walk's (the cull's plain twin at the serial walk's best t).  How much
of the scheduled work the near-to-far early-out skips, how much the split
into parallel items gives back (executed - plain walk), and how much of
the rest the cull skips.

    python -m directx_raytracer_tpu_torch.tools.exec_stats [ntris ...]
        [--width 1920] [--height 1080] [--device cuda]

``--device cpu`` runs the plain walk alone (the kernel's counting build
needs the card); its executed count is then the plain walk's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import testscenes
from ..bvh import cuda_intersect as ci
from ..ops.rays import generate_rays_tiled, pick_schedule
from ..render.renderer import Renderer
from .precision_micro import card_label

WIDTH, HEIGHT = 1920, 1080


def ray_batch(r: Renderer, origins, dirs, tile_r: int) -> ci.ClosestQuery:
    """``origins``/``dirs`` padded, seeded and binned over ``r``'s BVH, as
    ``intersect_fused`` builds its query."""
    return ci.closest_query(origins, dirs, r.bvh.clusters, r.bvh.wrows, tile_r,
                            srows=r.bvh.srows, crows=r.bvh.crows)


def primary_batch(r: Renderer) -> ci.ClosestQuery:
    """``r``'s primary batch: its camera's rays in its tile schedule
    (``pick_schedule``), as ``render_frame`` hands them to the query."""
    tile, tile_r = pick_schedule(r.height, r.width)
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, r.width, r.height, *tile,
                               device=r.device)
    return ray_batch(r, o, d, tile_r)


def work_items(counts: torch.Tensor, chunk: int = ci.CLOSEST_CHUNK) -> int:
    """The closest-hit kernel's work items for these lists."""
    return int(((counts.long() + chunk - 1) // chunk).sum())


def cull_share(tested: int, visits: int, tile_r: int) -> float:
    """The share of a batch's 32-ray groups, over ``visits`` visits, whose
    triangle tests the cull skipped."""
    groups = visits * -(-tile_r // ci.CULL_GROUP)
    return 1.0 - tested / max(groups, 1)


def count(b: ci.ClosestQuery) -> dict:
    """Scheduled, executed and plain-walk visits of one batch and the cull
    share of each (the executed count from the kernel's counting build on
    the card, from the plain walk on the CPU), with the per-tile
    tensors."""
    _, _, executed, tested = ci.closest_hit(*b.args(), width=b.width,
                                            count_exec=True)
    _, _, plain, plain_tested = ci.closest_hit_plain(*b.args(),
                                                     count_exec=True)
    k = b.wrows.shape[1]
    rays = b.origins.shape[0]
    scheduled = int(b.counts.sum())
    done = int(executed.sum())
    return dict(tiles=b.counts.shape[0], tile_r=b.tile_r, k=k, rays=rays,
                scheduled=scheduled, executed=done, plain=int(plain.sum()),
                items=work_items(b.counts), longest=b.width,
                share=done / max(scheduled, 1),
                pairs_sched=scheduled * k * b.tile_r / rays,
                pairs_exec=done * k * b.tile_r / rays,
                tested=int(tested.sum()), plain_tested=int(plain_tested.sum()),
                cull=cull_share(int(tested.sum()), done, b.tile_r),
                plain_cull=cull_share(int(plain_tested.sum()),
                                      int(plain.sum()), b.tile_r),
                executed_per_tile=executed, plain_per_tile=plain,
                tested_per_tile=tested, plain_tested_per_tile=plain_tested)


def line(label: str, c: dict, card: str) -> str:
    return (f"{label}: {c['tiles']} tiles x {c['tile_r']} rays, k={c['k']}: "
            f"scheduled visits={c['scheduled']} executed={c['executed']} "
            f"({c['share'] * 100:.1f}%) plain walk={c['plain']}; pairs/ray "
            f"sched={c['pairs_sched']:.1f} exec={c['pairs_exec']:.1f}; "
            f"work items={c['items']}, longest list {c['longest']}; cull "
            f"share {c['cull'] * 100:.1f}% ({c['tested']} 32-ray groups "
            f"tested), plain walk {c['plain_cull'] * 100:.1f}% [{card}]")


def run(r: Renderer, label: str | None = None) -> dict:
    """Count and print the primary batch of ``r``."""
    c = count(primary_batch(r))
    n_tris = r.dscene.geometry.n_tris
    label = label or f"ntris={n_tris} {r.width}x{r.height} primary"
    print(line(label, c, card_label(r.device)), flush=True)
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.exec_stats",
        description="executed vs scheduled visits of closest_hit")
    ap.add_argument("ntris", type=int, nargs="*", default=[100_000, 1_000_000])
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the counting build, default) or cpu (the "
                         "plain walk alone)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("exec_stats: no CUDA device", file=sys.stderr)
        return 1
    for n_tris in args.ntris:
        scene = testscenes.bench_scene(n_tris, args.width, args.height)
        r = Renderer(scene, args.width, args.height, device=device,
                     use_bvh=True, use_kernels=True)
        run(r, f"ntris={n_tris} {args.width}x{args.height} primary")
    return 0


if __name__ == "__main__":
    sys.exit(main())
