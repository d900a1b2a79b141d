"""Machinery against compute in the closest-hit kernel.

Counterpart of the repository's ``tools/kernel_micro.py``: three runs of
``closest_hit`` on one batch, ``bench_scene(ntris)``'s 1080p primary batch
(2,700 tiles x 768 rays at 100k), which differ only in the list entries
the early-out gate reads:

* ``E_real``: the entries ``bin_lists`` wrote (the production early-out);
* ``E_all``: every entry -inf, so every listed cluster is visited (a
  warp still skips the tests of a cluster its rays cannot hit, by the cull);
* ``E_none``: every entry +inf, so every work item stops at its first
  position and tests nothing.

``E_none`` is the machinery (the schedule, the item loop, the first
staging of rows, the merge); ``E_all - E_none`` the compute of every
listed visit; ``E_all - E_real`` what the early-out saves.  It prints the
machinery per work item, the compute per listed visit and the early-out's
saving.  The JAX tool's loop over MXU operand schemes (``native``,
``bary6``) is the TPU's and is not carried: the card's walk has one.

Each run is the median of ``--reps`` launches, each timed by CUDA events.

    python -m directx_raytracer_tpu_torch.tools.kernel_micro [ntris]
        [--reps 20]

It needs a CUDA device: it times the kernel.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import testscenes
from ..bvh import cuda_intersect as ci
from ..render.renderer import Renderer
from .bench import frame_times
from .exec_stats import HEIGHT, WIDTH, primary_batch, work_items
from .precision_micro import card_label

REPS = 20
WARMUP = 2


def split(e_real: float, e_all: float, e_none: float, items: int,
          listed: int) -> dict:
    """The split of the three runs: machinery per item and compute per
    listed visit (microseconds), the early-out's saving (share of E_all)."""
    return dict(machinery_us_per_item=e_none / max(items, 1) * 1e3,
                compute_us_per_visit=(e_all - e_none) / max(listed, 1) * 1e3,
                early_out_saves=(e_all - e_real) / max(e_all, 1e-12))


def run(r: Renderer, reps: int = REPS) -> dict:
    """The three runs on ``r``'s primary batch; prints and returns them."""
    b = primary_batch(r)
    o, d, t_init, wrows, crows, visit, ventry, counts, tile_r = b.args()
    entries = {"real": ventry,
               "all": torch.full_like(ventry, float("-inf")),
               "none": torch.full_like(ventry, float("inf"))}
    ms = {name: float(np.median(frame_times(
              lambda e=e: ci.closest_hit(o, d, t_init, wrows, crows, visit, e,
                                         counts, tile_r, width=b.width),
              reps, r.device, WARMUP)))
          for name, e in entries.items()}
    items, listed = work_items(counts), int(counts.sum())
    out = dict(e_real_ms=ms["real"], e_all_ms=ms["all"], e_none_ms=ms["none"],
               items=items, listed=listed,
               **split(ms["real"], ms["all"], ms["none"], items, listed))
    card = card_label(r.device)
    n_tris = r.dscene.geometry.n_tris
    print(f"closest_hit at ntris={n_tris} {r.width}x{r.height} primary "
          f"({counts.shape[0]} tiles x {tile_r} rays, {listed} listed visits, "
          f"{items} work items), medians of {reps} launches (CUDA events) "
          f"[{card}]", flush=True)
    print(f"E_real (production early-out) {ms['real']:9.4f} ms", flush=True)
    print(f"E_all  (every listed visit)   {ms['all']:9.4f} ms", flush=True)
    print(f"E_none (every item stops)     {ms['none']:9.4f} ms", flush=True)
    print(f"machinery/item = {out['machinery_us_per_item']:8.4f} us; "
          f"compute/visit = {out['compute_us_per_visit']:8.4f} us; "
          f"early-out saves {out['early_out_saves'] * 100:5.1f}% of E_all",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.kernel_micro",
        description="machinery vs compute split of closest_hit")
    ap.add_argument("ntris", type=int, nargs="?", default=100_000)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_micro: no CUDA device; it times the kernel on the card",
              file=sys.stderr)
        return 1
    scene = testscenes.bench_scene(args.ntris, WIDTH, HEIGHT)
    run(Renderer(scene, WIDTH, HEIGHT, device="cuda"), args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
