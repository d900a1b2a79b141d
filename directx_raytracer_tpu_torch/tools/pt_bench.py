"""Path-tracer timing on the card: ms per 1080p sample.

Counterpart of the repository's ``tools/pt_bench.py``, with the same flags.
Builds ``bench_scene(--tris)``, its BVH and the kernel-backed intersector
and occluder, takes two warm-up samples, then times ``--samples`` calls of ``pathtrace_tile`` back to back between two
CUDA events and prints their mean beside the card's name and power limit.

    python -m directx_raytracer_tpu_torch.tools.pt_bench [--tris N | --dragon]
        [--width 1920] [--height 1080] [--depth 4] [--samples 3]

``--dragon`` names the reference application's Dragon scene, which this
repository does not hold: the flag is kept and exits with a message.  The
tool needs a CUDA device unless ``--device cpu`` is given (the kernels' plain
versions on the host's clock: a check of the path, not a measurement).
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import testscenes
from ..bvh import build_bvh, make_bvh_intersect_fn, make_bvh_occluder_factory
from ..models.scene import build_device_scene
from ..render.pathtrace import pathtrace_tile
from .precision_micro import card_label, time_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.pt_bench",
        description="ms per path-traced sample")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--dragon", action="store_true")
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("pt_bench: no CUDA device", file=sys.stderr)
        return 1

    if args.dragon:
        print("pt_bench: --dragon needs Scenes/Dragon.crtscene of the reference "
              "application, which is not in this repository", file=sys.stderr)
        return 1
    scene = testscenes.bench_scene(n_tris=args.tris, width=args.width,
                                   height=args.height)
    label = f"{args.tris}tris"
    d = build_device_scene(scene, device)
    bvh = build_bvh(d.geometry)
    isect = make_bvh_intersect_fn(bvh)
    occf = make_bvh_occluder_factory(bvh)
    pos, rot = scene.camera.snapshot()
    gen = torch.Generator(device=device).manual_seed(1)

    def sample():
        return pathtrace_tile(d, pos, rot, gen, args.width, args.height,
                              max_depth=args.depth, intersect_fn=isect,
                              occluder_factory=occf)

    rad = sample()  # builds the kernels at first use
    if not bool(torch.isfinite(rad).all()):
        print("pt_bench: non-finite radiance", file=sys.stderr)
        return 1
    ms = time_launches(sample, args.samples, device)
    print(f"pt {label} {args.width}x{args.height} depth={args.depth}: "
          f"{ms:.4f} ms/sample (mean of {args.samples}) "
          f"[{card_label(device)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
