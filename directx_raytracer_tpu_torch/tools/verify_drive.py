"""An end-to-end drive of the public API that writes PNGs to look at.

Counterpart of the repository's ``tools/verify_drive.py``.  Through
``Renderer`` it renders and writes into ``--out``:

1. with ``--dragon PATH`` (the reference application's
   Scenes/Dragon.crtscene, not in this repository), the Dragon loaded by
   ``io.crtscene.load`` (the BVH path): a 480x270 depth-3 Whitted frame
   (``verify_dragon_whitted.png``, with its dropped rays printed) and its
   mode-3 debug frame (``verify_dragon_debug3.png``); skipped otherwise;
2. the Cornell box with its diffuse materials given a Blinn-Phong term
   (specular 0.6, shininess 24), 400x300 at 9 samples a pixel, depth 3
   (``verify_cornell_bp_spp9.png``); the scene must carry the specular term;
3. ``const_color`` at 256x256, depth 1 (``verify_const_color.png``).

    python -m directx_raytracer_tpu_torch.tools.verify_drive [--out DIR]
        [--dragon PATH] [--device cuda]

``--out`` defaults to the system's temporary directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from .. import testscenes
from ..io import crtscene
from ..models.material import MaterialType
from ..render.renderer import Renderer
from ..utils.image import write_png


def tonemap(img: torch.Tensor) -> torch.Tensor:
    return img.clamp(0.0, 1.0) ** (1 / 2.2)


def cornell_specular(width: int = 400, height: int = 300, spp: int = 9,
                     device="cuda", max_depth: int = 3) -> torch.Tensor:
    """The Cornell box, diffuse materials with specular 0.6 and shininess
    24, as a Whitted frame of ``spp`` samples a pixel: (H, W, 3) f32."""
    scene = testscenes.cornell_box(width, height)
    for m in scene.materials:
        if m.type == MaterialType.DIFFUSE:
            m.specular = 0.6
            m.shininess = 24.0
    r = Renderer(scene, width, height, device=device)
    if not r.dscene.has_specular:
        raise AssertionError("the Blinn-Phong Cornell box has no specular term")
    img, _ = r.render_whitted_frame(max_depth, spp)
    return img


def const_color(width: int = 256, height: int = 256,
                device="cuda") -> torch.Tensor:
    """``const_color`` as a depth-1 Whitted frame: (H, W, 3) f32."""
    r = Renderer(testscenes.const_color(width, height), width, height,
                 device=device)
    return r.render_whitted_frame(1)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.tools.verify_drive",
        description="render PNGs through the public API")
    ap.add_argument("--out", default=tempfile.gettempdir(),
                    help="directory of the PNGs (default: the temp directory)")
    ap.add_argument("--dragon", default=None,
                    help="the reference application's Scenes/Dragon.crtscene")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("verify_drive: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)

    def out(name):
        return os.path.join(args.out, name)

    if args.dragon is not None:
        r = Renderer(crtscene.load(args.dragon), 480, 270, device=device)
        img, stats = r.render_whitted_frame(3)
        write_png(out("verify_dragon_whitted.png"), tonemap(img))
        print(f"dragon whitted: dropped = {int(stats['dropped'].sum())}")
        write_png(out("verify_dragon_debug3.png"), r.render_frame(3))
    else:
        print("dragon: skipped (no --dragon)")

    write_png(out("verify_cornell_bp_spp9.png"),
              tonemap(cornell_specular(device=device)))
    write_png(out("verify_const_color.png"), const_color(device=device))
    print(f"wrote {out('verify_*.png')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
