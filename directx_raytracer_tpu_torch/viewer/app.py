"""Viewer application — the DXRTApp / DXRTMainWindow analog.

Counterpart of ``directx_raytracer_tpu/viewer/app.py`` (``load_scene`` and
the ``render`` subcommand, debug modes only); the orbit, interactive,
path-tracing and Whitted commands come with their slices.

    python -m directx_raytracer_tpu_torch.viewer render --builtin bench_scene -o out.png

renders one debug frame to PNG.  All config is CLI flags (the reference
hard-codes everything: scene path DXRTRenderer.cpp:245, 1920x1080 in four
places — SURVEY.md §5 config row).
"""

from __future__ import annotations

import argparse
import logging

from .. import testscenes
from ..io import crtscene
from ..ops.debug_shading import MODE_NAMES
from ..render.renderer import Renderer
from ..utils.image import to_u8, write_png


def load_scene(path: str | None, builtin: str | None):
    if builtin:
        return getattr(testscenes, builtin)()
    if path is None:
        raise SystemExit("a scene file or --builtin is required")
    return crtscene.load(path)


def cmd_render(args):
    scene = load_scene(args.scene, args.builtin)
    base_dir = "." if args.scene is None else args.scene.rsplit("/", 1)[0] or "."
    r = Renderer(scene, width=args.width, height=args.height,
                 device=args.device, base_dir=base_dir)
    write_png(args.output, to_u8(r.render_frame(mode=args.mode)))
    print(f"wrote {args.output} ({r.width}x{r.height}, {MODE_NAMES[args.mode]}, "
          f"{r.device})")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    p = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.viewer",
        description="GPU ray tracing viewer (DirectX-RayTracer capability surface)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("render", help="render one debug frame to PNG")
    sp.add_argument("scene", nargs="?", help=".crtscene file")
    sp.add_argument("--builtin", help="test scene builder name "
                    "(cornell_box, bench_scene, single_triangle, ...)")
    sp.add_argument("--width", type=int, default=None)
    sp.add_argument("--height", type=int, default=None)
    sp.add_argument("--mode", type=int, default=0, choices=range(len(MODE_NAMES)),
                    help="debug shading mode 0-6 (" + ", ".join(
                        f"{i}={n}" for i, n in enumerate(MODE_NAMES)) + ")")
    sp.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    sp.add_argument("--output", "-o", default="frame.png")
    sp.set_defaults(fn=cmd_render)

    args = p.parse_args(argv)
    return args.fn(args)
