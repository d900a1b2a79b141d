"""Viewer application — the DXRTApp / DXRTMainWindow analog.

Counterpart of ``directx_raytracer_tpu/viewer/app.py`` (``load_scene`` and
the ``render`` subcommand, debug modes and Whitted); the orbit,
interactive and path-tracing commands come with their slices.

    python -m directx_raytracer_tpu_torch.viewer render --builtin bench_scene -o out.png
    python -m directx_raytracer_tpu_torch.viewer render --builtin bench_scene --whitted --depth 3 -o out.png

render one debug frame, or one Whitted frame, to PNG.  All config is CLI flags (the reference
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
    if args.whitted:
        img, _ = r.render_whitted_frame(max_depth=args.depth, spp=args.spp)
    else:
        img = r.render_frame(mode=args.mode)
    write_png(args.output, to_u8(img))
    label = "whitted" if args.whitted else MODE_NAMES[args.mode]
    print(f"wrote {args.output} ({r.width}x{r.height}, {label}, {r.device})")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    p = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.viewer",
        description="GPU ray tracing viewer (DirectX-RayTracer capability surface)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("render", help="render one frame to PNG")
    sp.add_argument("scene", nargs="?", help=".crtscene file")
    sp.add_argument("--builtin", help="test scene builder name "
                    "(cornell_box, bench_scene, single_triangle, ...)")
    sp.add_argument("--width", type=int, default=None)
    sp.add_argument("--height", type=int, default=None)
    sp.add_argument("--mode", type=int, default=0, choices=range(len(MODE_NAMES)),
                    help="debug shading mode 0-6 (" + ", ".join(
                        f"{i}={n}" for i, n in enumerate(MODE_NAMES)) + ")")
    sp.add_argument("--whitted", action="store_true",
                    help="full Whitted shading (materials/lights/shadows)")
    sp.add_argument("--depth", type=int, default=5, help="whitted max depth")
    sp.add_argument("--spp", type=int, default=1, metavar="N",
                    help="whitted samples per pixel (1 = reference pixel "
                    "center, 4 = RGSS, other N = deterministic Hammersley set)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    sp.add_argument("--output", "-o", default="frame.png")
    sp.set_defaults(fn=cmd_render)

    args = p.parse_args(argv)
    return args.fn(args)
