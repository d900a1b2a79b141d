"""Viewer application — the DXRTApp / DXRTMainWindow analog.

Counterpart of ``directx_raytracer_tpu/viewer/app.py`` (``load_scene``,
``_build_renderer``, ``_frame``, ``_frame_device`` and the ``render``,
``orbit``, ``interactive``, ``pathtrace`` and ``devices`` subcommands).

The reference is a Qt shell around an idle-timer render loop (DXRTApp.cpp:
109-120) with WASD movement, mouse look, a shading-mode combo and an FPS
status bar.  Headless GPU hosts get the same control surface:

* ``render``   — one frame to PNG (scene path + camera/mode flags);
* ``orbit``    — camera-path scripting: N frames orbiting the scene,
  written as a PNG sequence (and an FPS/Mrays report); ``--profile DIR``
  writes a torch.profiler Chrome trace of the frame loop into DIR, with
  the frames' ``dxrt.`` spans (utils/trace.py) beside the device records;
* ``interactive`` — live ANSI-terminal viewport with WASD/arrow controls,
  per-second FPS line, mode switching, frame saving;
* ``pathtrace`` — progressive path-traced render with checkpoint/resume;
* ``devices``  — list the CUDA devices (and the process group, if joined).

    python -m directx_raytracer_tpu_torch.viewer render --builtin bench_scene -o out.png
    python -m directx_raytracer_tpu_torch.viewer pathtrace --builtin bench_scene --samples 16 -o pt.png

All config is CLI flags (the reference hard-codes everything: scene path
DXRTRenderer.cpp:245, 1920x1080 in four places — SURVEY.md §5 config row).
Every command renders on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

import numpy as np
import torch

from .. import testscenes
from ..io import crtscene
from ..ops.debug_shading import MODE_NAMES
from ..render.renderer import Renderer, describe_devices
from ..utils.image import to_u8, write_png

log = logging.getLogger("directx_raytracer_tpu_torch")

MOVE_SPEED = 10.0  # units/sec (DXRTApp.h:61)
SENSITIVITY = 2.0  # degrees per look keypress
SCROLL_SPEED = 0.5  # zoom per keypress (DXRTApp.h:63 scaled)


def load_scene(path: str | None, builtin: str | None):
    if builtin:
        return getattr(testscenes, builtin)()
    if path is None:
        raise SystemExit("a scene file or --builtin is required")
    return crtscene.load(path)


def _build_renderer(args) -> Renderer:
    scene = load_scene(args.scene, args.builtin)
    base_dir = "." if args.scene is None else args.scene.rsplit("/", 1)[0] or "."
    return Renderer(scene, width=args.width, height=args.height,
                    device=args.device, base_dir=base_dir)


def _frame_device(renderer: Renderer, args) -> torch.Tensor:
    """One frame as a u8 tensor on the render device: the 4x smaller image
    is what crosses to the host, and only when a caller needs it there."""
    if args.whitted:
        img, _ = renderer.render_whitted_frame(max_depth=args.depth, spp=args.spp)
    else:
        img = renderer.render_frame(mode=args.mode)
    return renderer.to_u8_device(img)


def _frame(renderer: Renderer, args) -> np.ndarray:
    return _frame_device(renderer, args).cpu().numpy()


def _sync(renderer: Renderer) -> None:
    if renderer.device.type == "cuda":
        torch.cuda.synchronize(renderer.device)


def cmd_render(args):
    r = _build_renderer(args)
    write_png(args.output, _frame(r, args))
    label = "whitted" if args.whitted else MODE_NAMES[args.mode]
    print(f"wrote {args.output} ({r.width}x{r.height}, {label}, {r.device})")


def cmd_orbit(args):
    from torch.profiler import ProfilerActivity, profile

    r = _build_renderer(args)
    target = np.zeros(3, np.float32)
    _frame(r, args)  # build the kernels and warm up outside the timed loop
    profile_cm = contextlib.nullcontext()
    if args.profile:
        activities = [ProfilerActivity.CPU]
        if r.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profile_cm = profile(activities=activities)
    t0 = time.perf_counter()
    with profile_cm as prof:
        # Frames stay on the device as u8: without --output the loop
        # measures render throughput (one final sync); with it, only the u8
        # image crosses per frame.
        for i in range(args.frames):
            img = _frame_device(r, args)
            if args.output:
                write_png(args.output % i if "%" in args.output
                          else f"{args.output}.{i:04d}.png", img)
            r.camera.pan_around_target(360.0 / args.frames, target)
        _sync(r)
    dt = time.perf_counter() - t0
    rays = args.frames * r.width * r.height * (args.spp if args.whitted else 1)
    print(f"{args.frames} frames in {dt:.2f}s -> {args.frames/dt:.1f} FPS, "
          f"{rays/dt/1e6:.1f} Mrays/s")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}")


def cmd_interactive(args):
    from . import tty

    r = _build_renderer(args)
    mode = args.mode
    whitted = args.whitted
    sys.stdout.write(tty.clear_screen())
    last = time.perf_counter()
    status = ""
    pending = None  # device u8 frame in flight (1-frame display pipeline)
    with tty.RawKeyboard(mouse=True) as kb:
        while True:
            now = time.perf_counter()
            dt = min(now - last, 0.25)
            last = now
            had_input = False
            while (key := kb.poll()) is not None:
                had_input = True
                if isinstance(key, tuple):
                    # Mouse-look / wheel-zoom: DXRTViewportWidget.cpp:50-78
                    # semantics (rotate(-yaw, -pitch); wheel up zooms in).
                    # A text cell is ~2 pixels tall in half-block art.
                    if key[0] == "mouse_drag":
                        r.camera.rotate(-key[1] * SENSITIVITY,
                                        -key[2] * 2 * SENSITIVITY)
                    elif key[0] == "mouse_wheel":
                        r.camera.zoom(-key[1] * SCROLL_SPEED)
                    continue
                if key in ("x", "esc"):
                    sys.stdout.write("\n")
                    return
                elif key == "w":
                    r.camera.move_forward(-MOVE_SPEED * dt * 4)
                elif key == "s":
                    r.camera.move_forward(MOVE_SPEED * dt * 4)
                elif key == "a":
                    r.camera.move_right(-MOVE_SPEED * dt * 4)
                elif key == "d":
                    r.camera.move_right(MOVE_SPEED * dt * 4)
                elif key == "left":
                    r.camera.rotate(-SENSITIVITY, 0.0)
                elif key == "right":
                    r.camera.rotate(SENSITIVITY, 0.0)
                elif key == "up":
                    r.camera.rotate(0.0, -SENSITIVITY)
                elif key == "down":
                    r.camera.rotate(0.0, SENSITIVITY)
                elif key == "q":
                    r.camera.zoom(SCROLL_SPEED)
                elif key == "e":
                    r.camera.zoom(-SCROLL_SPEED)
                elif key == "g":
                    whitted = not whitted
                elif key and key.isdigit() and int(key) < len(MODE_NAMES):
                    mode = int(key)
                elif key == "p":
                    args.mode, args.whitted = mode, whitted
                    write_png("frame.png", _frame(r, args))
                    status = "saved frame.png"
            args.mode, args.whitted = mode, whitted
            # 1-frame pipeline: enqueue frame n+1, then copy + draw frame n
            # while the device finishes.  Input flushes the pipeline so a
            # mode/camera change shows immediately instead of displaying one
            # stale frame first.
            if had_input:
                pending = None
            new_pending = _frame_device(r, args)
            img = (pending if pending is not None else new_pending).cpu().numpy()
            pending = new_pending
            r.stats.tick(0)
            sys.stdout.write(tty.home_cursor())
            sys.stdout.write(tty.frame_to_ansi(img))
            label = "whitted" if whitted else MODE_NAMES[mode]
            sys.stdout.write(
                f"\n{label} | {r.stats.fps:5.1f} FPS {r.stats.mrays:7.1f} Mrays/s"
                f" | wasd move, arrows/drag look, q/e/wheel zoom, 0-6 mode,"
                f" g whitted, p save, x quit {status}\x1b[K"
            )
            sys.stdout.flush()


def cmd_pathtrace(args):
    from ..render.pathtrace import PathTracer

    r = _build_renderer(args)
    pt = PathTracer(r.dscene, r.width, r.height, max_depth=args.depth,
                    intersect_fn=r.intersect_fn,
                    occluder_factory=r.occluder_factory, seed=args.seed)
    if args.resume:
        pt.load_state(args.resume)
        print(f"resumed at {pt.n_samples} spp")
    pos, rot = r.camera.snapshot()
    t0 = time.perf_counter()
    done = pt.n_samples
    while pt.n_samples < args.samples:
        pt.step(pos, rot, n=min(args.checkpoint_every,
                                args.samples - pt.n_samples))
        if args.state:
            pt.save_state(args.state)
        _sync(r)
        el = time.perf_counter() - t0
        log.info("%d/%d spp (%.2f s/spp)", pt.n_samples, args.samples,
                 el / max(pt.n_samples - done, 1))
    img = pt.image()
    # simple tonemap: clamp + gamma 2.2 for the PNG
    img = img.clamp(0.0, 1.0) ** (1.0 / 2.2) if args.gamma else img
    write_png(args.output, to_u8(img))
    print(f"wrote {args.output} at {pt.n_samples} spp")


def cmd_devices(args):
    print(describe_devices())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m directx_raytracer_tpu_torch.viewer",
        description="GPU ray tracing viewer (DirectX-RayTracer capability surface)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("scene", nargs="?", help=".crtscene file")
        sp.add_argument("--builtin", help="name of a built-in test scene "
                        "(cornell_box, bench_scene, single_triangle, ...)")
        sp.add_argument("--width", type=int, default=None)
        sp.add_argument("--height", type=int, default=None)
        sp.add_argument("--mode", type=int, default=0,
                        choices=range(len(MODE_NAMES)),
                        help="debug shading mode 0-6 (" + ", ".join(
                            f"{i}={n}" for i, n in enumerate(MODE_NAMES)) + ")")
        sp.add_argument("--whitted", action="store_true",
                        help="full Whitted shading (materials/lights/shadows)")
        sp.add_argument("--depth", type=int, default=5,
                        help="whitted / path tracing max depth")
        sp.add_argument("--spp", type=int, default=1, metavar="N",
                        help="whitted samples per pixel (1 = reference pixel "
                        "center, 4 = RGSS, other N = deterministic Hammersley set)")
        device(sp)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to render on (default cuda)")

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--output", "-o", default="frame.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("orbit", help="render an orbiting camera path")
    common(sp)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the frame "
                    "loop into DIR: its device records and the frames' dxrt. "
                    "spans (raygen, query, shade, occluder, compact, commit)")
    sp.add_argument("--output", "-o", default=None,
                    help="PNG path or printf pattern (omit to benchmark only)")
    sp.set_defaults(fn=cmd_orbit)

    sp = sub.add_parser("interactive", help="live ANSI-terminal viewport")
    common(sp)
    sp.set_defaults(fn=cmd_interactive)

    sp = sub.add_parser("pathtrace", help="progressive path-traced render")
    common(sp)
    sp.add_argument("--samples", type=int, default=64, help="target spp")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--output", "-o", default="pt.png")
    sp.add_argument("--state", default=None,
                    help="accumulation checkpoint path (.npz), saved per chunk")
    sp.add_argument("--resume", default=None, help="checkpoint to resume from")
    sp.add_argument("--checkpoint-every", type=int, default=16)
    sp.add_argument("--gamma", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="gamma-2.2 encode the PNG (--no-gamma = linear)")
    sp.set_defaults(fn=cmd_pathtrace)

    sp = sub.add_parser("devices", help="list the CUDA devices")
    device(sp)
    sp.set_defaults(fn=cmd_devices)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)
