"""Where a frame's device time goes: torch.profiler over a few frames.

Renders ``bench_scene(100_000)`` at 1920x1080 through ``Renderer`` and
traces ``--frames`` frames of each kind (the depth-3 Whitted frame, the
mode-5 debug frame and one depth-4 path-traced sample, a ``PathTracer``
step built as ``viewer pathtrace`` builds it), then
``bench_scene(1_000_000)``'s mode-5 frame, each after one warm-up frame.  For each kind it prints the
host wall time of the window, the device's busy time (the union of every
kernel's interval) and busy share, and the device time by kernel, largest
first, grouped as the layers of PERF.md §5 name them: the hand-written
kernels by their own names, the rest as ``torch: <kernel name>``; then the
host ops by their own (self) CPU time per frame, largest first.  The last
line is one JSON object with the same numbers.

    python -m directx_raytracer_tpu_torch.tools.profile_frames [--frames 5]

(or ``python <this file>``, profiling the checkout of the package first on
``PYTHONPATH``).

It needs a CUDA device: a profile of the CPU says nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer
from directx_raytracer_tpu_torch.render.renderer import Renderer

SCENE = (100_000, 1920, 1080)
HUGE_SCENE = (1_000_000, 1920, 1080)
# Kernel names of the hand-written kernels (csrc/), as the profiler lists
# them, and the layer each belongs to.
OWN_KERNELS = {"closest_hit": "closest_hit kernel", "any_hit": "any_hit kernel",
               "bin_lists": "bin_lists kernel"}


def layer_of(name: str) -> str:
    for key, layer in OWN_KERNELS.items():
        if key in name:
            return layer
    return f"torch: {name[:60]}"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace(fn, frames: int) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_layer = defaultdict(float)
    calls = defaultdict(int)
    for e in kernels:
        layer = layer_of(e.name)
        by_layer[layer] += e.time_range.elapsed_us() / 1e3 / frames
        calls[layer] += 1
    busy_ms = busy_us((e.time_range.start, e.time_range.end)
                      for e in kernels) / 1e3
    layers = sorted(by_layer.items(), key=lambda kv: -kv[1])
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return dict(frames=frames, wall_ms=wall_ms, busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if wall_ms else 0.0,
                layers=[dict(layer=k, ms_per_frame=v,
                             calls_per_frame=calls[k] / frames)
                        for k, v in layers],
                host=[dict(op=e.key, self_ms_per_frame=e.self_cpu_time_total
                           / 1e3 / frames, calls_per_frame=e.count / frames)
                      for e in host if e.self_cpu_time_total > 0])


def pt_sample(r: Renderer, max_depth: int = 4):
    """One path-traced sample per call, on a PathTracer over ``r``."""
    pt = PathTracer(r.dscene, r.width, r.height, max_depth=max_depth,
                    intersect_fn=r.intersect_fn,
                    occluder_factory=r.occluder_factory)
    return lambda: pt.step(*r.camera.snapshot())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--top", type=int, default=25, help="layers printed per frame kind")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frames: no CUDA device", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0)}
    # kind, scene, and what makes the kind's frame function for a Renderer
    frames = (("whitted_depth3", SCENE,
               lambda r: lambda: r.render_whitted_frame(max_depth=3)),
              ("debug_mode5", SCENE, lambda r: lambda: r.render_frame(5)),
              ("pt_depth4", SCENE, pt_sample),
              ("huge_mode5", HUGE_SCENE, lambda r: lambda: r.render_frame(5)))
    r, built = None, None
    for kind, scene, make in frames:
        if scene != built:
            r = None
            torch.cuda.empty_cache()
            n_tris, width, height = scene
            r = Renderer(testscenes.bench_scene(n_tris, width, height), width,
                         height, device="cuda")
            built = scene
        res = trace(make(r), args.frames)
        out[kind] = res
        print(f"{kind}: {args.frames} frames, wall {res['wall_ms']:.3f} ms, "
              f"device busy {res['busy_ms']:.3f} ms ({100 * res['busy_share']:.1f}%)")
        for row in res["layers"][:args.top]:
            print(f"  {row['ms_per_frame']:9.4f} ms/frame  "
                  f"{row['calls_per_frame']:7.1f} calls/frame  {row['layer']}")
        print("  host ops by self CPU time:")
        for row in res["host"][:args.top]:
            print(f"  {row['self_ms_per_frame']:9.4f} ms/frame  "
                  f"{row['calls_per_frame']:7.1f} calls/frame  {row['op'][:70]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
