"""The binning layer at every batch the frames give it: tile params in,
sorted visit lists and their width out, timed on the card.

Captures on ``bench_scene(100_000)`` at 1920x1080 the primary batch and,
where the depth-3 Whitted frame hands them to the intersector and the
occluder, its bounce batch and its primary and bounce shadow batches; then
``bench_scene(1_000_000)``'s primary batch.  Each batch's tile params are
built as the queries build them.  For each batch it prints:

* ``layer_ms``: CUDA events around one call of the layer, its host sync
  included (median of ``--reps``);
* ``device_ms`` and ``launches``: the device time of every kernel, copy
  and fill the call launches, and how many, from torch.profiler;
* ``kernel_ms``: the device time of the binning kernels among them.

Then, per scene, what the layer sits in: the primary batch's closest-hit
query (``Renderer.intersect_fn``) and the mode-5 frame, each timed by the
host clock to a synchronize, 10th/50th/90th percentile of ``--frames``
calls.

The layer is ``bin_lists``.  On a checkout of the package from before
``bin_lists`` existed it is that version's ``visit_lists(*bin_clusters(...))``:
the (T, C) kernel and the torch sort.  So one call on one card compares two
versions, each put first on ``PYTHONPATH``:

    PYTHONPATH=<checkout> python <this file> [--reps 20]

The last line is one JSON object with every number.  It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import TILE_R
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.ops.rays import T_MIN, generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.render.whitted import render_whitted

SCENE = (100_000, 1920, 1080)
HUGE_SCENE = (1_000_000, 1920, 1080)


def layer(tp, cb, sb):
    """Tile params to lists: ``bin_lists``, or the version before it."""
    if hasattr(ci, "bin_lists"):
        return ci.bin_lists(tp, cb, sb)
    return ci.visit_lists(*ci.bin_clusters(tp, cb, sb))


def primary_rays(r):
    """The frame's primary rays, tiled as the frame tiles them, and the
    rays per tile."""
    tile, tile_r = pick_schedule(r.height, r.width)
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, r.width, r.height, *tile,
                               device=r.device)
    return o, d, tile_r


def primary_params(r):
    o, d, tile_r = primary_rays(r)
    o, d, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
    return ci.tile_params(o, d, tile_r)


def whitted_params(r):
    """The bounce batch's and both shadow batches' tile params, captured
    where a depth-3 Whitted frame hands the batches over."""
    rays, shadows = [], []

    def isect(o, d, geo, tile_r=None):
        rays.append((o.clone(), d.clone(), tile_r or TILE_R))
        return r.intersect_fn(o, d, geo, tile_r=tile_r)

    def factory(geo):
        occluded = r.occluder_factory(geo)

        def occ(o, d, t_max):
            shadows.append((o.clone(), d.clone(), t_max.clone()))
            return occluded(o, d, t_max)
        return occ

    pos, rot = r.camera.snapshot()
    render_whitted(r.dscene, pos, rot, r.width, r.height, max_depth=3,
                   intersect_fn=isect, occluder_factory=factory)
    o, d, tile_r = rays[1]
    o, d, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
    out = [("100k 1080p Whitted bounce", ci.tile_params(o, d, tile_r))]
    for (o, d, t_max), label in zip(shadows[:2], ("100k 1080p primary shadow",
                                                  "100k 1080p bounce shadow")):
        o, d, t_max, t_cap = ci.pad_and_cap(o, d, t_max, TILE_R)
        out.append((label, ci.tile_params(o, d, TILE_R, t_cap=t_cap,
                                          live=t_max > T_MIN)))
    return out


def time_layer(fn, reps: int) -> dict:
    """layer_ms by CUDA events (median), then device_ms, kernel_ms and
    launches per call from one profiled window of ``reps`` calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / reps
    kernel = sum(e.time_range.elapsed_us() for e in ops
                 if "bin_" in e.name) / 1e3 / reps
    return dict(layer_ms=float(np.median(times)), device_ms=device,
                kernel_ms=kernel, launches=len(ops) / reps)


def host_ms(fn, reps: int) -> list:
    """10th, 50th and 90th percentile of ``fn()`` to a synchronize, by the
    host clock."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return [float(np.percentile(times, q)) for q in (10, 50, 90)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--frames", type=int, default=60)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bin_layer: no CUDA device", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0),
           "layer": "bin_lists" if hasattr(ci, "bin_lists")
           else "bin_clusters + visit_lists", "batches": [], "frames": []}
    for scene in (SCENE, HUGE_SCENE):
        n_tris, width, height = scene
        r = Renderer(testscenes.bench_scene(n_tris, width, height), width,
                     height, device="cuda")
        cb = ci.cluster_rows(r.bvh.clusters)
        sb = r.bvh.srows if cb.shape[1] >= ci.SUPER_MIN_C else None
        label = "100k" if scene == SCENE else "1M"
        o, d, tile_r = primary_rays(r)
        geo = r.dscene.geometry
        rec = dict(scene=f"{label} 1080p",
                   query_ms=host_ms(lambda: r.intersect_fn(o, d, geo,
                                                           tile_r=tile_r),
                                    args.frames),
                   frame_ms=host_ms(lambda: r.render_frame(5), args.frames))
        out["frames"].append(rec)
        print(f"{rec['scene']}: closest-hit query {rec['query_ms'][1]:.4f} ms, "
              f"mode-5 frame {rec['frame_ms'][1]:.4f} ms (host clock, medians "
              f"of {args.frames}; 10th-90th percentile "
              f"{rec['query_ms'][0]:.4f}-{rec['query_ms'][2]:.4f} and "
              f"{rec['frame_ms'][0]:.4f}-{rec['frame_ms'][2]:.4f}) "
              f"[{out['layer']}, {out['device']}]")
        batches = [(f"{label} 1080p primary", primary_params(r))]
        if scene == SCENE:
            batches += whitted_params(r)
        for name, tp in batches:
            rec = dict(batch=name, tiles=tp.shape[0], clusters=cb.shape[1],
                       **time_layer(lambda: layer(tp, cb, sb), args.reps))
            out["batches"].append(rec)
            print(f"{name}: {rec['tiles']} tiles x {rec['clusters']} clusters, "
                  f"layer {rec['layer_ms']:.4f} ms (CUDA events, host sync "
                  f"included), device {rec['device_ms']:.4f} ms in "
                  f"{rec['launches']:.1f} launches, binning kernels "
                  f"{rec['kernel_ms']:.4f} ms [{out['layer']}, {out['device']}]")
        del r, batches
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
