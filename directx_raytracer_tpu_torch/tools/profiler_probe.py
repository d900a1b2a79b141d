"""How many device records torch.profiler loses at the start of a window,
and what that depends on.

``chip_smoke.py`` times the binning kernel by its device records in a
profiler window, and late in its run such windows came back short or
empty.  This probe takes windows of 30 launches of the binning kernel (the
primary batch of ``bench_scene(100_000)`` at 1920x1080) at each stage of a
process's life and prints the records each window returned, three ways: the
30 launches alone, 30 after 8 leading launches (of 38), and 30 in a window
that follows another window at once.  The stages separate what could matter:
the age of the process (asleep for 40 s, and again for 30 s), the launches
it has made (150,000 small ones), rendering (20 Whitted frames) and earlier
profiler windows over many events (a profiled path-traced sample).

Then, in the aged process, 300 windows of each of two shapes, to count how
often a window loses more than its first few records: 46 launches back to
back, and the shape ``chip_smoke.py`` uses: 16 launches, a synchronize and
a 10 ms sleep, then 30 launches, of which the records after the pause are
counted.  It prints how many windows returned each count.

    python -m directx_raytracer_tpu_torch.tools.profiler_probe

It needs a CUDA device and takes about three minutes.
"""

from __future__ import annotations

import collections
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.pathtrace import pathtrace_tile
from directx_raytracer_tpu_torch.render.renderer import Renderer

SCENE = (100_000, 1920, 1080)
REPS, LEAD = 30, 8
SETTLE_LEAD, SETTLE_S, WINDOWS = 16, 0.010, 300
ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def records(prof) -> list:
    """Start times (us) of the binning kernel's device records, in order."""
    return sorted(e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "bin_lists_kernel" in e.name)


def seen_settled(fn) -> int:
    """Device records after the pause, of ``REPS``, in a window of
    ``SETTLE_LEAD`` launches, a synchronize, a pause and ``REPS``
    launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(SETTLE_LEAD):
            fn()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    starts = records(prof)
    if not starts:
        return 0
    # The timed launches are the run of records that ends the window with
    # no gap of half the pause inside it.
    n = 1
    while n < len(starts) and starts[-n] - starts[-n - 1] < SETTLE_S * 0.5e6:
        n += 1
    return min(n, REPS)


def seen(fn, launches: int, follow: bool = False) -> int:
    """Device records of the binning kernel in one window of ``launches``
    calls of ``fn`` (``follow``: right after a one-launch window)."""
    fn()
    torch.cuda.synchronize()
    if follow:
        with profile(activities=ACTIVITIES):
            fn()
            torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    return len(records(prof))


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profiler_probe: needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    device = torch.device("cuda")
    n_tris, width, height = SCENE
    r = Renderer(testscenes.bench_scene(n_tris, width, height), width, height,
                 device=device)
    tile, tile_r = pick_schedule(height, width)
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, width, height, *tile, device=device)
    o, d, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
    tp, cb = ci.tile_params(o, d, tile_r), ci.cluster_rows(r.bvh.clusters)

    def launch():
        ci.launch_bin_lists(tp, cb, None)

    def probe(stage: str) -> None:
        rows = [(seen(launch, REPS), seen(launch, LEAD + REPS),
                 seen(launch, REPS, follow=True)) for _ in range(3)]
        print(f"[{stage}; process {time.perf_counter() - t0:.1f} s old] records "
              f"of {REPS} / of {LEAD + REPS} / of {REPS} following a window: "
              f"{rows}", flush=True)

    probe("start")
    time.sleep(40)
    probe("after 40 s asleep")
    a = torch.zeros(16, device=device)
    for _ in range(150_000):
        a.add_(1)
    torch.cuda.synchronize()
    probe("after 150,000 small launches")
    for _ in range(20):
        r.render_whitted_frame(max_depth=3)
    torch.cuda.synchronize()
    probe("after 20 Whitted frames")
    gen = torch.Generator(device=device).manual_seed(1)
    with profile(activities=ACTIVITIES) as prof:
        pathtrace_tile(r.dscene, pos, rot, gen, width, height, max_depth=4,
                       intersect_fn=r.intersect_fn,
                       occluder_factory=r.occluder_factory)
        torch.cuda.synchronize()
    probe(f"after a profiled path-traced sample ({len(prof.events())} events)")
    time.sleep(30)
    probe("after 30 s asleep")

    for label, count in (
            (f"{SETTLE_LEAD + REPS} launches back to back, records of all",
             lambda: seen(launch, SETTLE_LEAD + REPS)),
            (f"{SETTLE_LEAD} launches, synchronize, {SETTLE_S * 1e3:.0f} ms "
             f"pause, {REPS} launches, records after the pause of {REPS}",
             lambda: seen_settled(launch))):
        t1 = time.perf_counter()
        hist = collections.Counter(count() for _ in range(WINDOWS))
        print(f"[{WINDOWS} windows, process {t1 - t0:.0f}-"
              f"{time.perf_counter() - t0:.0f} s old] {label}: "
              f"{dict(sorted(hist.items()))} (records: windows)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
