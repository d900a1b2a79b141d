"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, one traffic mix, one frame
kind, one cell or one metric sits in a file of its own, found by name:

* ``configs/<config>.json``: the scene (``scene``: a generator in
  ``scenes/<scene>.py``, called with ``args`` and the run's seed), its
  ``source``, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the frame kind (``frame``: its program side in
  ``frames/<frame>.py`` and its plain reference in
  ``reference/<frame>.py``), its ``frame_args``, the camera path
  (``camera``, read by ``traffic.py``) and the frames warmed up and
  traced;
* ``cells/<cell>.json``: how the cell's outputs are compared: frames and
  pixels sampled, each number's limit;
* ``metrics/<metric>.py``: ``read(ctx)`` returns the metric's value, or
  None where the run has nothing for it to read.  A per-layer metric that
  reads the program's own state may also define ``watch(program)``, a
  context manager that the traced run holds open over the profiled frames;
  what it yields is ``ctx.watched[<metric>]``.

Scene data, as a scene generator returns it: ``width``, ``height``,
``background`` (3,), ``camera`` {``position`` (3,), ``rotation`` (3, 3),
columns right, up, forward}, ``meshes`` [{``vertices`` (V, 3) f32,
``indices`` (3T,) i32, ``material``}], ``materials`` [{``type``
(diffuse, reflective, refractive, constant), ``albedo`` (3,), ``smooth``,
``ior``}], ``lights`` [{``position`` (3,), ``intensity``}].

A run: build the scene from the seed, set up the program and warm it up on
poses spread around the camera path (all of it is ``setup_s``), render whole
frames back to back for ``seconds`` (with ``trace``, the first
``trace_frames`` of them under torch.profiler), read the memory peak, read
the metrics, free the program's state, judge a sample of the window's
images against the plain reference, and last look for JAX in ``sys.modules``.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark.traffic import CameraPath

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "directx_raytracer_tpu")
LEAD_LAUNCHES, LEAD_PAUSE_S = 16, 0.010


def load_json(root: Path, kind: str, name: str) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def load_module(root: Path, kind: str, name: str):
    """``<root>/<kind>/<name>.py`` as a module (names may hold '.' and '-')."""
    path = root / kind / f"{name}.py"
    mod_name = "benchmark_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float | None:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def stage(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Cell:
    """A cell as BENCHMARK.json names it, with its files read."""

    name: str
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    root: Path = BENCH_DIR

    @classmethod
    def load(cls, spec: dict, name: str, root: Path = BENCH_DIR) -> "Cell":
        entry = next((w for w in spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name, load_json(root, "configs", entry["config"]),
                   load_json(root, "traffic", entry["traffic"]),
                   load_json(root, "cells", name),
                   mine(spec["end_to_end"]), mine(spec["per_layer"]), root)


@dataclass
class Window:
    """What the measured window saw."""

    seconds: float = 0.0
    frame_s: list = field(default_factory=list)  # CUDA-event (device) times
    setup_s: float = 0.0


@dataclass
class Trace:
    """The profiled frames: device records (name, start us, end us) inside
    the window, the window's length and its frames."""

    kernels: list
    window_us: float
    frames: int
    host: list  # (start us, end us, name) of host ops, sorted by start

    def busy_us(self) -> float:
        return busy_us((s, e) for _, s, e in self.kernels)


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


@dataclass
class Context:
    """What a metric reader gets."""

    cell: Cell
    scene: dict
    program: object
    window: Window
    trace: Trace | None
    watched: dict = field(default_factory=dict)


def read_profile(prof, marker: str, frames: int) -> Trace:
    """The device records and host ops inside the ``marker`` range."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = next(e for e in events if e.name == marker)
    w0, w1 = win.time_range.start, win.time_range.end
    kernels = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
               for e in events if e.device_type == DeviceType.CUDA and e.name != marker
               and e.time_range.start >= w0 and e.time_range.start < w1]
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.name != marker
                  and w0 <= e.time_range.start < w1)
    return Trace(kernels, w1 - w0, frames, host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps of the
    device, each named by the innermost host op running at its middle."""
    by_name: dict = {}
    for name, s, e in trace.kernels:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e) for _, s, e in trace.kernels)
    gaps, end = [], spans[0][0] if spans else 0.0
    for s, e in spans:
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, e)
    gaps = sorted(gaps, reverse=True)[:top]
    starts = [h[0] for h in trace.host]
    named = []
    for length, g0, g1 in gaps:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "no torch op (Python)"
        for j in range(i, max(i - 20000, -1), -1):
            if trace.host[j][1] >= mid:
                name = trace.host[j][2]
                break
        named.append([name[:120], length / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def to_u8(colors: torch.Tensor) -> torch.Tensor:
    """UNORM u8 rounding of linear colours: floor(clamp(c, 0, 1) 255 + 0.5)."""
    return torch.floor(colors.double().clamp(0.0, 1.0) * 255.0 + 0.5).long()


def compare(kept, scene, cell: Cell, rng, device, render=None) -> dict:
    """Judge the kept window images against the plain reference.

    ``kept``: [(pose, (H, W, 3) u8 image)].  For each, ``pixels`` pixels
    drawn from ``rng`` are rendered by the float64 reference.  A pixel is
    off when a channel differs from the reference's u8 value at all; it is
    graded when some channel of the reference's linear
    colour lies strictly inside (0, 1), where an error in the arithmetic can
    show (a debug frame clamps every hit beyond 20 units to white and paints
    misses a flat cyan).  ``off_pct``: the off pixels over the pixels that
    are graded or off.  ``render`` stands in for the program's images (the
    control): a function (pose, px, py) -> (N, 3) u8 values.  Returns the
    numbers compared and the frames whose own share is over the limit."""
    from benchmark.reference.geometry import Triangles

    ref = load_module(cell.root, "reference", cell.traffic["frame"])
    tris = Triangles(scene, device)
    w, h = scene["width"], scene["height"]
    n_pix = int(cell.check["pixels"])
    limit = float(cell.check["limits"]["off_pct"])
    off = counted = frames_off = 0
    for pose, image in kept:
        flat = torch.as_tensor(rng.choice(w * h, size=min(n_pix, w * h), replace=False),
                               device=device)
        px, py = flat % w, flat // w
        linear = ref.render_pixels(tris, scene, pose, px, py, cell.traffic["frame_args"])
        want = to_u8(linear)
        got = image.to(device)[py, px].long() if render is None else render(pose, px, py)
        bad = (got != want).any(dim=1)
        graded = ((linear > 0) & (linear < 1)).any(dim=1)
        n_bad, n_counted = int(bad.sum()), int((bad | graded).sum())
        off += n_bad
        counted += n_counted
        frames_off += 100.0 * n_bad / max(n_counted, 1) > limit
    return {"numbers": {"off_pct": 100.0 * off / max(counted, 1)},
            "frames_off": frames_off}


def control_renderer(scene, cell: Cell, device):
    """The plain reference in TF32 in the program's place: a function
    (pose, px, py) -> (N, 3) u8 values."""
    from benchmark.reference.geometry import Triangles

    ref = load_module(cell.root, "reference", cell.traffic["frame"])
    tris = Triangles(scene, device, "tf32")

    def render(pose, px, py):
        return to_u8(ref.render_pixels(tris, scene, pose, px, py, cell.traffic["frame_args"]))

    return render


def device_info(device) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


class ProfiledWindow:
    """torch.profiler (CPU, and CUDA on the card) over the window's first
    frames.  It opens with untimed launches, a synchronize and a pause (the
    profiler drops a window's first device records), then marks the range
    that counts and opens the metrics' watches (``{name: context manager}``)
    over the same frames."""

    MARKER = "benchmark_window"

    def __init__(self, device, watches: dict | None = None):
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.device(device).type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.__enter__()
        lead = torch.zeros(16, device=device)
        for _ in range(LEAD_LAUNCHES):
            lead.add_(1.0)
        sync(device)
        time.sleep(LEAD_PAUSE_S)
        self.marker = record_function(self.MARKER)
        self.marker.__enter__()
        self.watches = watches or {}
        self.watched = {k: w.__enter__() for k, w in self.watches.items()}

    def close(self, frames: int) -> Trace:
        for w in self.watches.values():
            w.__exit__(None, None, None)
        self.marker.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return read_profile(self.prof, self.MARKER, frames)


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = BENCH_DIR, t_start: float | None = None,
             frame_hook=None) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``t_start``: the process's start on ``time.perf_counter``'s clock (set-up
    is counted from it).  ``frame_hook``: a test's stand-in that may break
    the program's frame function (the fault checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cell = Cell.load(spec, name, root)
    rng_path, rng_check = (np.random.default_rng(s)
                           for s in np.random.SeedSequence(seed).spawn(2))
    torch.zeros(1, device=device)
    stage(f"{torch.device(device).type} initialised at {time.perf_counter() - t_start:.3f} s")
    scene_mod = load_module(root, "scenes", cell.config["scene"])
    scene = scene_mod.build(seed, **cell.config["args"])
    stage(f"scene data built at {time.perf_counter() - t_start:.3f} s")

    frames_mod = load_module(root, "frames", cell.traffic["frame"])
    program = frames_mod.Program(scene, cell.traffic["frame_args"], device)
    frame = program.frame if frame_hook is None else frame_hook(program.frame)
    stage(f"program set up at {time.perf_counter() - t_start:.3f} s")
    path = CameraPath(scene["camera"], cell.traffic["camera"], rng_path)
    for pose in path.warmup(int(cell.traffic["warmup_frames"])):
        frame(pose)
    sync(device)

    n_keep = int(cell.check["frames"])
    kept: list = []
    window = Window()
    trace_frames = int(cell.traffic["trace_frames"])
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in (cell.per_layer if trace else cell.end_to_end)}

    def watches():
        return {k: r.watch(program) for k, r in readers.items() if hasattr(r, "watch")}

    profiled = ProfiledWindow(device, watches()) if trace else None
    watched: dict = {}
    trace_window, trace_start, retakes = None, 0, 1
    window.setup_s = time.perf_counter() - t_start
    stage(f"warmed up; window opens at {window.setup_s:.3f} s")
    t0 = time.perf_counter()
    i = 0
    while True:
        pose = path.pose(i)
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            image = frame(pose)
            ev1.record()
            torch.cuda.synchronize()
            window.frame_s.append(ev0.elapsed_time(ev1) / 1e3)
        else:
            f0 = time.perf_counter()
            image = frame(pose)
            window.frame_s.append(time.perf_counter() - f0)
        t1 = time.perf_counter()
        # Reservoir sample of the window's images, drawn from the seed.
        if i < n_keep:
            kept.append((pose, image))
        else:
            j = int(rng_check.integers(0, i + 1))
            if j < n_keep:
                kept[j] = (pose, image)
        i += 1
        done = t1 - t0 >= seconds
        if profiled is not None and (i - trace_start == trace_frames or done):
            trace_window = profiled.close(i - trace_start)
            watched = profiled.watched
            profiled = None
            # Now and then the profiler returns no device record at all (1
            # window in 300 in a probe on an H100): profile the next frames.
            if cuda and not trace_window.kernels and retakes and not done:
                retakes -= 1
                stage(f"the profiler returned no device record; retaking at frame {i}")
                profiled, trace_start = ProfiledWindow(device, watches()), i
        if done:
            break
    window.seconds = t1 - t0
    device_line = device_info(device)

    ctx = Context(cell, scene, program, window, trace_window, watched)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace and cuda:
        device_line["busy_s"] = trace_window.busy_us() / 1e6
        device_line["window_s"] = trace_window.window_us / 1e6

    out = {"correct": False, "attempted": i, "failed": 0, "metrics": metrics,
           "device": device_line}
    if trace:
        out["breakdown"] = breakdown(trace_window)
    del ctx, program, frame, image, watched
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    stage(f"window: {i} frames in {window.seconds:.3f} s; comparing {len(kept)} frames")
    t_ref = time.perf_counter()
    result = compare(kept, scene, cell, rng_check, device)
    stage(f"comparison took {time.perf_counter() - t_ref:.3f} s")
    stage(f"frames over the limit on their own: {result['frames_off']} of {len(kept)}")
    limits = cell.check["limits"]
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in result["numbers"].items()}
    out["correct"] = all(c["value"] <= c["limit"] for c in out["checks"].values())
    # Last, so that whatever the run loaded after its window counts too.
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"JAX or the JAX package is loaded: {', '.join(found)}")
        self.found = found
