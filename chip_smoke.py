#!/usr/bin/env python3
"""GPU smoke check of the PyTorch + CUDA port (directx_raytracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions; no
   CUDA device is a failure — nothing falls back to the CPU;
2. build the five CUDA kernels' sources in csrc/ (one nvcc per source,
   all started together, then one link; seconds and the build log
   printed);
3. the binning kernel (bin_lists) and closest_hit against their plain
   torch versions on the card, at the shapes the main path gives them, on
   bench_scene(3_000) at 96x48 and bench_scene(100_000) at 1920x1080 (the
   primary batch); the binning kernel's lists must equal bin_lists_plain's
   exactly;
4. the debug path: Renderer(bench_scene(100_000), 1920, 1080,
   device="cuda").render_frame(mode) for modes 0-6, with launch counters
   reset just before and read just after; frames must be finite and hit
   something; modes 3-6 must match the frame rendered through the plain
   versions, modes 0-2 their hit ids; one PNG is written to the temp dir;
5. timing with CUDA events: mode-5 frame ms and Mrays/s, and each kernel
   beside its plain version;
6. the Whitted path: any_hit against its plain version on a 3k/96x48
   shadow batch; then one 1080p/100k Whitted frame whose batches are
   captured where the frame hands them over (the intersector's calls and
   the occluder's, with the launches each made): the binning kernel at the
   bounce pass's batch and both shadow batches, any_hit at the primary
   and the bounce pass's shadow batches and closest_hit at the bounce
   pass's batch, each against its plain version and timed beside its
   bound; then the same Renderer's render_whitted_frame(max_depth=3) with
   counters reset just before and read just after (bin_clusters,
   closest_hit and any_hit must launch), checked against the frame
   rendered through the plain versions, one PNG, and its frame time;
7. the 1M path: the binning kernel's superblock mode against its plain
   version and its dense mode at bench_scene(1_000_000) 1080p shapes, and
   a synthetic tile listing ~38,000 of 40,000 random boxes (more than the
   kernel sorts in shared memory) in both modes against the plain version;
   then
   Renderer(bench_scene(1_000_000), 1920, 1080,
   device="cuda").render_frame(5) with counters (the superblock mode,
   "bin_clusters_super", must launch), checked against the plain-version frame, closest_hit against
   its plain version at the 1M primary batch, and the frame timed;
8. the precision micro: its entry point (tools.precision_micro.main, the
   kernel's three variants at the tool's shapes, S = 2048 steps) with its
   counters reset just before and read just after (every variant must
   launch), then each variant's kernel against its plain version on the
   same seeded inputs, both timed as runs of calls back to back; the
   highest variant's packed output must also equal the plain version's
   on at least FOLD_AGREE of rays, and its bound is printed a second time
   with the IEEE divide counted at its instruction count;
9. the path-tracing path (run on the 100k Renderer, before phase 7): one
   1080p/100k depth-4 sample whose batches are captured where the sample
   hands them over, printing per pass the alive rays, the listed pairs,
   longest list and work items of its ray and shadow batches; the binning
   kernel, closest_hit and any_hit at the first bounce pass's ray batch and
   shadow batch (diffuse continuations: incoherent rays) against their
   plain versions and timed beside their bounds; one profiled sample for
   each pass's kernel ms; then the port's own entry point,
   viewer.app.main(["pathtrace", "--builtin", "bench_scene", ...]) for 4
   samples with a checkpoint, counters reset just before and read just
   after (bin_clusters, closest_hit and any_hit must launch): the PNG must
   be what the checkpoint, loaded into a second PathTracer, gives, finite,
   non-negative and not all background; 8 depth-1 samples against the
   Whitted depth-1 frame (median abs error < 0.02 over the lit pixels
   whose primary hit is diffuse: at its last depth the Whitted frame
   shades a mirror as diffuse, where the path tracer gives it no direct
   term); and ms per depth-4 sample.

Each kernel's line in the kernels JSON also carries its bound (the least
time the card could take for the same work: bytes over the memory rate or
operations over the peak rate, whichever is larger, computed from this
run's inputs; for closest_hit and any_hit from the pairs their plain walks
visit, for the binning kernel from its slab tests and its sorting
networks' compare-exchanges) and library_ms: null, since no single PyTorch
call computes any of these functions.  The lines of bin_clusters (the
binning kernel's dense mode), bin_clusters_super (its superblock mode),
closest_hit and any_hit also carry "batches", one record per batch they
serve (ms, plain_ms, bound_ms, bound_by and the launches on its path; the
binning records also the layer's ms: the wrapper with its host sync, by
CUDA events); their top-level numbers are
the first batch's.  Each walk batch prints its work items, longest list,
visited of binned pairs and (ray, triangle) tests.  The binning kernel's
ms is its device time from the profiler (torch.profiler's CUDA kernel
records): CUDA events around one call of a launch this short would time
the host's enqueue.

The last lines are the kernels JSON line, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import TILE_R, build_bvh, intersect_fused
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.material import MaterialType
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops.debug_shading import MISS_COLOR
from directx_raytracer_tpu_torch.ops.intersect import hit_record
from directx_raytracer_tpu_torch.ops.rays import T_MIN, generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.debug import render_debug, untile
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer, pathtrace_tile
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.render.whitted import render_whitted
from directx_raytracer_tpu_torch.tools import precision_micro as pm
from directx_raytracer_tpu_torch.utils.image import to_u8, write_png
from directx_raytracer_tpu_torch.viewer.app import main as viewer_main

BIG_SCENE = (100_000, 1920, 1080)
SMALL_SCENE = (3_000, 96, 48)
HUGE_SCENE = (1_000_000, 1920, 1080)
KERNEL_REPS = 20
PLAIN_REPS = 3
FRAME_REPS = 15
WHITTED_DEPTH = 3  # the bench.py:333-366 workload
WHITTED_REPS = 5
HUGE_REPS = 5
PT_DEPTH = 4  # the tools/pt_bench.py workload: 1080p, 100k, depth 4
PT_SAMPLES = 4
PT_REPS = 5
PT_DIRECT_SAMPLES = 8

# Tolerances, kernel vs plain version on the same card and inputs:
# * the binning kernel computes the plain version's slab ops in the same
#   order with IEEE divides and sorts by one total order (entry, then
#   cluster id), so its lists must equal bin_lists_plain's exactly: widths,
#   counts, ids and entry bits.
# * closest_hit contracts a*b+c into FMAs where the plain version rounds
#   twice, so t differs by a few ulps and a triangle edge hit exactly can
#   flip: hit/miss 99.9%, same winner 99%, t within 1e-5 relative on 99.9%
#   of common hits (the winner gate of bench.py:156-164).
HIT_AGREE = 0.999
WINNER_AGREE = 0.99
T_RTOL = 1e-5
T_RTOL_SHARE = 0.999
# * frames: modes 3-6 within 2 u8 levels on 99% of pixels (the golden
#   gate of bench.py:196-206); modes 0-2 hash ids through sin, so their
#   hit_record ids are compared instead, at the winner gate.
PIXEL_LEVELS = 2
PIXEL_AGREE = 0.99
# * any_hit contracts into FMAs as closest_hit does, so a shadow ray grazing
#   a triangle edge may flip: blocked flags agree on >= 99.9% of rays, the
#   reference's own occlusion gate (tests/test_pallas_interpret.py:77).
BLOCKED_AGREE = 0.999
# * Whitted frames vs the plain-version frame: the pixel gate above, and
#   alive rays per pass within 0.1% of the pixel count (a flipped hit or
#   shadow verdict moves at most a few bounce rays).
ALIVE_SHARE = 0.001
# * precision_micro: the kernel and the plain version sum the depth-8
#   products in different orders (the tensor cores in their own), and the
#   tail's cancellation (t = -mm[2K+k] / mm[5K+k] near the 1e-3 threshold)
#   amplifies that: two f32 summation orders of the fold at S = 2048 put
#   the winning t up to 1.3e-4 apart (the plain version against exactly
#   rounded products, on the CPU).  Sentinel sets must be equal and
#   each ray's min t within 1e-3 relative (the repository's t gate,
#   bench.py:156-164) on >= 99.5% of rays: one ray in 256 may take another
#   winner when a candidate sits on the threshold.
FOLD_RTOL = 1e-3
FOLD_AGREE = 0.995
# * a depth-1 path-traced mean against the Whitted depth-1 frame: median
#   abs error over lit pixels (Whitted max channel > 0.02) under 0.02, the
#   gate of tests/test_pathtrace.py:19-33 (the jitter blurs edges).
PT_DIRECT_ERR = 0.02

# The least time the card could take (NVIDIA's data-sheet rates of an
# H100 SXM at its 700 W limit, dense): bytes over the memory rate,
# operations over the f32 rate of the CUDA cores (a multiply-add counts
# two) or the bf16 rate of the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# f32 operations per unit of work, counted from the kernels' sources:
# * one slab test of a (tile, box) pair (bin_clusters.cu ``slab``; the
#   reciprocals are the tile's): per axis 2 subtracts, 4 multiplies, 6
#   min/max, 2 clips of 2 each and 2 to fold into entry and exit; then 6
#   for t_min and the overlap compares;
SLAB_OPS = 60
# * one (ray, triangle) Woop test (csrc/walk.cuh ``woop_test``): 17
#   multiply-adds and 3 multiplies, a negate and a divide, 2 subtracts and
#   5 compares;
PAIR_TEST_OPS = 46
# * one candidate of the precision micro's tail (precision_micro.cu), the
#   divide as one operation; and the instructions nvcc's IEEE f32 divide
#   takes on its fast path, read from the built kernel's SASS (MUFU.RCP,
#   FCHK, five FFMA, the branch over the slow path and the BSSY/BSYNC pair
#   around it), for the bound printed beside it.
FOLD_TAIL_OPS = 14
FOLD_DIVIDE_INSTRS = 10
# * one compare-exchange of the binning kernel's sorting networks (a 64-bit
#   compare and its select).
SORT_CE_OPS = 1


def bound(nbytes: float, f32_ops: float, bf16_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes' time and the
    operations' time.  CUDA-core f32 and tensor-core bf16 work run on
    separate units, so the operations' time is the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(f32_ops / F32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
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
    return float(np.median(times))


def device_ms(fn, name: str, reps: int = KERNEL_REPS) -> float:
    """Median device time of the kernel ``name`` over ``reps`` calls of
    ``fn`` (each launching it once), from torch.profiler's CUDA kernel
    records: no host time in it."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    # The profiler may miss a record at the start of its window.
    require(reps // 2 <= len(times) <= reps,
            f"the profiler saw {len(times)} launches of {name} in {reps} calls")
    return float(np.median(times))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def kernel_inputs(n_tris, width, height, device):
    """The kernels' operands exactly as the main path builds them."""
    scene = testscenes.bench_scene(n_tris, width, height)
    geo = build_device_scene(scene, device).geometry
    bvh = build_bvh(geo)
    tile, tile_r = pick_schedule(height, width)
    pos, rot = scene.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, width, height, *tile, device=device)
    o, d, t_init = ci.pad_and_seed(o, d, bvh.clusters, tile_r)
    tp = ci.tile_params(o, d, tile_r)
    cb = ci.cluster_rows(bvh.clusters)
    return dict(o=o, d=d, t_init=t_init, tp=tp, cb=cb, wrows=bvh.wrows,
                tile_r=tile_r, bvh=bvh, lights=scene.lights)


def lists_equal(got, want) -> bool:
    """The kernel's stride-C lists against the plain version's compact
    ones: widths, counts, and each row's first counts[t] positions (ids,
    and entries as bits)."""
    visit, ventry, counts, width = got
    w_visit, w_ventry, w_counts, w_width = want
    if width != w_width or not torch.equal(counts, w_counts):
        return False
    mine = torch.arange(width, device=counts.device) < counts[:, None]
    return (torch.equal(visit[:, :width][mine], w_visit[mine])
            and torch.equal(ventry[:, :width][mine].view(torch.int32),
                            w_ventry[mine].view(torch.int32)))


def sort_ces(counts) -> int:
    """Compare-exchanges of the binning kernel's bitonic networks for these
    lists: (p / 2) L (L + 1) / 2 for a list of n >= 2 keys, p = 2^L the
    power of two at or above n."""
    n = counts.long()
    n = n[n >= 2]
    if n.numel() == 0:
        return 0
    lg = torch.ceil(torch.log2(n.double())).long()
    return int(((1 << lg) // 2 * lg * (lg + 1) // 2).sum())


def bin_work(tp, cb, sb, counts):
    """(bound, slab tests, compare-exchanges) of one binning launch: the
    bytes are the params and rows read once and the lists and counts
    written; the operations the slab tests (every pair in dense mode; every
    hull, then the clusters of each overlapping superblock) and the
    sort."""
    tiles, c = tp.shape[0], cb.shape[1]
    if sb is None:
        tests = tiles * c
    else:
        _, s_ovl = ci.bin_clusters_plain(tp, sb)
        sizes = torch.full((sb.shape[1],), float(ci.SUPER_BLOCK), device=tp.device)
        sizes[-1] = c - ci.SUPER_BLOCK * (sb.shape[1] - 1)
        tests = s_ovl.numel() + int((s_ovl.float() @ sizes).sum())
    ces = sort_ces(counts)
    moved = (nbytes(tp, cb) + (0 if sb is None else nbytes(sb))
             + 8 * int(counts.sum()) + 4 * (tiles + 1))
    return bound(moved, tests * SLAB_OPS + ces * SORT_CE_OPS), tests, ces


def check_lists(label, tp, cb, sb=None):
    """The binning kernel against bin_lists_plain on one batch (in
    superblock mode also its dense mode): equal, or a failure.  Returns
    the plain lists and the largest entry difference (0)."""
    mode = "dense" if sb is None else "super"
    want = ci.bin_lists_plain(tp, cb, sb)
    runs = [ci.bin_lists(tp, cb, sb, mode=mode)]
    if sb is not None:
        runs.append(ci.bin_lists(tp, cb, mode="dense"))
    torch.cuda.synchronize()
    ok = all(lists_equal(got, want) for got in runs)
    visit, ventry, counts, width = runs[0]
    mine = torch.arange(width, device=tp.device) < counts[:, None]
    err = ((ventry[:, :width][mine] - want[1][mine]).abs().max().item()
           if ok and width else 0.0)
    print(f"[{label}] bin_lists ({mode}): {tp.shape[0]} tiles x {cb.shape[1]} "
          f"clusters, {int(want[2].sum())} listed, longest list {want[3]}; "
          f"equal to bin_lists_plain"
          f"{' and to the dense mode' if sb is not None else ''}: {ok}")
    require(ok, f"bin_lists differs from its plain version at the {label} batch")
    return want, err


def bin_batch(label, tp, cb, sb, launches, card):
    """check_lists, then the kernel timed beside its bound on this batch.
    Returns the batch's record, the plain lists and the entry error."""
    want, err = check_lists(label, tp, cb, sb)
    (bound_ms, bound_by), tests, ces = bin_work(tp, cb, sb, want[2])
    mode = "dense" if sb is None else "super"
    kernel = "bin_lists_kernel"
    rec = dict(
        batch=label, launches=launches,
        ms=device_ms(lambda: ci.launch_bin_lists(tp, cb, sb), kernel),
        layer_ms=time_ms(lambda: ci.bin_lists(tp, cb, sb, mode=mode),
                         KERNEL_REPS),
        plain_ms=time_ms(lambda: ci.bin_lists_plain(tp, cb, sb), PLAIN_REPS,
                         warmup=1),
        bound_ms=bound_ms, bound_by=bound_by)
    if sb is not None:
        rec["dense_ms"] = device_ms(lambda: ci.launch_bin_lists(tp, cb), kernel)
    print(f"bin_lists ({mode}) at the {label} batch: kernel {rec['ms']:.4f} ms "
          + (f"(dense mode {rec['dense_ms']:.4f} ms) " if sb is not None else "")
          + f"(device time, profiler), layer with its host sync "
          f"{rec['layer_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms (medians, "
          f"CUDA events), bound {bound_ms:.4f} ms ({bound_by}: {tests} slab "
          f"tests, {ces} compare-exchanges), {launches} launches on its path "
          f"[{card}]")
    return rec, want, err


def closest_args(o, d, bvh, tile_r):
    """The closest_hit operands of a ray batch, as intersect_fused builds
    them (the lists binned by the plain binner)."""
    o, d, t_init = ci.pad_and_seed(o, d, bvh.clusters, tile_r)
    lists = ci.bin_lists(ci.tile_params(o, d, tile_r),
                         ci.cluster_rows(bvh.clusters), bvh.srows, plain=True)
    return (o, d, t_init, bvh.wrows, *lists[:3], tile_r)


def walk_bytes(args) -> int:
    """The bytes a walk must move: rays, rows, counts and each listed
    (id, entry) once."""
    counts = args[6]
    return nbytes(*args[:4], counts) + 8 * int(counts.sum())


def closest_items(counts) -> int:
    """Work items of the closest_hit kernel for these lists."""
    return int(((counts + ci.CLOSEST_CHUNK - 1) // ci.CLOSEST_CHUNK).sum())


def check_closest(args, label):
    """Kernel vs plain version on one closest-hit batch.  Returns the
    largest t difference among equal winners and the kernel's bound."""
    visit, counts = args[4], args[6]
    bt_k, bs_k = ci.closest_hit(*args)
    work = {}
    bt_p, bs_p = ci.closest_hit_plain(*args, stats=work)
    torch.cuda.synchronize()
    hk, hp = bs_k >= 0, bs_p >= 0
    hit_agree = (hk == hp).float().mean().item()
    both = hk & hp
    same = bs_k[both] == bs_p[both]
    winner = same.float().mean().item() if both.any() else 1.0
    rel = (bt_k[both] - bt_p[both]).abs() / bt_p[both].abs()
    t_share = (rel <= T_RTOL).float().mean().item() if both.any() else 1.0
    max_abs = ((bt_k[both][same] - bt_p[both][same]).abs().max().item()
               if same.any() else 0.0)
    print(f"[{label}] closest_hit: {counts.shape[0]} tiles x {args[-1]} "
          f"rays, longest list {visit.shape[1]}, {closest_items(counts)} work "
          f"items, {int(hp.sum())} hits; "
          f"hit/miss agreement {hit_agree:.6f}, winner agreement "
          f"{winner:.6f}, t within {T_RTOL:g} rel on {t_share:.6f}; the "
          f"walk visits {work['visits']} of {int(counts.sum())} binned pairs, "
          f"{work['tests']} (ray, triangle) tests")
    require(hit_agree >= HIT_AGREE, f"closest_hit hit/miss agreement {hit_agree}")
    require(winner >= WINNER_AGREE, f"closest_hit winner agreement {winner}")
    require(t_share >= T_RTOL_SHARE, f"closest_hit t agreement {t_share}")
    n = args[0].shape[0]
    walk_bound = bound(walk_bytes(args) + 8 * n, work["tests"] * PAIR_TEST_OPS)
    return max_abs, walk_bound


def batch_record(label, kernel, plain, args, walk_bound, launches, card,
                 plain_reps=PLAIN_REPS, plain_warmup=1):
    """Time one kernel and its plain version on one batch."""
    rec = dict(batch=label, launches=launches,
               ms=time_ms(lambda: kernel(*args), KERNEL_REPS),
               plain_ms=time_ms(lambda: plain(*args), plain_reps,
                                warmup=plain_warmup),
               bound_ms=walk_bound[0], bound_by=walk_bound[1])
    print(f"{kernel.__name__} at the {label} batch: kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), {launches} launches on its path (medians, "
          f"CUDA events) [{card}]")
    return rec


def closest_batch(args, label, launches, card, **plain_timing):
    """closest_hit against its plain version on one batch, timed: the
    batch's record and the largest t difference among equal winners."""
    err, walk_bound = check_closest(args, label)
    return batch_record(label, ci.closest_hit, ci.closest_hit_plain, args,
                        walk_bound, launches, card, **plain_timing), err


def kernels_vs_plain(device, card):
    """Phase 3 (+ the kernel half of phase 5): returns per-kernel records
    measured at the main path's 1080p shapes.  closest_hit's launches are
    filled in from the debug path's run."""
    records = {}
    for label, (n_tris, width, height) in (("3k 96x48", SMALL_SCENE),
                                           ("100k 1080p", BIG_SCENE)):
        x = kernel_inputs(n_tris, width, height, device)
        if (n_tris, width, height) != BIG_SCENE:
            lists, _ = check_lists(label, x["tp"], x["cb"])
            check_closest((x["o"], x["d"], x["t_init"], x["wrows"], *lists[:3],
                           x["tile_r"]), label)
            continue
        rec, lists, bin_err = bin_batch("100k 1080p primary", x["tp"], x["cb"],
                                        None, 0, card)
        records["bin_clusters"] = dict(max_abs_err=bin_err, library_ms=None,
                                       batches=[rec])
        args = (x["o"], x["d"], x["t_init"], x["wrows"], *lists[:3],
                x["tile_r"])
        batch, hit_err = closest_batch(args, "100k 1080p primary", 0, card)
        records["closest_hit"] = dict(
            max_abs_err=hit_err, ms=batch["ms"], plain_ms=batch["plain_ms"],
            bound_ms=batch["bound_ms"], bound_by=batch["bound_by"],
            library_ms=None, batches=[batch])
    return records


def main_path(device):
    """Phase 4: the port's main path through its user entry points."""
    n_tris, width, height = BIG_SCENE
    scene = testscenes.bench_scene(n_tris, width, height)
    ci.reset_launch_counts()
    r = Renderer(scene, width, height, device=device)
    frames = [r.render_frame(mode) for mode in range(7)]
    torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    print(f"main path launches: {launches}")
    for name in ("bin_clusters", "closest_hit"):
        require(launches[name] > 0, f"{name} was not launched on the main path")
    require(r.bvh is not None, "main path did not build a BVH")

    miss = torch.tensor(MISS_COLOR, device=device)
    for mode, img in enumerate(frames):
        require(tuple(img.shape) == (height, width, 3), f"mode {mode} shape")
        require(bool(torch.isfinite(img).all()), f"mode {mode} not finite")
        hit_px = int((img != miss).any(dim=-1).sum())
        require(hit_px > 0, f"mode {mode} shows only the miss color")
        print(f"mode {mode}: {hit_px} of {width * height} pixels hit")
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_mode5.png")
    write_png(png, to_u8(frames[5]))
    print(f"wrote {png}")

    def plain_fn(o, d, g, tile_r=None):
        return intersect_fused(o, d, r.bvh.clusters, r.bvh.wrows,
                               tile_r or TILE_R, plain=True)

    pos, rot = r.camera.snapshot()
    for mode in range(3, 7):
        ref = render_debug(r.dscene, pos, rot, mode, width, height,
                           intersect_fn=plain_fn, fetch_record=(mode <= 3))
        diff = np.abs(to_u8(frames[mode]).astype(int) - to_u8(ref).astype(int))
        agree = float(((diff <= PIXEL_LEVELS).all(axis=-1)).mean())
        print(f"mode {mode}: {agree:.6f} of pixels within {PIXEL_LEVELS} "
              f"levels of the plain-version frame")
        require(agree >= PIXEL_AGREE, f"mode {mode} pixel agreement {agree}")

    tile, tile_r = pick_schedule(height, width)
    o, d = generate_rays_tiled(pos, rot, width, height, *tile, device=device)
    geo = r.dscene.geometry
    h_k = r.intersect_fn(o, d, geo, tile_r=tile_r)
    h_p = plain_fn(o, d, geo, tile_r=tile_r)
    _, loc_k, mesh_k, _, _ = hit_record(o, d, geo.packed, h_k)
    _, loc_p, mesh_p, _, _ = hit_record(o, d, geo.packed, h_p)
    same = ((h_k.mask == h_p.mask) & (loc_k == loc_p) & (mesh_k == mesh_p))
    agree = same.float().mean().item()
    print(f"modes 0-2: hit ids agree with the plain version on {agree:.6f} "
          f"of rays")
    require(agree >= WINNER_AGREE, f"modes 0-2 id agreement {agree}")
    return r, launches


def plain_fns(bvh):
    """intersect_fn and occluder_factory through the kernels' plain
    versions, on the card: the reference frames are rendered with them."""
    def intersect(o, d, geo, tile_r=None):
        return intersect_fused(o, d, bvh.clusters, bvh.wrows, tile_r or TILE_R,
                               plain=True, srows=bvh.srows)

    def factory(geo):
        def occluded(o, d, t_max):
            return ci.occluded_fused(o, d, bvh.clusters, bvh.wrows, t_max,
                                     plain=True, srows=bvh.srows)
        return occluded

    return intersect, factory


def frames_agree(img, ref) -> float:
    diff = np.abs(to_u8(img).astype(int) - to_u8(ref).astype(int))
    return float(((diff <= PIXEL_LEVELS).all(axis=-1)).mean())


def any_hit_args(o, d, t_max, bvh):
    """The any_hit operands of a shadow batch, as occluded_fused builds
    them."""
    o, d, t_max, *lists = ci.anyhit_schedule(o, d, t_max, bvh.clusters,
                                             srows=bvh.srows)
    return (o, d, t_max, bvh.wrows, *lists, TILE_R)


def check_any_hit(args, label, must_block=True):
    """Kernel vs plain version on one shadow batch.  Returns whether any
    flag differs and the kernel's bound for this batch."""
    b_k = ci.any_hit(*args)
    work = {}
    b_p = ci.any_hit_plain(*args, stats=work)
    torch.cuda.synchronize()
    agree = (b_k == b_p).float().mean().item()
    armed = int((args[2] > 0).sum())
    counts = args[6]
    items = ci.anyhit_work_items(counts)
    print(f"[{label}] any_hit: {counts.shape[0]} tiles x {args[-1]} rays "
          f"({armed} armed), longest list {args[4].shape[1]}, "
          f"{items[0].shape[0]} work items, "
          f"{int(b_p.sum())} blocked; blocked agreement {agree:.6f}; the "
          f"walk visits {work['visits']} of {int(counts.sum())} binned pairs, "
          f"{work['tests']} (ray, triangle) tests")
    require(agree >= BLOCKED_AGREE, f"any_hit blocked agreement {agree}")
    require(int(b_p.sum()) > 0 or not must_block,
            "the shadow batch blocks no ray")
    walk_bound = bound(walk_bytes(args) + nbytes(*items) + b_k.numel(),
                       work["tests"] * PAIR_TEST_OPS)
    return float((b_k != b_p).any()), walk_bound


def small_shadow_batch(device):
    """3k/96x48: rays from the primary hit points toward the first light."""
    x = kernel_inputs(*SMALL_SCENE, device)
    n = x["o"].shape[0]
    hit = intersect_fused(x["o"], x["d"], x["bvh"].clusters, x["wrows"],
                          x["tile_r"])
    p = x["o"] + x["d"] * torch.where(hit.mask, hit.t, 0.0)[:, None]
    light = torch.tensor(x["lights"][0].position, device=device)
    to_l = light - p
    dist = to_l.norm(dim=1)
    d = (to_l / dist[:, None]).contiguous()
    t_max = torch.where(hit.mask, dist - 2e-3, 0.0)
    require(t_max.shape[0] == n, "shadow batch shape")
    return any_hit_args((p + d * 1e-3).contiguous(), d, t_max, x["bvh"])


def launched(before: dict) -> dict:
    """The kernel launches made since ``before = dict(ci.LAUNCHES)``."""
    return {k: v - before[k] for k, v in ci.LAUNCHES.items()}


def whitted_path(r, card):
    """Phase 6 on the debug path's Renderer (bench_scene(100_000), 1080p)."""
    width, height = r.width, r.height
    check_any_hit(small_shadow_batch(r.device), "3k 96x48")

    # Each pass's ray batch as the frame hands it to the intersector and
    # its shadow batch as direct_lighting hands it to the occluder
    # (Morton-sorted, 4 lights x the pass's rays), with the kernel launches
    # each call made.
    rays, shadows = [], []

    def capturing_isect(o, d, geo, tile_r=None):
        before = dict(ci.LAUNCHES)
        hit = r.intersect_fn(o, d, geo, tile_r=tile_r)
        rays.append((o.clone(), d.clone(), tile_r or TILE_R, launched(before)))
        return hit

    def capturing_occ(geo):
        occluded = r.occluder_factory(geo)

        def occ(o, d, t_max):
            before = dict(ci.LAUNCHES)
            blocked = occluded(o, d, t_max)
            shadows.append((o.clone(), d.clone(), t_max.clone(),
                            launched(before)))
            return blocked
        return occ

    pos, rot = r.camera.snapshot()
    render_whitted(r.dscene, pos, rot, width, height, max_depth=WHITTED_DEPTH,
                   intersect_fn=capturing_isect, occluder_factory=capturing_occ)
    require(len(rays) >= 2 and len(shadows) >= 2,
            f"the Whitted frame made {len(rays)} intersector and "
            f"{len(shadows)} occluder calls, expected a bounce pass")
    require(shadows[0][0].shape == (r.dscene.lights.n_lights * width * height, 3),
            f"primary shadow batch shape {tuple(shadows[0][0].shape)}")
    cb = ci.cluster_rows(r.bvh.clusters)
    o, d, tile_r, launches = rays[1]
    o, d, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
    rec, _, bin_err = bin_batch("100k 1080p Whitted bounce",
                                ci.tile_params(o, d, tile_r), cb, None,
                                launches["bin_clusters"], card)
    bin_batches = [rec]
    any_batches, err = [], 0.0
    for (o, d, t_max, launches), label in zip(
            shadows[:2], ("100k 1080p primary shadow", "100k 1080p bounce shadow")):
        po, pd, ptm, t_cap = ci.pad_and_cap(o, d, t_max, TILE_R)
        rec, _, e = bin_batch(label, ci.tile_params(po, pd, TILE_R, t_cap=t_cap,
                                                    live=ptm > T_MIN),
                              cb, None, launches["bin_clusters"], card)
        bin_batches.append(rec)
        bin_err = max(bin_err, e)
        del po, pd, ptm, t_cap
        args = any_hit_args(o, d, t_max, r.bvh)
        flag_err, walk_bound = check_any_hit(args, label,
                                             must_block=not any_batches)
        err = max(err, flag_err)
        any_batches.append(batch_record(label, ci.any_hit, ci.any_hit_plain,
                                        args, walk_bound, launches["any_hit"],
                                        card))
        del args
    primary = any_batches[0]
    record = dict(max_abs_err=err, ms=primary["ms"],
                  plain_ms=primary["plain_ms"], bound_ms=primary["bound_ms"],
                  bound_by=primary["bound_by"], library_ms=None,
                  batches=any_batches)
    o, d, tile_r, launches = rays[1]
    bounce, bounce_err = closest_batch(closest_args(o, d, r.bvh, tile_r),
                                       "100k 1080p Whitted bounce",
                                       launches["closest_hit"], card)
    del rays, shadows

    ci.reset_launch_counts()
    img, stats = r.render_whitted_frame(max_depth=WHITTED_DEPTH)
    torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    print(f"whitted path launches: {launches}")
    for name in ("bin_clusters", "closest_hit", "any_hit"):
        require(launches[name] > 0, f"{name} was not launched on the Whitted path")
    alive, dropped = stats["alive"].tolist(), stats["dropped"].tolist()
    print(f"whitted stats: alive per pass {alive}, dropped per pass {dropped}")
    require(tuple(img.shape) == (height, width, 3), "whitted shape")
    require(bool(torch.isfinite(img).all()), "whitted frame not finite")
    bg = r.dscene.background_color
    shaded = int((img != bg).any(dim=-1).sum())
    require(shaded > 0, "whitted frame is all background")
    print(f"whitted: {shaded} of {width * height} pixels not background")
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_whitted.png")
    write_png(png, to_u8(img))
    print(f"wrote {png}")

    isect, occf = plain_fns(r.bvh)
    ref, ref_stats = render_whitted(r.dscene, pos, rot, width, height,
                                    max_depth=WHITTED_DEPTH, intersect_fn=isect,
                                    occluder_factory=occf)
    agree = frames_agree(img, ref)
    gap = int((stats["alive"] - ref_stats["alive"]).abs().max())
    print(f"whitted: {agree:.6f} of pixels within {PIXEL_LEVELS} levels of the "
          f"plain-version frame; plain alive {ref_stats['alive'].tolist()}, "
          f"largest alive gap {gap}")
    require(agree >= PIXEL_AGREE, f"whitted pixel agreement {agree}")
    require(gap <= ALIVE_SHARE * width * height, f"whitted alive gap {gap}")

    frame_ms = time_ms(lambda: r.render_whitted_frame(max_depth=WHITTED_DEPTH),
                       WHITTED_REPS)
    print(f"whitted depth-{WHITTED_DEPTH} frame at {width}x{height}, "
          f"bench_scene(100_000): {frame_ms:.4f} ms median of {WHITTED_REPS} "
          f"[{card}]")
    return record, (bounce, bounce_err), (bin_batches, bin_err), launches


def pass_kernel_ms(fn) -> list:
    """Device ms of the hand-written kernels in one call of ``fn``, in
    launch order, as (kernel, ms) pairs (torch.profiler's CUDA records)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    own = ("bin_lists", "closest_hit", "any_hit")
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(k in e.name for k in own)),
                    key=lambda e: e.time_range.start)
    return [(next(k for k in own if k in e.name),
             e.time_range.elapsed_us() / 1e3) for e in events]


def pt_path(r, card):
    """Phase 9 on the debug path's Renderer (bench_scene(100_000), 1080p)."""
    width, height, device = r.width, r.height, r.device
    pos, rot = r.camera.snapshot()
    cb = ci.cluster_rows(r.bvh.clusters)

    # Each pass's ray batch and shadow batch as the sample hands them over
    # (kept for the first bounce pass only), with the size of their lists.
    passes, kept = [], {}

    def capturing_isect(o, d, geo, tile_r=None):
        before = dict(ci.LAUNCHES)
        hit = r.intersect_fn(o, d, geo, tile_r=tile_r)
        made = launched(before)
        tr = tile_r or TILE_R
        po, pd, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tr)
        _, _, counts, longest = ci.bin_lists(ci.tile_params(po, pd, tr), cb)
        passes.append(dict(alive=o.shape[0], tiles=counts.shape[0], tile_r=tr,
                           listed=int(counts.sum()), longest=longest,
                           items=closest_items(counts)))
        if len(passes) == 2:
            kept["rays"] = (o.clone(), d.clone(), tr, made)
        return hit

    def capturing_occ(geo):
        occluded = r.occluder_factory(geo)

        def occ(o, d, t_max):
            before = dict(ci.LAUNCHES)
            blocked = occluded(o, d, t_max)
            made = launched(before)
            counts = ci.anyhit_schedule(o, d, t_max, r.bvh.clusters,
                                        srows=r.bvh.srows)[5]
            passes[-1].update(
                shadow_rays=o.shape[0], shadow_armed=int((t_max > T_MIN).sum()),
                shadow_tiles=counts.shape[0], shadow_listed=int(counts.sum()),
                shadow_longest=int(counts.max()),
                shadow_items=ci.anyhit_work_items(counts)[0].shape[0])
            if len(passes) == 2:
                kept["shadow"] = (o.clone(), d.clone(), t_max.clone(), made)
            return blocked
        return occ

    def sample(seed, isect=r.intersect_fn, occf=r.occluder_factory):
        gen = torch.Generator(device=device).manual_seed(seed)
        return pathtrace_tile(r.dscene, pos, rot, gen, width, height,
                              max_depth=PT_DEPTH, intersect_fn=isect,
                              occluder_factory=occf)

    sample(1, capturing_isect, capturing_occ)
    require(len(passes) == PT_DEPTH and "shadow" in kept,
            f"the PT sample ran {len(passes)} passes, expected {PT_DEPTH}")
    # A pass launches bin_lists, closest_hit, bin_lists, any_hit, in order
    # (the profiler may miss a record at the start of its window: one more
    # profiled sample is taken then).
    order = ["bin_lists", "closest_hit", "bin_lists", "any_hit"] * PT_DEPTH
    kernel_ms = pass_kernel_ms(lambda: sample(1))
    if [k for k, _ in kernel_ms] != order:
        kernel_ms = pass_kernel_ms(lambda: sample(1))
    require([k for k, _ in kernel_ms] == order,
            f"the profiled PT sample's kernels: {[k for k, _ in kernel_ms]}")
    for i, p in enumerate(passes):
        ms = [f"{m:.4f}" for _, m in kernel_ms[4 * i:4 * i + 4]]
        print(f"PT pass {i}: {p['alive']} alive rays in {p['tiles']} tiles x "
              f"{p['tile_r']}: {p['listed']} listed pairs, longest list "
              f"{p['longest']}, {p['items']} work items; bin_lists "
              f"{ms[0]} ms, closest_hit {ms[1]} ms; shadow batch "
              f"{p['shadow_rays']} rays ({p['shadow_armed']} armed) in "
              f"{p['shadow_tiles']} tiles: {p['shadow_listed']} listed pairs, "
              f"longest list {p['shadow_longest']}, {p['shadow_items']} work "
              f"items; bin_lists {ms[2]} ms, any_hit {ms[3]} ms "
              f"(device time, profiler) [{card}]")

    # The kernels at the first bounce pass's batches, against their plain
    # versions (one timed plain call each: the walks are long here).
    label = "100k 1080p PT bounce"
    o, d, tile_r, launches = kept["rays"]
    po, pd, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
    rec, _, bin_err = bin_batch(label, ci.tile_params(po, pd, tile_r), cb, None,
                                launches["bin_clusters"], card)
    bin_batches = [rec]
    del po, pd
    closest, closest_err = closest_batch(
        closest_args(o, d, r.bvh, tile_r), label, launches["closest_hit"], card,
        plain_reps=1, plain_warmup=0)
    label = "100k 1080p PT bounce shadow"
    o, d, t_max, launches = kept["shadow"]
    po, pd, ptm, t_cap = ci.pad_and_cap(o, d, t_max, TILE_R)
    rec, _, e = bin_batch(label, ci.tile_params(po, pd, TILE_R, t_cap=t_cap,
                                                live=ptm > T_MIN),
                          cb, None, launches["bin_clusters"], card)
    bin_batches.append(rec)
    bin_err = max(bin_err, e)
    del po, pd, ptm, t_cap
    args = any_hit_args(o, d, t_max, r.bvh)
    any_err, walk_bound = check_any_hit(args, label)
    any_rec = batch_record(label, ci.any_hit, ci.any_hit_plain, args,
                           walk_bound, launches["any_hit"], card,
                           plain_reps=1, plain_warmup=0)
    del args, kept, o, d, t_max
    torch.cuda.empty_cache()

    # The port's own entry point, with a checkpoint.
    tmp = tempfile.gettempdir()
    png = os.path.join(tmp, "chip_smoke_pt.png")
    state = os.path.join(tmp, "chip_smoke_pt.npz")
    ci.reset_launch_counts()
    viewer_main(["pathtrace", "--builtin", "bench_scene", "--width", str(width),
                 "--height", str(height), "--depth", str(PT_DEPTH),
                 "--samples", str(PT_SAMPLES), "--state", state, "-o", png])
    torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    print(f"PT path launches ({PT_SAMPLES} samples): {launches}")
    for name in ("bin_clusters", "closest_hit", "any_hit"):
        require(launches[name] > 0, f"{name} was not launched on the PT path")
    resumed = PathTracer(r.dscene, width, height, max_depth=PT_DEPTH,
                         intersect_fn=r.intersect_fn,
                         occluder_factory=r.occluder_factory)
    resumed.load_state(state)
    img = resumed.image()
    require(resumed.n_samples == PT_SAMPLES, f"checkpoint at {resumed.n_samples} spp")
    require(tuple(img.shape) == (height, width, 3), "PT image shape")
    require(bool(torch.isfinite(img).all()), "PT image not finite")
    require(bool((img >= 0).all()), "PT image has negative radiance")
    shaded = int((img != r.dscene.background_color).any(dim=-1).sum())
    require(shaded > 0, "PT image is all background")
    again = os.path.join(tmp, "chip_smoke_pt_resumed.png")
    write_png(again, to_u8(img.clamp(0.0, 1.0) ** (1.0 / 2.2)))
    with open(png, "rb") as a, open(again, "rb") as b:
        same = a.read() == b.read()
    print(f"PT: wrote {png} and {state}; {shaded} of {width * height} pixels "
          f"not background; the checkpoint's image equals the PNG: {same}")
    require(same, "the checkpoint's image differs from the viewer's PNG")
    del resumed

    direct = PathTracer(r.dscene, width, height, max_depth=1,
                        intersect_fn=r.intersect_fn,
                        occluder_factory=r.occluder_factory, seed=1)
    direct.step(pos, rot, n=PT_DIRECT_SAMPLES)
    ref, _ = render_whitted(r.dscene, pos, rot, width, height, max_depth=1,
                            intersect_fn=r.intersect_fn,
                            occluder_factory=r.occluder_factory)
    # Held on the pixels whose primary hit is diffuse: at its last depth the
    # Whitted frame shades the mirror ground as diffuse where the path
    # tracer gives it no direct term, and the sky is equal by construction.
    tile, tile_r = pick_schedule(height, width)
    o, d = generate_rays_tiled(pos, rot, width, height, *tile, device=device)
    geo = r.dscene.geometry
    hit, _, _, _, rec = hit_record(o, d, geo.packed,
                                   r.intersect_fn(o, d, geo, tile_r=tile_r))
    diffuse = hit.mask & (rec[:, 30].to(torch.int32) == MaterialType.DIFFUSE)
    diffuse = untile(diffuse[:, None], width, height, tile)[..., 0]
    lit = (ref.amax(dim=-1) > 0.02) & diffuse
    require(int(lit.sum()) > 0, "no lit diffuse pixel")
    err = float((direct.image() - ref).abs().mean(dim=-1)[lit].median())
    print(f"PT depth 1, {PT_DIRECT_SAMPLES} samples, against the Whitted "
          f"depth-1 frame: median abs error {err:.6f} over the "
          f"{int(lit.sum())} lit pixels of {int(diffuse.sum())} whose primary "
          f"hit is diffuse (gate {PT_DIRECT_ERR})")
    require(err < PT_DIRECT_ERR, f"PT depth-1 error {err}")
    del direct, ref

    pt = PathTracer(r.dscene, width, height, max_depth=PT_DEPTH,
                    intersect_fn=r.intersect_fn,
                    occluder_factory=r.occluder_factory, seed=2)
    sample_ms = time_ms(lambda: pt.step(pos, rot), PT_REPS, warmup=1)
    print(f"PT sample at {width}x{height}, bench_scene(100_000), depth "
          f"{PT_DEPTH}: {sample_ms:.4f} ms median of {PT_REPS}; alive per "
          f"pass {[p['alive'] for p in passes]} [{card}]")
    return ((bin_batches, bin_err), (closest, closest_err), (any_rec, any_err),
            launches)


def huge_path(device, card):
    """Phase 7: bench_scene(1_000_000) at 1080p."""
    n_tris, width, height = HUGE_SCENE
    t0 = time.perf_counter()
    r = Renderer(testscenes.bench_scene(n_tris, width, height), width, height,
                 device=device)
    torch.cuda.synchronize()
    c = r.bvh.clusters.aabb_min.shape[0]
    print(f"1M scene: {c} clusters, {r.bvh.srows.shape[1]} superblocks, "
          f"built in {time.perf_counter() - t0:.1f} s")
    require(c >= ci.SUPER_MIN_C, f"1M scene has only {c} clusters")

    tile, tile_r = pick_schedule(height, width)
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, width, height, *tile, device=device)
    o, d, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
    tp = ci.tile_params(o, d, tile_r)
    cb = ci.cluster_rows(r.bvh.clusters)
    sb = r.bvh.srows
    rec, _, bin_err = bin_batch("1M 1080p primary", tp, cb, sb, 0, card)
    record = dict(max_abs_err=bin_err, library_ms=None, batches=[rec])
    overflow_check(device, card)

    ci.reset_launch_counts()
    img = r.render_frame(5)
    torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    print(f"1M path launches: {launches}")
    require(launches["bin_clusters_super"] > 0,
            "bin_clusters_super was not launched on the 1M path")
    require(launches["closest_hit"] > 0, "closest_hit was not launched on the 1M path")
    require(bool(torch.isfinite(img).all()), "1M frame not finite")
    miss = torch.tensor(MISS_COLOR, device=device)
    require(int((img != miss).any(dim=-1).sum()) > 0, "1M frame hits nothing")
    isect, _ = plain_fns(r.bvh)
    ref = render_debug(r.dscene, pos, rot, 5, width, height,
                       intersect_fn=isect, fetch_record=False)
    agree = frames_agree(img, ref)
    print(f"1M mode 5: {agree:.6f} of pixels within {PIXEL_LEVELS} levels of "
          f"the plain-version frame")
    require(agree >= PIXEL_AGREE, f"1M pixel agreement {agree}")
    closest = closest_batch(closest_args(o, d, r.bvh, tile_r),
                            "1M 1080p primary", launches["closest_hit"], card)
    frame_ms = time_ms(lambda: r.render_frame(5), HUGE_REPS)
    print(f"mode-5 frame at {width}x{height}, bench_scene(1_000_000): "
          f"{frame_ms:.4f} ms median of {HUGE_REPS}, "
          f"{width * height / frame_ms / 1e3:.2f} Mrays/s [{card}]")
    rec["launches"] = launches["bin_clusters_super"]
    return record, closest, launches


def overflow_case(device, c=40_000):
    """Random (8, c) rows of small boxes in [-500, 500]^3 (5% invalid, box
    floors on a unit grid in z, so entries tie) and three tiles: one whose
    origin slab spans every box in x and y below them all (it lists every
    valid cluster, far more than the kernel sorts in shared memory), one
    parked, one narrow."""
    g = torch.Generator().manual_seed(0)
    lo = torch.rand((3, c), generator=g) * 1000 - 500
    lo[2] = torch.floor(lo[2])
    cb = torch.zeros((8, c))
    cb[0:3] = lo
    cb[3:6] = lo + torch.rand((3, c), generator=g) * 5 + 0.1
    cb[6] = (torch.rand(c, generator=g) > 0.05).float()
    tp = torch.zeros((3, 16))
    tp[0, 0:6] = torch.tensor([-1e3, -1e3, -600.0, 1e3, 1e3, -600.0])
    tp[0, 6:12] = torch.tensor([-0.5, -0.5, 0.5, 0.5, 0.5, 1.0])
    tp[1, 0:6], tp[1, 6:12] = 1e30, 1.0
    tp[2, 0:6] = torch.tensor([0.0, 0.0, -600.0, 10.0, 10.0, -600.0])
    tp[2, 6:12] = torch.tensor([0.1, 0.1, 0.9, 0.2, 0.2, 1.0])
    tp[:, 12], tp[:, 13], tp[:, 14] = 1.0, 1e-3, 1e30
    return tp.to(device), cb.to(device)


def overflow_check(device, card):
    """A tile listing more clusters than the kernel sorts in shared memory
    (its network then runs over the tile's output rows): both modes equal
    the plain lists, no cluster dropped."""
    tp, cb = overflow_case(device)
    sb = ci.super_rows(cb)
    want, _ = check_lists("synthetic 40,000 boxes", tp, cb, sb)
    n_valid = int((cb[6] > 0.5).sum())
    require(int(want[2][0]) == n_valid > 2048,
            f"the overflow tile lists {int(want[2][0])} of {n_valid} clusters")
    ms = device_ms(lambda: ci.launch_bin_lists(tp, cb, sb), "bin_lists_kernel",
                   reps=3)
    print(f"bin_lists (super) with a {n_valid}-cluster list: kernel {ms:.4f} ms "
          f"(device time, profiler) [{card}]")


def precision_path(device, card):
    """Phase 8: the precision micro at the tool's own shapes."""
    pm.reset_launch_counts()
    require(pm.main([]) == 0, "the precision micro's entry point failed")
    torch.cuda.synchronize()
    launches = dict(pm.LAUNCHES)
    print(f"precision micro launches: {launches}")
    for variant in pm.VARIANTS:
        require(launches[variant] > 0,
                f"precision_micro ({variant}) was not launched by its tool")

    w, rays = pm.make_inputs(pm.STEPS, device)
    candidates = w.shape[0] * pm.K * pm.R
    product = 2 * 8 * 6 * candidates
    tail = candidates * FOLD_TAIL_OPS
    moved = nbytes(w, rays) + 4 * pm.R
    bounds = {"highest": bound(moved, product + tail),
              "default": bound(moved, tail, product),
              "split3": bound(moved, tail, 3 * product)}
    records = {}
    for variant in pm.VARIANTS:
        packed = pm.precision_fold(variant, w, rays)
        packed_plain = pm.precision_fold_plain(variant, w, rays)
        got, want = pm.min_t(packed), pm.min_t(packed_plain)
        torch.cuda.synchronize()
        hit = torch.isfinite(want)
        same_miss = torch.equal(torch.isinf(got), ~hit)
        agree = pm.agreement(got, want, FOLD_RTOL)
        diff = (got[hit] - want[hit]).abs()
        rel = (diff / want[hit]).max().item() if hit.any() else 0.0
        print(f"[precision micro S={w.shape[0]}] {variant}: {int(hit.sum())} "
              f"of {pm.R} rays hit, same misses {same_miss}, min t within "
              f"{FOLD_RTOL:g} rel on {agree:.6f} (within 1e-4 on "
              f"{pm.agreement(got, want, 1e-4):.6f}), max rel err {rel:.3e}")
        require(same_miss, f"precision_micro ({variant}) sentinel sets differ")
        require(agree >= FOLD_AGREE,
                f"precision_micro ({variant}) t agreement {agree}")
        if variant == "highest":
            # Full f32 on both sides: most rays pick the same candidate and
            # round it alike, so the packed outputs themselves mostly match.
            equal = (packed == packed_plain).float().mean().item()
            print(f"[precision micro S={w.shape[0]}] highest: packed output "
                  f"equal to the plain version's on {equal:.6f} of rays")
            require(equal >= FOLD_AGREE,
                    f"precision_micro (highest) packed outputs equal on {equal}")
        # A launch takes ~0.1 ms, about what the host needs to enqueue one,
        # so both are timed as runs of calls back to back (ms per call).
        ms = pm.time_launches(lambda: pm.precision_fold(variant, w, rays),
                              KERNEL_REPS, device)
        plain_ms = pm.time_launches(
            lambda: pm.precision_fold_plain(variant, w, rays), PLAIN_REPS,
            device)
        bound_ms, bound_by = bounds[variant]
        print(f"precision_micro {variant} at S={w.shape[0]}: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms (CUDA events around "
              f"{KERNEL_REPS} and {PLAIN_REPS} calls back to back), bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
        records[variant] = dict(
            launches=launches[variant],
            max_abs_err=diff.max().item() if hit.any() else 0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        if variant == "highest":
            longer = bound(moved, product + tail
                           + candidates * (FOLD_DIVIDE_INSTRS - 1))[0]
            print(f"precision_micro highest: bound {longer:.4f} ms with the "
                  f"divide counted as the {FOLD_DIVIDE_INSTRS} instructions it "
                  f"takes, not as 1 operation")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)

    so, seconds = ci.build_kernels()
    print(f"built {so.name} in {seconds:.2f} s")
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    records = kernels_vs_plain(device, card)
    r, launches = main_path(device)
    closest, binner = records["closest_hit"], records["bin_clusters"]
    closest["batches"][0]["launches"] = launches["closest_hit"]
    binner["batches"][0]["launches"] = launches["bin_clusters"]

    frame_ms = time_ms(lambda: r.render_frame(5), FRAME_REPS, warmup=3)
    n_rays = r.width * r.height
    print(f"mode-5 frame at {r.width}x{r.height}, bench_scene(100_000): "
          f"{frame_ms:.4f} ms median of {FRAME_REPS}, "
          f"{n_rays / frame_ms / 1e3:.2f} Mrays/s [{card}]")

    (records["any_hit"], (bounce, bounce_err), (bin_batches, bin_err),
     whitted_launches) = whitted_path(r, card)
    binner["batches"] += bin_batches
    binner["max_abs_err"] = max(binner["max_abs_err"], bin_err)
    ((bin_batches, bin_err), (pt_bounce, pt_bounce_err), (pt_shadow, pt_shadow_err),
     _) = pt_path(r, card)
    binner["batches"] += bin_batches
    binner["max_abs_err"] = max(binner["max_abs_err"], bin_err)
    records["any_hit"]["batches"].append(pt_shadow)
    records["any_hit"]["max_abs_err"] = max(records["any_hit"]["max_abs_err"],
                                            pt_shadow_err)
    del r
    torch.cuda.empty_cache()
    records["bin_clusters_super"], (huge, huge_err), huge_launches = huge_path(
        device, card)
    closest["batches"] += [bounce, pt_bounce, huge]
    closest["max_abs_err"] = max(closest["max_abs_err"], bounce_err,
                                 pt_bounce_err, huge_err)
    torch.cuda.empty_cache()
    variants = precision_path(device, card)

    # Each kernel's launches are read from the path it serves: the debug
    # path (bin_clusters, closest_hit), the Whitted path (any_hit) and the
    # 1M path (bin_clusters_super).
    launches["any_hit"] = whitted_launches["any_hit"]
    launches["bin_clusters_super"] = huge_launches["bin_clusters_super"]
    # The binning kernel's lines carry their first batch's numbers on top.
    for name in ("bin_clusters", "bin_clusters_super"):
        first = records[name]["batches"][0]
        records[name].update({key: first[key] for key in
                              ("ms", "plain_ms", "bound_ms", "bound_by")})
    # The precision micro's line carries its highest variant (full f32, the
    # production fold's precision) and every variant under "variants";
    # its launches are those of its tool's run.
    launches["precision_micro"] = sum(v["launches"] for v in variants.values())
    records["precision_micro"] = {
        **{key: val for key, val in variants["highest"].items()
           if key != "launches"},
        "variants": variants}
    tpu = "directx_raytracer_tpu/bvh/pallas_intersect.py"
    sources = {"bin_clusters": ("csrc/bin_clusters.cu", f"{tpu}:307"),
               "closest_hit": ("csrc/closest_hit.cu", f"{tpu}:762"),
               "any_hit": ("csrc/any_hit.cu", f"{tpu}:1001"),
               "bin_clusters_super": ("csrc/bin_clusters.cu", f"{tpu}:367"),
               "precision_micro": ("csrc/precision_micro.cu",
                                   "tools/precision_micro.py:32")}
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append(dict(name=name, route="cuda",
                            source=f"directx_raytracer_tpu_torch/{src}",
                            replaces=replaces, launches=launches[name],
                            **records[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
