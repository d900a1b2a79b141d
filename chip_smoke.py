#!/usr/bin/env python3
"""GPU smoke check of the PyTorch + CUDA port (directx_raytracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py multi`` runs phases 1, 2 and 10 alone and prints no
kernels line: on a host with four cards its four processes take a card each
and talk over nccl, which one card cannot show.)

Phases, each of which raises (exit code != 0) on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions; no
   CUDA device is a failure — nothing falls back to the CPU;
2. build the four CUDA kernel sources in csrc/ (one nvcc per source,
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
   the occluder's, with the launches each made; shadow_keys and
   shadow_rays must launch once each a shadow batch): the binning kernel at the
   bounce pass's batch and both shadow batches, any_hit at the primary
   and the bounce pass's shadow batches and closest_hit at the bounce
   pass's batch, each against its plain version and timed beside its
   bound; at each shadow batch any_hit's blocked flags must equal, bit for
   bit, those of its run with cull boxes that drop nothing and those of
   its counting build (any_hit_exec), whose 32-ray groups tested stay
   within the open groups of each tile; the cull share (1 - tested / open
   groups) is printed beside the plain walk's, and the kernel is timed
   beside its run without the cull and beside its counting build; then the same Renderer's render_whitted_frame(max_depth=3) with
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
   plain versions and timed beside their bounds; the draw kernel pt_draws
   (one launch for the jitter, one a pass) at the queues the primary pass
   and the first bounce hand it, bit-equal to its twin pt_draws_plain
   (and the jitter to jitter_plain), timed beside its bound; the shadow
   batch's kernels shadow_keys and shadow_rays (one launch each a shadow
   batch) at the operands the primary pass (2,073,600 points x 4 lights)
   and the first bounce hand them, bit-equal to their plain chains on the
   card, each timed beside its bound and the chain; one profiled sample
   for each pass's kernel ms, printed beside the cull share of its shadow
   batch from any_hit_exec (whose blocked flags must equal the frame's);
   then the port's own entry point,
   viewer.app.main(["pathtrace", "--builtin", "bench_scene", ...]) for 4
   samples with a checkpoint, counters reset just before and read just
   after (bin_clusters, closest_hit, any_hit, pt_draws, shadow_keys and
   shadow_rays must launch, the last two once each a shadow batch):
   the PNG must be what the checkpoint, loaded into a second PathTracer,
   gives, finite, non-negative and not all background; 8 depth-1 samples against the
   Whitted depth-1 frame (median abs error < 0.02 over the lit pixels
   whose primary hit is diffuse: at its last depth the Whitted frame
   shades a mirror as diffuse, where the path tracer gives it no direct
   term); and ms per depth-4 sample;
10. multi-device rendering on the card (run on the 100k scene, before
   phase 7): first, in this process, the last rank's shard of the Whitted
   frame and of the path-traced accumulation (whitted_shard,
   pathtrace_shard) with the batches captured where the shard hands them
   over: the binning kernel, closest_hit and any_hit against their plain
   versions, timed beside their bounds, at the 540-row stripe's primary
   batch (640-ray tiles, its own schedule, under a sample offset) and
   primary shadow batch and at the stripe's first path-tracing bounce and
   its shadow batch; then parallel.launch starts a 2 x 2 (tiles x samples) grid of four
   processes, all on cuda:0 and joined over gloo (NCCL refuses two ranks on
   one device), each of which builds bench_scene(100_000) on the card and
   calls render_whitted_multichip (1920x1080, depth 3, spp 4) through the
   BVH kernels, with its own launch counters reset just before and read
   just after: every rank must have rendered on the card and launched
   bin_clusters, closest_hit and any_hit; rank 0's frame must match the
   single-process render_whitted(spp=4) frame at the frame gate and to
   1e-4 a value, and the summed alive counts must match; then
   pathtrace_multichip (spp 4, depth 4) on the same grid: finite,
   non-negative, not all background, equal to 1e-5 to the sum of
   pathtrace_shard over every (t, s) made in this process (the same
   seeds), and its block means (the statistic of
   tests/test_sharding.py:118-125) within 0.01 of a single-process 4-sample
   PathTracer image's; wall seconds per call; a failing rank fails the run;
11. the checks: with DXRT_CHECK=1 the Renderer's Whitted frame is clean and
   equals the unarmed frame; a NaN light intensity raises CheckError
   ("non-finite"); armed and unarmed frame ms;
12. the native parser: bench_scene(100_000) written with the port's dumps,
   loaded with the native C++ parser (built with g++ here) and with the
   Python parser: equal field for field; both parse times;
13. the oracles on the card: on bench_scene(3_000) at 96x48,
   traverse_closest over build_lbvh, intersect_clustered, intersect_fused
   (the kernels), closest_hit_plain and intersect_bruteforce must agree
   with brute force at the intersection gates; traverse_occluded and
   occluded_clustered with any_hit on the small shadow batch; the binning
   oracle's visit sets must equal bin_lists's at the 100k primary batch;
   build_lbvh(100_000) and traverse_closest on a 64k-ray block are timed
   (an oracle's times, not a result);
14. the measurement layer (run on the 100k Renderer and the 1M one of
   phase 7, so no scene is built twice): the tools' counts first, with
   launch counters reset just before and read just after (exec_stats at
   the 100k and 1M primary batches must launch closest_hit's counting
   build, "closest_hit_exec"; each batch record's launches are those of
   its own exec_stats run, the bounce's those of the Whitted render that
   hands it over, the path-traced bounce's those of the sample that hands
   it over); that build at the 100k primary, the Whitted bounce, the 1M
   primary and the path-traced first bounce batches: best t and slot
   bit-equal to the production build's and to those of the production
   build with cull boxes that drop nothing, per tile the plain walk's
   visits <= executed <= counts, with one work item a tile executed equal
   to the plain visits on >= 99.9% of tiles, and the 32-ray groups tested
   within [0, executed x ceil(tile_r / 32)], the cull share printed beside
   the plain walk's; timed beside the production build in the same run,
   which is timed beside its run without the cull; then kernel_micro (E_real, E_all, E_none), cull_stats,
   whitted_bench for 2 frames, verify_drive into a temporary directory
   (its PNGs must exist and not be black), and the bench's functions:
   kernel_smoke and golden_tile_gate on the card, and measure at 5 / 2 / 3
   frames, whose line must carry bench.py's keys (but the two the card
   has no counterpart of) with finite positive values and no error, and
   whose mode-5 median must lie within 2x of phase 5's.

Each kernel's line in the kernels JSON also carries its bound (the least
time the card could take for the same work: bytes over the memory rate or
operations over the peak rate, whichever is larger, computed from this
run's inputs; for closest_hit and any_hit from the pairs their plain walks
visit (every ray of a visited tile, whatever closest_hit's cull skips),
for the binning kernel from its slab tests and its sorting
networks' compare-exchanges, for pt_draws from the 4 bytes read and 16
written a row, for shadow_keys and shadow_rays from the bytes a point and
a ray read and write) and library_ms: null, since no single PyTorch
call computes any of these functions.  The lines of bin_clusters (the
binning kernel's dense mode), bin_clusters_super (its superblock mode),
closest_hit, any_hit, pt_draws, shadow_keys and shadow_rays also carry
"batches", one record per batch they
serve (ms, plain_ms, bound_ms, bound_by and the launches on its path; the
binning records also the layer's ms: the wrapper with its host sync, by
CUDA events; any_hit's also its counting build's ms, its ms with and
without the cull, its open and tested groups and cull shares:
``exec_ms``, ``cull_ms``, ``nocull_ms``, ``open_groups``, ``tested``,
``cull_share``, ``plain_cull_share``); their top-level numbers are
the first batch's; the shadow kernels' plain_ms is their chain's, and
their launches are the PT entry point's.  Each walk batch prints its work
items, longest list, visited of binned pairs and (ray, triangle) tests.
The binning kernel's, pt_draws's and the shadow kernels' ms is their
device time from the profiler (torch.profiler's CUDA kernel
records): CUDA events around one call of a launch this short would time
the host's enqueue.  Each such window starts with 16 launches that are not
timed and a pause, because the profiler loses the first records of a window,
and a window that lost more is taken once more (``device_ms``); a line
before the kernels line says what every window saw.

closest_hit_exec, the counting build of closest_hit (phase 14), carries
its ms beside the production build's (``production_ms``), and per batch
the executed, plain-walk and scheduled visits, the groups tested, the cull
shares (``cull_share``, ``plain_cull_share``) and the production build's
ms with and without the cull (``cull_ms``, ``nocull_ms``).  The build
log's register counts, stack frame and spill bytes of each closest_hit
instantiation are printed after the build.

The last lines are the kernels JSON line, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import dataclasses
from collections import Counter

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import (TILE_R, build_bvh, build_lbvh,
                                             intersect_clustered,
                                             intersect_fused,
                                             occluded_clustered,
                                             traverse_closest,
                                             traverse_occluded)
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.bvh.binning_oracle import bin_clusters
from directx_raytracer_tpu_torch.io import crtscene
from directx_raytracer_tpu_torch.kernels import build_kernels
from directx_raytracer_tpu_torch.models.material import MaterialType
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops import draws
from directx_raytracer_tpu_torch.ops import shading as psh
from directx_raytracer_tpu_torch.ops.debug_shading import MISS_COLOR
from directx_raytracer_tpu_torch.ops.intersect import (hit_record,
                                                       intersect_bruteforce)
from directx_raytracer_tpu_torch.parallel import (launch, local_device,
                                                  make_mesh,
                                                  pathtrace_multichip,
                                                  pathtrace_shard,
                                                  render_whitted_multichip,
                                                  untile_multichip,
                                                  whitted_shard)
from directx_raytracer_tpu_torch.ops.rays import T_MIN, generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.debug import render_debug, untile
from directx_raytracer_tpu_torch.render import pathtrace as ppt
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer, pathtrace_tile
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.render.whitted import render_whitted
from directx_raytracer_tpu_torch.tools import bench as dxrt_bench
from directx_raytracer_tpu_torch.tools import (cull_stats, exec_stats,
                                               kernel_micro, verify_drive,
                                               whitted_bench)
from directx_raytracer_tpu_torch.tools import precision_micro as pm
from directx_raytracer_tpu_torch.utils import checks, trace
from directx_raytracer_tpu_torch.utils.image import read_png, to_u8, write_png
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
BENCH_FRAMES = (5, 2, 3)  # measure's mode-5, Whitted and 1M frames
BENCH_SPREAD = 2.0  # its mode-5 median against phase 5's, either way
MULTI_GRID = (2, 2)  # tiles x samples: four processes on the one card
MULTI_SPP = 4
MULTI_TIMEOUT = 420  # seconds for the four processes, start to end
WALK_BLOCK = 65536  # rays of the timed LBVH walk
PROFILE_LEAD = 16  # launches at the start of a profiler window, not timed
PROFILE_PAUSE_S = 0.010  # between them and the timed launches
START = time.perf_counter()
WINDOWS = []  # (age of the process s, launches, records seen) per window

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

# * closest_hit's counting build (phase 14): results bit-equal to the
#   production build's; with one work item a tile its executed visits
#   equal the plain walk's on >= 99.9% of tiles (FMA contraction may flip
#   the gate on a knife-edge entry).
EXEC_EQUAL_SHARE = 0.999
# * the oracles against brute force: the hit and winner gates above, and t
#   within the repository's own 1e-3 relative (bench.py:156-164) on 99.9% of
#   common hits: the rope walk evaluates Moeller-Trumbore where brute force
#   evaluates the Woop form, so t differs by more than a few ulps.
ORACLE_T_RTOL = 1e-3
# * a multi-process Whitted frame against the single-process one: the same
#   samples summed in another order (the all-reduce), so besides the frame
#   gate every pixel within 1e-4, the tolerance tests/test_sharding.py:77-79
#   gives that reordering.
MULTI_ATOL = 1e-4
# * a multi-process path-traced accumulation against the sum, made in one
#   process, of pathtrace_shard over every (t, s): the same seeds, so the same
#   samples; only the order of the float adds differs (the all-reduce, and
#   index_add_'s atomics): every value within 1e-5 + 1e-5 |value|.
PT_SHARD_TOL = 1e-5
# * and against a single-process accumulation of as many samples from other
#   streams: block means (4 x 4 blocks of the frame, the statistic of
#   tests/test_sharding.py:118-125) within 0.01 relative and the image means
#   within 0.002.  That test's own gates (0.2 and 0.05) are sized for 16
#   samples of a 64 x 48 image; at 4 samples of 1920 x 1080 a block averages
#   518,400 samples, and two independent images read about 0.0003 and
#   0.00002, while a lost sample shard or a missing rescale reads above 0.05.
PT_BLOCK_REL = 0.01
PT_MEAN_GAP = 0.002

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
# Bytes a row of the draw kernel moves (csrc/pt_draws.cu): its i32 pixel id
# read, its four f32 draws written.
DRAW_ROW_BYTES = 4 + 16
# Bytes the shadow batch's kernels move (csrc/shadow_batch.cu): shadow_keys
# reads a point's position, normal and mask byte and writes its i32 key and
# f32 armed flag; shadow_rays reads those 25 bytes of a point once for all
# its lights, and a ray's five f32 light terms, and writes the ray's
# origin, direction and t_max.
SHADOW_KEY_BYTES = 12 + 12 + 1 + 4 + 4
SHADOW_POINT_BYTES = 12 + 12 + 1
SHADOW_RAY_BYTES = 5 * 4 + 7 * 4


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
    lines = out.stdout.strip().splitlines()
    if len(lines) > 1 and len(set(lines)) == 1:  # several cards, all alike
        return f"{len(lines)} x {lines[0]}"
    return "; ".join(lines)


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
    records: no host time in it.

    The window opens with ``PROFILE_LEAD`` calls that are not timed, a
    synchronize and a short pause, because torch.profiler returns no device
    record for the first launches of a window, and for more of them the
    older the process, whatever it did before: of 30 launches back to back
    none is lost in its first 20 s, 2 at 60 s and 3 at 100 s, the same
    after sleeping as after rendering (measured on an H100).  A 3-call
    window late in the run therefore came back empty every time.  Besides,
    a window now and then loses many or all of its records, at any age and
    for no cause found: of 300 windows of 46 launches back to back 5 lost 12
    to 46 records; of 300 windows of this shape, 298 returned every timed
    record, one all but one and one none.  A window with fewer than ``reps``
    records is therefore taken once more, and a second one fails the run.
    ``WINDOWS`` keeps what every window saw, and the run prints it."""
    fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA and name in e.name),
                        key=lambda e: e.time_range.start)
        WINDOWS.append((time.perf_counter() - START, PROFILE_LEAD + reps,
                        len(events)))
        if len(events) >= reps:
            break
    require(reps <= len(events) <= PROFILE_LEAD + reps,
            f"the profiler saw {len(events)} launches of {name} in "
            f"{PROFILE_LEAD + reps} calls, two windows in a row")
    return float(np.median([e.time_range.elapsed_us() / 1e3
                            for e in events[-reps:]]))


def windows_line() -> str:
    """What the profiler windows of ``device_ms`` saw, for the log."""
    lost = ", ".join(f"{launched - seen} of {launched} at {age:.0f} s"
                     for age, launched, seen in WINDOWS)
    return (f"profiler windows: {len(WINDOWS)}, each opened by {PROFILE_LEAD} "
            f"launches that are not timed; device records missing, by the "
            f"age of the process: {lost}")


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
    return ci.closest_query(o, d, bvh.clusters, bvh.wrows, tile_r, plain=True,
                            srows=bvh.srows, crows=bvh.crows).args()


def walk_bytes(args) -> int:
    """The bytes a walk must move: rays, rows (and cull boxes), counts and
    each listed (id, entry) once."""
    counts = args[-2]
    return nbytes(*args[:-4], counts) + 8 * int(counts.sum())


def check_closest(args, label):
    """Kernel vs plain version on one closest-hit batch.  Returns the
    largest t difference among equal winners and the kernel's bound."""
    visit, counts = args[5], args[7]
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
          f"rays, longest list {visit.shape[1]}, {exec_stats.work_items(counts)} work "
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
            check_closest((x["o"], x["d"], x["t_init"], x["wrows"],
                           x["bvh"].crows, *lists[:3], x["tile_r"]), label)
            continue
        rec, lists, bin_err = bin_batch("100k 1080p primary", x["tp"], x["cb"],
                                        None, 0, card)
        records["bin_clusters"] = dict(max_abs_err=bin_err, library_ms=None,
                                       batches=[rec])
        args = (x["o"], x["d"], x["t_init"], x["wrows"], x["bvh"].crows,
                *lists[:3], x["tile_r"])
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
    trace.reset()
    r = Renderer(scene, width, height, device=device)
    frames = [r.render_frame(mode) for mode in range(7)]
    torch.cuda.synchronize()
    launches = trace.launches()
    print(f"main path launches: {dict(launches)}")
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
                               tile_r or TILE_R, plain=True,
                               crows=r.bvh.crows)

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
                               plain=True, srows=bvh.srows, crows=bvh.crows)

    def factory(geo):
        def occluded(o, d, t_max):
            return ci.occluded_fused(o, d, bvh.clusters, bvh.wrows, bvh.crows,
                                     t_max, plain=True, srows=bvh.srows)
        return occluded

    return intersect, factory


def frames_agree(img, ref) -> float:
    diff = np.abs(to_u8(img).astype(int) - to_u8(ref).astype(int))
    return float(((diff <= PIXEL_LEVELS).all(axis=-1)).mean())


def any_hit_args(o, d, t_max, bvh):
    """The any_hit operands of a shadow batch, as occluded_fused builds
    them."""
    return ci.anyhit_schedule(o, d, t_max, bvh.clusters, bvh.wrows, bvh.crows,
                              srows=bvh.srows)


def without_cull(args):
    """A walk's operands with cull boxes that drop nothing."""
    return (*args[:4], ci.unbounded_rows(args[4]), *args[5:])


def cull_share(open_groups, tested) -> float:
    """The share of the 32-ray groups holding an open ray at a visit whose
    triangle tests the any-hit cull skipped."""
    return 1.0 - tested / open_groups if open_groups else 0.0


def check_any_hit(args, label, must_block=True):
    """Kernel vs plain version on one shadow batch, and the cull: blocked
    bit-equal to the kernel's with cull boxes that drop nothing and to its
    counting build's; per tile 0 <= tested <= open_groups; the cull share
    (``cull_share``) printed beside the plain walk's.  Returns whether any
    flag differs from the plain version's, the kernel's bound for this
    batch and the cull's counts."""
    b_k = ci.any_hit(*args)
    b_n = ci.any_hit(*without_cull(args))
    b_c, open_groups, tested = ci.any_hit(*args, count_exec=True)
    work = {}
    b_p = ci.any_hit_plain(*args, stats=work)
    torch.cuda.synchronize()
    agree = (b_k == b_p).float().mean().item()
    kept, same = torch.equal(b_k, b_n), torch.equal(b_k, b_c)
    over = int(((tested < 0) | (tested > open_groups)).sum())
    cull = dict(open_groups=int(open_groups.sum()), tested=int(tested.sum()))
    cull.update(cull_share=cull_share(cull["open_groups"], cull["tested"]),
                plain_cull_share=cull_share(work["open_groups"],
                                            work["tested"]))
    armed = int((args[2] > T_MIN).sum())
    counts = args[7]
    items = ci.anyhit_work_items(counts)
    print(f"[{label}] any_hit: {counts.shape[0]} tiles x {args[-1]} rays "
          f"({armed} armed), longest list {args[5].shape[1]}, "
          f"{items[0].shape[0]} work items, "
          f"{int(b_p.sum())} blocked; blocked agreement {agree:.6f}; the "
          f"walk visits {work['visits']} of {int(counts.sum())} binned pairs, "
          f"{work['tests']} (ray, triangle) tests; blocked bit-equal without "
          f"the cull: {kept}, in the counting build: {same}; cull share "
          f"{cull['cull_share'] * 100:.2f}% ({cull['tested']} of "
          f"{cull['open_groups']} open 32-ray groups tested), plain walk "
          f"{cull['plain_cull_share'] * 100:.2f}%")
    require(agree >= BLOCKED_AGREE, f"any_hit blocked agreement {agree}")
    require(int(b_p.sum()) > 0 or not must_block,
            "the shadow batch blocks no ray")
    require(kept, f"the cull changes any_hit's blocked flags at the {label}")
    require(same, f"any_hit_exec changes the blocked flags at the {label}")
    require(over == 0, f"any_hit_exec at the {label}: {over} tiles test "
                       f"more groups than they hold open")
    walk_bound = bound(walk_bytes(args) + nbytes(*items) + b_k.numel(),
                       work["tests"] * PAIR_TEST_OPS)
    return float((b_k != b_p).any()), walk_bound, cull


def small_shadow_batch(device):
    """3k/96x48: rays from the primary hit points toward the first light."""
    x = kernel_inputs(*SMALL_SCENE, device)
    n = x["o"].shape[0]
    hit = intersect_fused(x["o"], x["d"], x["bvh"].clusters, x["wrows"],
                          x["tile_r"], crows=x["bvh"].crows)
    p = x["o"] + x["d"] * torch.where(hit.mask, hit.t, 0.0)[:, None]
    light = torch.tensor(x["lights"][0].position, device=device)
    to_l = light - p
    dist = to_l.norm(dim=1)
    d = (to_l / dist[:, None]).contiguous()
    t_max = torch.where(hit.mask, dist - 2e-3, 0.0)
    require(t_max.shape[0] == n, "shadow batch shape")
    return any_hit_args((p + d * 1e-3).contiguous(), d, t_max, x["bvh"])


def launched(before: Counter) -> Counter:
    """The kernel launches made since ``before = trace.launches()``."""
    made = trace.launches()
    made.subtract(before)
    return made


def capturing(r):
    """The Renderer's intersector and occluder factory, wrapped to keep
    each batch a render hands them with the kernel launches the call made:
    (intersect_fn, occluder_factory, rays, shadows), rays a list of (o, d,
    tile_r, launches), shadows of (o, d, t_max, launches)."""
    rays, shadows = [], []

    def isect(o, d, geo, tile_r=None):
        before = trace.launches()
        hit = r.intersect_fn(o, d, geo, tile_r=tile_r)
        rays.append((o.clone(), d.clone(), tile_r or TILE_R, launched(before)))
        return hit

    def factory(geo):
        occluded = r.occluder_factory(geo)

        def occ(o, d, t_max):
            before = trace.launches()
            blocked = occluded(o, d, t_max)
            shadows.append((o.clone(), d.clone(), t_max.clone(),
                            launched(before)))
            return blocked
        return occ

    return isect, factory, rays, shadows


class Held:
    """The batch records and largest errors of the three frame kernels,
    gathered batch by batch."""

    def __init__(self):
        self.bin, self.closest, self.any = [], [], []
        self.bin_err = self.closest_err = self.any_err = 0.0

    def rays(self, label, batch, r, card, **plain_timing):
        """The binning kernel and closest_hit against their plain versions
        at one ray batch of ``capturing``, timed beside their bounds."""
        o, d, tile_r, launches = batch
        po, pd, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tile_r)
        rec, _, err = bin_batch(label, ci.tile_params(po, pd, tile_r),
                                ci.cluster_rows(r.bvh.clusters), None,
                                launches["bin_clusters"], card)
        del po, pd
        self.bin.append(rec)
        self.bin_err = max(self.bin_err, err)
        rec, err = closest_batch(closest_args(o, d, r.bvh, tile_r), label,
                                 launches["closest_hit"], card, **plain_timing)
        self.closest.append(rec)
        self.closest_err = max(self.closest_err, err)

    def shadows(self, label, batch, r, card, must_block=True, **plain_timing):
        """The binning kernel and any_hit against their plain versions at
        one shadow batch of ``capturing``, timed beside their bounds."""
        o, d, t_max, launches = batch
        po, pd, ptm, t_cap = ci.pad_and_cap(o, d, t_max, TILE_R)
        rec, _, err = bin_batch(label, ci.tile_params(po, pd, TILE_R, t_cap=t_cap,
                                                      live=ptm > T_MIN),
                                ci.cluster_rows(r.bvh.clusters), None,
                                launches["bin_clusters"], card)
        del po, pd, ptm, t_cap
        self.bin.append(rec)
        self.bin_err = max(self.bin_err, err)
        args = any_hit_args(o, d, t_max, r.bvh)
        err, walk_bound, cull = check_any_hit(args, label,
                                              must_block=must_block)
        rec = batch_record(label, ci.any_hit, ci.any_hit_plain, args,
                           walk_bound, launches["any_hit"], card,
                           **plain_timing)
        rec["exec_ms"] = time_ms(lambda: ci.any_hit(*args, count_exec=True),
                                 KERNEL_REPS)
        free = without_cull(args)
        rec["cull_ms"], rec["nocull_ms"] = time_both(
            lambda: ci.any_hit(*args), lambda: ci.any_hit(*free))
        rec.update(cull)
        print(f"any_hit at the {label} batch: {rec['cull_ms']:.4f} ms with "
              f"the cull, {rec['nocull_ms']:.4f} ms with boxes that drop "
              f"nothing (medians in turns), counting build "
              f"{rec['exec_ms']:.4f} ms (CUDA events); cull share "
              f"{cull['cull_share'] * 100:.2f}% [{card}]")
        self.any.append(rec)
        self.any_err = max(self.any_err, err)

    def into(self, records):
        """Append what was gathered to the kernels' records."""
        for name, batches, err in (
                ("bin_clusters", self.bin, self.bin_err),
                ("closest_hit", self.closest, self.closest_err),
                ("any_hit", self.any, self.any_err)):
            records[name]["batches"] += batches
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)


def whitted_path(r, card):
    """Phase 6 on the debug path's Renderer (bench_scene(100_000), 1080p).
    Returns the batches held and the frame's launches."""
    width, height = r.width, r.height
    check_any_hit(small_shadow_batch(r.device), "3k 96x48")

    # Each pass's ray batch as the frame hands it to the intersector and
    # its shadow batch as direct_lighting hands it to the occluder
    # (Morton-sorted, 4 lights x the pass's rays).
    isect, occf, rays, shadows = capturing(r)
    pos, rot = r.camera.snapshot()
    before = trace.launches()
    render_whitted(r.dscene, pos, rot, width, height, max_depth=WHITTED_DEPTH,
                   intersect_fn=isect, occluder_factory=occf)
    made = launched(before)
    require(len(rays) >= 2 and len(shadows) >= 2,
            f"the Whitted frame made {len(rays)} intersector and "
            f"{len(shadows)} occluder calls, expected a bounce pass")
    require(made["shadow_keys"] == made["shadow_rays"] == len(shadows),
            f"the Whitted frame's {len(shadows)} shadow batches launched "
            f"shadow_keys {made['shadow_keys']} and shadow_rays "
            f"{made['shadow_rays']} times, expected one each a batch")
    require(shadows[0][0].shape == (r.dscene.lights.n_lights * width * height, 3),
            f"primary shadow batch shape {tuple(shadows[0][0].shape)}")
    held = Held()
    held.shadows("100k 1080p primary shadow", shadows[0], r, card)
    held.shadows("100k 1080p bounce shadow", shadows[1], r, card,
                 must_block=False)
    held.rays("100k 1080p Whitted bounce", rays[1], r, card)
    del rays, shadows

    trace.reset()
    img, stats = r.render_whitted_frame(max_depth=WHITTED_DEPTH)
    torch.cuda.synchronize()
    launches = trace.launches()
    print(f"whitted path launches: {dict(launches)}")
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
    return held, launches


def pass_kernel_ms(fn, n: int) -> list:
    """Device ms of the last ``n`` hand-written kernel launches of ``fn``,
    in launch order, as (kernel, ms) pairs (torch.profiler's CUDA records).
    The window opens with one call of ``fn`` and a pause before the call it
    keeps, because the profiler loses a window's first records (see
    ``device_ms``)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
        fn()
        torch.cuda.synchronize()
    own = ("pt_draws", "bin_lists", "closest_hit", "any_hit", "shadow_keys",
           "shadow_rays")
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(k in e.name for k in own)),
                    key=lambda e: e.time_range.start)
    return [(next(k for k in own if k in e.name),
             e.time_range.elapsed_us() / 1e3) for e in events[-n:]]


def draws_record(drawn, launches, card):
    """pt_draws against its twin, bit for bit, at the queues a PT sample
    hands it (``drawn``: the ids, key, bounce and layout of each call), and
    the sample's jitter against its twin; each queue timed beside its bound
    (the kernel's device time from the profiler, as the launch is short).
    Returns the kernel's record."""
    batches = []
    for ids, key, bounce, layout in drawn:
        label = f"100k 1080p PT pass {bounce}"
        got = draws.pt_draws(ids, key, bounce, layout)
        want = draws.pt_draws_plain(ids.cpu(), key, bounce, layout)
        require(torch.equal(got.cpu(), want),
                f"pt_draws differs from its twin at the {label} queue")
        n = ids.shape[0]
        bound_ms, bound_by = bound(n * DRAW_ROW_BYTES, 0.0)
        rec = dict(batch=label, rows=n, launches=launches,
                   ms=device_ms(lambda: draws.pt_draws(ids, key, bounce, layout),
                                "pt_draws"),
                   plain_ms=time_ms(lambda: draws.pt_draws_plain(
                       ids, key, bounce, layout), PLAIN_REPS),
                   bound_ms=bound_ms, bound_by=bound_by)
        print(f"pt_draws at the {label} queue ({n} rows): equal to its twin "
              f"bit for bit; kernel {rec['ms']:.4f} ms (device time, "
              f"profiler), twin on the card {rec['plain_ms']:.4f} ms (CUDA "
              f"events), bound {bound_ms:.4f} ms ({bound_by}), {launches} "
              f"launches on its path [{card}]")
        batches.append(rec)
    key = drawn[0][1]
    got = draws.jitter(key, drawn[0][0].device).cpu()
    require(torch.equal(got, draws.jitter_plain(key, "cpu")),
            "the sample's jitter differs from its twin")
    print(f"jitter of the sample: {got.tolist()}, equal to its twin")
    return dict(max_abs_err=0.0, library_ms=None, batches=batches,
                **{k: batches[0][k] for k in
                   ("ms", "plain_ms", "bound_ms", "bound_by")})


def keep(x):
    """A copy of ``x`` with its strides (the sorted gather's columns stay
    strided); anything not a tensor as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                               device=x.device).copy_(x)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (floats compared as their i32 words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def shadow_records(shadow_in, card):
    """shadow_keys and shadow_rays against their plain chains on the card,
    bit for bit, at the operands a PT sample hands them (``shadow_in``: the
    primary pass's and the first bounce's); each timed beside its bound
    (the kernel's device time from the profiler) and beside the chain it
    replaces (CUDA events around the chain's launches).  Returns the two
    kernels' records."""
    records = {}
    for kind, kernel, plain in (
            ("keys", psh.shadow_keys, psh.shadow_keys_plain),
            ("rays", psh.shadow_rays, psh.shadow_rays_plain)):
        name, batches = f"shadow_{kind}", []
        for bounce, (args, kw) in enumerate(shadow_in[kind]):
            label = f"100k 1080p PT pass {bounce} shadow batch"
            got, want = kernel(*args, **kw), plain(*args, **kw)
            require(len(got) == len(want)
                    and all(bits_equal(g, w) for g, w in zip(got, want)),
                    f"{name} differs from its plain chain at the {label}")
            n = args[0].shape[0]
            if kind == "keys":
                rows, nbytes_ = n, n * SHADOW_KEY_BYTES
            else:
                rows = args[3].shape[0] * n
                nbytes_ = n * SHADOW_POINT_BYTES + rows * SHADOW_RAY_BYTES
            bound_ms, bound_by = bound(nbytes_, 0.0)
            rec = dict(batch=label, points=n, rows=rows,
                       ms=device_ms(lambda: kernel(*args, **kw), name),
                       plain_ms=time_ms(lambda: plain(*args, **kw),
                                        KERNEL_REPS),
                       bound_ms=bound_ms, bound_by=bound_by)
            print(f"{name} at the {label} ({n} points, {rows} rows): equal "
                  f"to its plain chain bit for bit; kernel {rec['ms']:.4f} ms "
                  f"(device time, profiler), plain chain on the card "
                  f"{rec['plain_ms']:.4f} ms (CUDA events), bound "
                  f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
            batches.append(rec)
        require(len(batches) == 2, f"{name}: {len(batches)} batches held")
        records[name] = dict(max_abs_err=0.0, library_ms=None, batches=batches,
                             **{k: batches[0][k] for k in
                                ("ms", "plain_ms", "bound_ms", "bound_by")})
    return records


def pt_path(r, card):
    """Phase 9 on the debug path's Renderer (bench_scene(100_000), 1080p).
    Returns the batches held, the entry point's launches and the draw
    kernel's record."""
    width, height, device = r.width, r.height, r.device
    pos, rot = r.camera.snapshot()
    cb = ci.cluster_rows(r.bvh.clusters)

    # Each pass's ray batch and shadow batch as the sample hands them over
    # (kept for the first bounce pass only), with the size of their lists.
    passes, kept = [], {}

    def capturing_isect(o, d, geo, tile_r=None):
        before = trace.launches()
        hit = r.intersect_fn(o, d, geo, tile_r=tile_r)
        made = launched(before)
        tr = tile_r or TILE_R
        po, pd, _ = ci.pad_and_seed(o, d, r.bvh.clusters, tr)
        _, _, counts, longest = ci.bin_lists(ci.tile_params(po, pd, tr), cb)
        passes.append(dict(alive=o.shape[0], tiles=counts.shape[0], tile_r=tr,
                           listed=int(counts.sum()), longest=longest,
                           items=exec_stats.work_items(counts)))
        if len(passes) == 2:
            kept["rays"] = (o.clone(), d.clone(), tr, made)
        return hit

    def capturing_occ(geo):
        occluded = r.occluder_factory(geo)

        def occ(o, d, t_max):
            before = trace.launches()
            blocked = occluded(o, d, t_max)
            made = launched(before)
            args = any_hit_args(o, d, t_max, r.bvh)
            counts = args[7]
            b_c, open_groups, tested = ci.any_hit(*args, count_exec=True)
            require(torch.equal(b_c[:o.shape[0]], blocked),
                    f"any_hit_exec changes the blocked flags of PT pass "
                    f"{len(passes) - 1}'s shadow batch")
            passes[-1].update(
                shadow_rays=o.shape[0], shadow_armed=int((t_max > T_MIN).sum()),
                shadow_tiles=counts.shape[0], shadow_listed=int(counts.sum()),
                shadow_longest=int(counts.max()),
                shadow_items=ci.anyhit_work_items(counts)[0].shape[0],
                shadow_open=int(open_groups.sum()),
                shadow_tested=int(tested.sum()))
            if len(passes) == 2:
                kept["shadow"] = (o.clone(), d.clone(), t_max.clone(), made)
            return blocked
        return occ

    # The queues each pass hands to the draws (kept for the primary pass
    # and the first bounce), read where the sample calls the draw kernel.
    drawn, draw = [], ppt.pt_draws

    def capturing_draws(ids, key, bounce, layout):
        if len(drawn) < 2:
            drawn.append((ids.clone(), key, bounce, layout))
        return draw(ids, key, bounce, layout)

    # The operands each pass hands to the shadow batch's kernels (kept for
    # the primary pass and the first bounce), strides and all.
    shadow_in, shadow_fns = {"keys": [], "rays": []}, {
        "keys": psh.shadow_keys, "rays": psh.shadow_rays}

    def capturing_shadow(kind):
        def fn(*args, **kw):
            if len(shadow_in[kind]) < 2:
                shadow_in[kind].append((tuple(map(keep, args)), kw))
            return shadow_fns[kind](*args, **kw)
        return fn

    def sample(key, isect=r.intersect_fn, occf=r.occluder_factory):
        return pathtrace_tile(r.dscene, pos, rot, key, width, height,
                              max_depth=PT_DEPTH, intersect_fn=isect,
                              occluder_factory=occf)

    before = trace.launches()
    ppt.pt_draws = capturing_draws
    psh.shadow_keys = capturing_shadow("keys")
    psh.shadow_rays = capturing_shadow("rays")
    try:
        sample(1, capturing_isect, capturing_occ)
    finally:
        ppt.pt_draws = draw
        psh.shadow_keys, psh.shadow_rays = shadow_fns["keys"], shadow_fns["rays"]
    made = launched(before)
    draw_launches = made["pt_draws"]
    require(len(passes) == PT_DEPTH and "shadow" in kept,
            f"the PT sample ran {len(passes)} passes, expected {PT_DEPTH}")
    require(len(drawn) == 2 and draw_launches == PT_DEPTH + 1,
            f"the PT sample drew {draw_launches} times, expected "
            f"{PT_DEPTH + 1} (a pass each and the jitter)")
    require(made["shadow_keys"] == made["shadow_rays"] == PT_DEPTH,
            f"the PT sample's {PT_DEPTH} shadow batches launched shadow_keys "
            f"{made['shadow_keys']} and shadow_rays {made['shadow_rays']} "
            f"times, expected one each a batch")
    # The sample launches pt_draws for its jitter, then a pass launches
    # bin_lists, closest_hit, then pt_draws in its shading, shadow_keys,
    # shadow_rays, bin_lists, any_hit, in order (the profiler may still miss
    # a record: one more profiled sample is taken then).
    per_pass = ["bin_lists", "closest_hit", "pt_draws", "shadow_keys",
                "shadow_rays", "bin_lists", "any_hit"]
    order = ["pt_draws"] + per_pass * PT_DEPTH
    kernel_ms = pass_kernel_ms(lambda: sample(1), len(order))
    if [k for k, _ in kernel_ms] != order:
        kernel_ms = pass_kernel_ms(lambda: sample(1), len(order))
    require([k for k, _ in kernel_ms] == order,
            f"the profiled PT sample's kernels: {[k for k, _ in kernel_ms]}")
    print(f"PT jitter: pt_draws {kernel_ms[0][1]:.4f} ms (device time, "
          f"profiler) [{card}]")
    k = len(per_pass)
    for i, p in enumerate(passes):
        ms = [f"{m:.4f}" for _, m in kernel_ms[1 + k * i:1 + k * (i + 1)]]
        print(f"PT pass {i}: pt_draws {ms[2]} ms; {p['alive']} alive rays in "
              f"{p['tiles']} tiles x {p['tile_r']}: {p['listed']} listed "
              f"pairs, longest list {p['longest']}, {p['items']} work items; "
              f"bin_lists {ms[0]} ms, closest_hit {ms[1]} ms; shadow_keys "
              f"{ms[3]} ms, shadow_rays {ms[4]} ms; shadow batch "
              f"{p['shadow_rays']} rays ({p['shadow_armed']} armed) in "
              f"{p['shadow_tiles']} tiles: {p['shadow_listed']} listed pairs, "
              f"longest list {p['shadow_longest']}, {p['shadow_items']} work "
              f"items; bin_lists {ms[5]} ms, any_hit {ms[6]} ms "
              f"(device time, profiler), cull share "
              f"{cull_share(p['shadow_open'], p['shadow_tested']) * 100:.2f}% "
              f"({p['shadow_tested']} of {p['shadow_open']} open 32-ray "
              f"groups tested, any_hit_exec) [{card}]")

    # The kernels at the first bounce pass's batches, against their plain
    # versions (one timed plain call each: the walks are long here).
    held = Held()
    held.rays("100k 1080p PT bounce", kept["rays"], r, card,
              plain_reps=1, plain_warmup=0)
    held.shadows("100k 1080p PT bounce shadow", kept["shadow"], r, card,
                 plain_reps=1, plain_warmup=0)
    record = draws_record(drawn, draw_launches, card)
    shadow = shadow_records(shadow_in, card)
    del kept, drawn, shadow_in
    torch.cuda.empty_cache()

    # The port's own entry point, with a checkpoint.
    tmp = tempfile.gettempdir()
    png = os.path.join(tmp, "chip_smoke_pt.png")
    state = os.path.join(tmp, "chip_smoke_pt.npz")
    trace.reset()
    viewer_main(["pathtrace", "--builtin", "bench_scene", "--width", str(width),
                 "--height", str(height), "--depth", str(PT_DEPTH),
                 "--samples", str(PT_SAMPLES), "--state", state, "-o", png])
    torch.cuda.synchronize()
    launches = trace.launches()
    print(f"PT path launches ({PT_SAMPLES} samples): {dict(launches)}")
    for name in ("bin_clusters", "closest_hit", "any_hit", "pt_draws",
                 "shadow_keys", "shadow_rays"):
        require(launches[name] > 0, f"{name} was not launched on the PT path")
    require(launches["shadow_keys"] == launches["shadow_rays"]
            == PT_DEPTH * PT_SAMPLES,
            f"shadow_keys {launches['shadow_keys']} and shadow_rays "
            f"{launches['shadow_rays']} launches in {PT_SAMPLES} samples of "
            f"{PT_DEPTH} shadow batches")
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
    return held, launches, record, shadow


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

    trace.reset()
    img = r.render_frame(5)
    torch.cuda.synchronize()
    launches = trace.launches()
    print(f"1M path launches: {dict(launches)}")
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
    return record, closest, launches, r


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

def _multi_rank(rank, world, n_tris, width, height):
    """One process of phase 10: the scene and its BVH built on the card,
    then the two collective entry points with this process's launch
    counters around each."""
    import torch.distributed as dist

    device = local_device()
    torch.cuda.set_device(device)
    r = Renderer(testscenes.bench_scene(n_tris, width, height), width, height,
                 device=device)
    mesh = make_mesh(*MULTI_GRID)
    pos, rot = r.camera.snapshot()
    fns = dict(intersect_fn=r.intersect_fn, occluder_factory=r.occluder_factory)

    def timed(fn):
        trace.reset()
        torch.cuda.synchronize()
        dist.barrier()  # the ranks start together: none times its wait
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, trace.launches()

    def whitted():
        return render_whitted_multichip(r.dscene, pos, rot, width, height, mesh,
                                        max_depth=WHITTED_DEPTH, spp=MULTI_SPP,
                                        **fns)

    _, first_s, _ = timed(whitted)  # loads the library, warms the allocator
    (img, stats), whitted_s, whitted_launches = timed(whitted)
    acc, pt_s, pt_launches = timed(lambda: pathtrace_multichip(
        r.dscene, pos, rot, 0, width, height, mesh, spp=MULTI_SPP,
        max_depth=PT_DEPTH, **fns))
    pt_img = untile_multichip(acc / MULTI_SPP, width, height, MULTI_GRID[0])
    keep = rank == 0  # every rank holds the same frame: one copy crosses
    return dict(coords=mesh.coords, device=str(img.device),
                backend=dist.get_backend(), first_s=first_s,
                whitted_s=whitted_s, pt_s=pt_s,
                whitted_launches=whitted_launches, pt_launches=pt_launches,
                stats=stats, img_sum=float(img.double().sum()),
                pt_sum=float(pt_img.double().sum()),
                img=img.cpu() if keep else None,
                pt_img=pt_img.cpu() if keep else None)


def stripe_batches(r, card):
    """The kernels of the multi-device path against their plain versions at
    the shapes that path gives them, in this one process: the last rank's
    shard of the Whitted frame and of the path-traced accumulation are
    rendered through ``capturing``, and the binning kernel, closest_hit and
    any_hit are held and timed at the stripe's primary batch (its own tile
    schedule, under a sample offset) and primary shadow batch and at the
    path tracer's first bounce and its shadow batch."""
    width, height = r.width, r.height
    pos, rot = r.camera.snapshot()
    n_tiles, n_samples = MULTI_GRID
    t, s = n_tiles - 1, n_samples - 1
    rows = -(-height // n_tiles)
    _, tile_r = pick_schedule(rows, width)
    isect, occf, rays, shadows = capturing(r)
    whitted_shard(r.dscene, pos, rot, width, height, n_tiles, n_samples, t, s,
                  max_depth=WHITTED_DEPTH, spp=MULTI_SPP, intersect_fn=isect,
                  occluder_factory=occf)
    require(rays[0][2] == tile_r and rays[0][0].shape[0] == rows * width,
            f"the stripe's primary batch: {rays[0][0].shape[0]} rays in tiles "
            f"of {rays[0][2]}, expected {rows * width} in tiles of {tile_r}")
    held = Held()
    label = f"100k {rows}-row stripe"
    held.rays(f"{label} primary", rays[0], r, card)
    held.shadows(f"{label} primary shadow", shadows[0], r, card)
    del rays[:], shadows[:]
    pathtrace_shard(r.dscene, pos, rot, 0, width, height, n_tiles, n_samples,
                    t, s, spp=n_samples, max_depth=PT_DEPTH, intersect_fn=isect,
                    occluder_factory=occf)
    require(len(rays) == PT_DEPTH and len(shadows) == PT_DEPTH,
            f"the stripe's PT sample made {len(rays)} intersector calls")
    held.rays(f"{label} PT bounce", rays[1], r, card,
              plain_reps=1, plain_warmup=0)
    held.shadows(f"{label} PT bounce shadow", shadows[1], r, card,
                 plain_reps=1, plain_warmup=0)
    del rays[:], shadows[:]
    torch.cuda.empty_cache()
    return held


def multi_path(r, card):
    """Phase 10 beside the debug path's Renderer (bench_scene(100_000),
    1080p), which renders the single-process references.  Returns the
    batches ``stripe_batches`` held."""
    width, height = r.width, r.height
    pos, rot = r.camera.snapshot()
    fns = dict(intersect_fn=r.intersect_fn, occluder_factory=r.occluder_factory)
    held = stripe_batches(r, card)

    def single():
        return render_whitted(r.dscene, pos, rot, width, height,
                              max_depth=WHITTED_DEPTH, spp=MULTI_SPP, **fns)

    ref, ref_stats = single()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    pt = PathTracer(r.dscene, width, height, max_depth=PT_DEPTH, seed=3, **fns)
    pt.step(pos, rot, n=MULTI_SPP)
    pt_ref = pt.image().cpu()
    ref, ref_alive = ref.cpu(), int(ref_stats["alive"].sum())
    del pt
    torch.cuda.empty_cache()

    world = MULTI_GRID[0] * MULTI_GRID[1]
    t0 = time.perf_counter()
    out = launch(_multi_rank, world, (BIG_SCENE[0], width, height),
                 timeout=MULTI_TIMEOUT)
    print(f"multi-device: {world} processes ({MULTI_GRID[0]} tiles x "
          f"{MULTI_GRID[1]} samples) started, rendered and joined in "
          f"{time.perf_counter() - t0:.1f} s")
    kernels = ("bin_clusters", "closest_hit", "any_hit")
    for rank, o in enumerate(out):
        print(f"rank {rank} at {o['coords']} on {o['device']} over "
              f"{o['backend']}: render_whitted_multichip {o['whitted_s']:.4f} s "
              f"(first call {o['first_s']:.4f} s), launches "
              f"{o['whitted_launches']}; pathtrace_multichip {o['pt_s']:.4f} s, "
              f"launches {o['pt_launches']} [{card}]")
        require(o["device"].startswith("cuda"),
                f"rank {rank} rendered on {o['device']}")
        for name in kernels:
            require(o["whitted_launches"][name] > 0 and o["pt_launches"][name] > 0,
                    f"rank {rank} never launched {name}")
        for key in ("img_sum", "pt_sum"):  # every rank holds the one frame
            require(abs(o[key] - out[0][key]) <= 1e-6 * abs(out[0][key]),
                    f"rank {rank}'s {key} {o[key]} against rank 0's {out[0][key]}")
    require([o["coords"] for o in out]
            == [divmod(k, MULTI_GRID[1]) for k in range(world)], "mesh coords")
    print(f"single process, render_whitted spp {MULTI_SPP} depth "
          f"{WHITTED_DEPTH}: {single_s:.4f} s [{card}]")

    img, stats = out[0]["img"], out[0]["stats"]
    require(tuple(img.shape) == (height, width, 3), "multi-device frame shape")
    require(bool(torch.isfinite(img).all()), "multi-device frame not finite")
    agree = frames_agree(img, ref)
    alive = int(stats["alive"].sum())
    print(f"multi-device Whitted: {agree:.6f} of pixels within {PIXEL_LEVELS} "
          f"levels of the single-process frame, largest difference "
          f"{float((img - ref).abs().max()):.3e}; alive rays summed over "
          f"ranks {alive}, single process {ref_alive}; dropped "
          f"{int(stats['dropped'].sum())}")
    require(agree >= PIXEL_AGREE, f"multi-device pixel agreement {agree}")
    require(float((img - ref).abs().max()) <= MULTI_ATOL,
            "the multi-device frame is not the single-process frame")
    require(abs(alive - ref_alive) <= ALIVE_SHARE * width * height,
            f"multi-device alive {alive} against {ref_alive}")

    pt_img = out[0]["pt_img"]
    require(tuple(pt_img.shape) == (height, width, 3), "multi-device PT shape")
    require(bool(torch.isfinite(pt_img).all()), "multi-device PT not finite")
    require(bool((pt_img >= 0).all()), "multi-device PT negative radiance")
    bg = r.dscene.background_color.cpu()
    require(int((pt_img != bg).any(dim=-1).sum()) > 0,
            "multi-device PT image is all background")

    # The same accumulation from one process: every shard's sum, the samples
    # axis added up and rescaled, the stripes concatenated.
    n_tiles, n_samples = MULTI_GRID
    scale = MULTI_SPP / (-(-MULTI_SPP // n_samples) * n_samples)
    stripes = [sum(pathtrace_shard(r.dscene, pos, rot, 0, width, height,
                                   n_tiles, n_samples, t, s, spp=MULTI_SPP,
                                   max_depth=PT_DEPTH, **fns)
                   for s in range(n_samples)) * scale for t in range(n_tiles)]
    whole = untile_multichip(torch.cat(stripes) / MULTI_SPP, width, height,
                             n_tiles).cpu()
    del stripes
    off = (whole - pt_img).abs()
    shards_agree = bool((off <= PT_SHARD_TOL * (1 + whole.abs())).all())
    print(f"multi-device PT against the sum of pathtrace_shard over every "
          f"(t, s) in one process: largest difference {float(off.max()):.3e} "
          f"(largest value {float(whole.max()):.3e}; gate {PT_SHARD_TOL:g} "
          f"absolute + relative)")
    require(shards_agree, "pathtrace_multichip is not the sum of its shards")

    def blocks(im):
        return im.reshape(4, height // 4, 4, width // 4, 3).mean(dim=(1, 3))

    a, b = blocks(pt_img), blocks(pt_ref)
    rel = float(((a - b).abs().mean(dim=-1) / (0.5 + b.mean(dim=-1))).max())
    gap = abs(float(pt_img.mean()) - float(pt_ref.mean()))
    print(f"multi-device PT, {MULTI_SPP} samples depth {PT_DEPTH}, against a "
          f"single-process {MULTI_SPP}-sample image: largest block-mean "
          f"difference {rel:.6f} relative (gate {PT_BLOCK_REL}), image means "
          f"{gap:.6f} apart (gate {PT_MEAN_GAP})")
    require(rel < PT_BLOCK_REL and gap < PT_MEAN_GAP,
            f"multi-device PT block means {rel}, means {gap}")
    return held


def checks_path(r, card):
    """Phase 11 on the debug path's Renderer."""
    unarmed, _ = r.render_whitted_frame(max_depth=WHITTED_DEPTH)
    unarmed_ms = time_ms(lambda: r.render_whitted_frame(max_depth=WHITTED_DEPTH),
                         WHITTED_REPS)
    require(not checks.enabled(), "DXRT_CHECK is set in the environment")
    os.environ["DXRT_CHECK"] = "1"
    try:
        require(checks.enabled(), "DXRT_CHECK=1 does not arm the checks")
        armed, _ = r.render_whitted_frame(max_depth=WHITTED_DEPTH)
        armed_ms = time_ms(
            lambda: r.render_whitted_frame(max_depth=WHITTED_DEPTH), WHITTED_REPS)
        diff = float((armed - unarmed).abs().max())
        print(f"checks: the armed frame is clean; largest difference to the "
              f"unarmed frame {diff:.3e}")
        require(diff <= 1e-6, f"armed frame differs by {diff}")
        clean = r.dscene
        intensity = clean.lights.intensity.clone()
        intensity[0] = float("nan")
        r.dscene = dataclasses.replace(clean, lights=dataclasses.replace(
            clean.lights, intensity=intensity))
        try:
            r.render_whitted_frame(max_depth=WHITTED_DEPTH)
        except checks.CheckError as e:
            print(f"checks: a NaN light intensity raises CheckError: {e}")
            require("non-finite" in str(e), f"unexpected guard: {e}")
        else:
            raise AssertionError("a NaN light intensity passed the armed frame")
        finally:
            r.dscene = clean
    finally:
        del os.environ["DXRT_CHECK"]
    print(f"whitted depth-{WHITTED_DEPTH} frame, DXRT_CHECK=1: {armed_ms:.4f} ms "
          f"armed against {unarmed_ms:.4f} ms unarmed (medians of "
          f"{WHITTED_REPS}) [{card}]")


def scenes_equal(a, b) -> bool:
    """Two host scenes, field for field (normals within 1e-5: the two
    parsers sum face normals in their own order)."""
    def eq(x, y):
        return np.array_equal(np.asarray(x), np.asarray(y))

    same = (a.settings.image_width == b.settings.image_width
            and a.settings.image_height == b.settings.image_height
            and eq(a.settings.background_color, b.settings.background_color)
            and eq(a.camera.position, b.camera.position)
            and eq(a.camera.rotation, b.camera.rotation)
            and len(a.lights) == len(b.lights)
            and len(a.materials) == len(b.materials)
            and len(a.textures) == len(b.textures)
            and len(a.meshes) == len(b.meshes))
    for la, lb in zip(a.lights, b.lights):
        same = same and eq(la.position, lb.position) and la.intensity == lb.intensity
    for ma, mb in zip(a.materials, b.materials):
        same = same and (ma.type == mb.type and eq(ma.albedo, mb.albedo)
                         and ma.smooth_shading == mb.smooth_shading
                         and ma.texture_name == mb.texture_name
                         and np.isclose(ma.ior, mb.ior, rtol=1e-6)
                         and np.isclose(ma.specular, mb.specular, rtol=1e-6)
                         and np.isclose(ma.shininess, mb.shininess, rtol=1e-6))
    for ta, tb in zip(a.textures, b.textures):
        same = same and ((ta.name, ta.type, ta.file_path)
                         == (tb.name, tb.type, tb.file_path)
                         and eq(ta.color_a, tb.color_a)
                         and eq(ta.color_b, tb.color_b)
                         and np.isclose(ta.scalar, tb.scalar))
    for sa, sb in zip(a.meshes, b.meshes):
        same = same and (sa.material_index == sb.material_index
                         and eq(sa.vertices, sb.vertices)
                         and eq(sa.indices, sb.indices) and eq(sa.uvs, sb.uvs)
                         and np.allclose(sa.normals, sb.normals, atol=1e-5))
    return bool(same)


def native_path(card):
    """Phase 12: the native parser against the Python one at 100k
    triangles.  A g++ failure raises."""
    from directx_raytracer_tpu_torch.native import build as native_build

    scene = testscenes.bench_scene(*BIG_SCENE)
    path = os.path.join(tempfile.gettempdir(), "chip_smoke_bench.crtscene")
    t0 = time.perf_counter()
    crtscene.dump(scene, path)
    dump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_build.get_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = crtscene.load(path, use_native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = crtscene.load(path, use_native=False)
    python_s = time.perf_counter() - t0
    same = scenes_equal(native, python) and scenes_equal(python, scene)
    print(f"native parser: {scene.num_triangles} triangles in "
          f"{os.path.getsize(path) / 1e6:.1f} MB (written in {dump_s:.2f} s); "
          f"g++ build {build_s:.2f} s; native parse {native_s:.4f} s, Python "
          f"parse {python_s:.4f} s (host times, one run each; card: {card}); "
          f"equal field for field and to the scene written: {same}")
    require(native.num_triangles == scene.num_triangles > 0, "native triangle count")
    require(same, "the native and the Python parser disagree")
    os.remove(path)


def hits_agree(label, got, ref):
    """One intersector against brute force at the intersection gates."""
    hit_agree = (got.mask == ref.mask).float().mean().item()
    both = got.mask & ref.mask
    winner = (got.tri[both] == ref.tri[both]).float().mean().item()
    rel = (got.t[both] - ref.t[both]).abs() / ref.t[both].abs()
    share = (rel <= ORACLE_T_RTOL).float().mean().item()
    tight = (rel <= T_RTOL).float().mean().item()
    print(f"[oracles] {label}: hit/miss agreement {hit_agree:.6f}, winner "
          f"agreement {winner:.6f}, t within {ORACLE_T_RTOL:g} rel on "
          f"{share:.6f} (within {T_RTOL:g} on {tight:.6f}) of {int(both.sum())} "
          f"common hits")
    require(hit_agree >= HIT_AGREE, f"{label} hit/miss agreement {hit_agree}")
    require(winner >= WINNER_AGREE, f"{label} winner agreement {winner}")
    require(share >= T_RTOL_SHARE, f"{label} t agreement {share}")


def oracles_path(r, card):
    """Phase 13: the oracles on the card; ``r`` is the 100k Renderer."""
    device = r.device
    x = kernel_inputs(*SMALL_SCENE, device)
    o, d, bvh, tile_r = x["o"], x["d"], x["bvh"], x["tile_r"]
    geo = build_device_scene(testscenes.bench_scene(*SMALL_SCENE), device).geometry
    ref = intersect_bruteforce(o, d, geo.woop)
    require(int(ref.mask.sum()) > 0, "the small scene's rays hit nothing")
    lbvh = build_lbvh(geo)
    lists = ci.bin_lists(x["tp"], x["cb"], plain=True)
    bt, bs = ci.closest_hit_plain(o, d, x["t_init"], x["wrows"], bvh.crows,
                                  *lists[:3], tile_r)
    plain = dataclasses.replace(
        ref, t=torch.where(bs >= 0, bt, float("inf")), tri=bs)
    for label, got in (
            ("traverse_closest over build_lbvh", traverse_closest(o, d, lbvh)),
            ("intersect_clustered", intersect_clustered(o, d, bvh.clusters)),
            ("intersect_fused", intersect_fused(o, d, bvh.clusters, x["wrows"],
                                                tile_r, crows=bvh.crows)),
            ("closest_hit_plain", plain),
            ("intersect_bruteforce", intersect_bruteforce(o, d, geo.woop))):
        hits_agree(label, got, ref)

    args = small_shadow_batch(device)
    so, sd, st = args[:3]
    blocked = ci.any_hit(*args)
    for label, got in (
            ("traverse_occluded", traverse_occluded(so, sd, lbvh, st)),
            ("occluded_clustered", occluded_clustered(so, sd, bvh.clusters, st))):
        agree = (got == blocked).float().mean().item()
        print(f"[oracles] {label} against any_hit on the 3k shadow batch: "
              f"blocked agreement {agree:.6f} ({int(got.sum())} and "
              f"{int(blocked.sum())} blocked)")
        require(agree >= BLOCKED_AGREE, f"{label} blocked agreement {agree}")

    # The binning oracle at the 100k primary batch: the same visit sets.
    width, height = r.width, r.height
    tile, tile_r = pick_schedule(height, width)
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, width, height, *tile, device=device)
    tiles = o.shape[0] // tile_r
    cs = r.bvh.clusters
    c = cs.aabb_min.shape[0]
    ids, _, counts = bin_clusters(o.reshape(tiles, tile_r, 3),
                                  d.reshape(tiles, tile_r, 3), cs)
    visit, _, k_counts, _ = ci.bin_lists(ci.tile_params(o, d, tile_r),
                                         ci.cluster_rows(cs))
    col = torch.arange(c, device=device)

    def member(lists, n):
        """(T, C) bool: cluster listed by tile."""
        out = torch.zeros((tiles, c), dtype=torch.bool, device=device)
        listed = col < n[:, None]
        rows = torch.arange(tiles, device=device)[:, None].expand(tiles, c)
        out[rows[listed], lists[:, :c][listed].long()] = True
        return out

    same = (torch.equal(counts, k_counts)
            and torch.equal(member(ids, counts), member(visit, k_counts)))
    print(f"[oracles] binning_oracle.bin_clusters at the 100k 1080p primary "
          f"batch: {tiles} tiles x {c} clusters, {int(counts.sum())} listed; "
          f"the same visit sets as bin_lists: {same}")
    require(same and int(counts.sum()) > 0,
            "the binning oracle and bin_lists list different sets")

    geo = r.dscene.geometry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = build_lbvh(geo)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # A block from the middle rows of the frame (the first rows see sky).
    start = (o.shape[0] - WALK_BLOCK) // 2 // tile_r * tile_r
    ob = o[start:start + WALK_BLOCK].contiguous()
    db = d[start:start + WALK_BLOCK].contiguous()
    t0 = time.perf_counter()
    walked = traverse_closest(ob, db, big, block=WALK_BLOCK)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    fused = r.intersect_fn(ob, db, geo)
    agree = (walked.mask == fused.mask).float().mean().item()
    print(f"[oracles] build_lbvh over {big.n_tris} triangle slots: "
          f"{build_s * 1e3:.1f} ms; traverse_closest on a {WALK_BLOCK}-ray "
          f"block from the middle of the 1080p primary batch: "
          f"{walk_s * 1e3:.1f} ms "
          f"({int(walked.mask.sum())} hits, hit/miss agreement with the "
          f"kernels {agree:.6f}); host clock, one run each: an oracle's times, "
          f"not a result [{card}]")
    require(int(walked.mask.sum()) > 0, "the timed walk's block hits nothing")
    require(agree >= HIT_AGREE, f"the 100k walk's hit/miss agreement {agree}")


def closest_registers(log: str) -> dict:
    """Registers, stack frame and spill store and load bytes of each
    closest_hit_kernel instantiation in the build log (ptxas -v), keyed
    (rays a thread, count_exec)."""
    regs, name, frame = {}, None, None
    for text in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", text)
        if m:
            name, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", text)
        if m:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", text)
        k = re.search(r"closest_hit_kernelILi(\d+)E(?:Lb([01])E)?", name or "")
        if m and k:
            stack, stores, loads = frame or (None, None, None)
            regs[(int(k.group(1)), k.group(2) == "1")] = dict(
                registers=int(m.group(1)), stack_frame=stack,
                spill_stores=stores, spill_loads=loads)
            name = None
    return regs


def time_both(fa, fb, reps: int = KERNEL_REPS):
    """Medians of ``fa`` and ``fb`` timed in turns (a, b, b, a), each the
    mean of its two medians by ``time_ms``."""
    a1, b1, b2, a2 = (time_ms(f, reps) for f in (fa, fb, fb, fa))
    return (a1 + a2) / 2, (b1 + b2) / 2


def count_build_batch(label, b, launches, card):
    """closest_hit's counting build at one batch (a ci.ClosestQuery):
    results bit-equal to the production build's and to those of the
    production build with cull boxes that drop nothing, the plain walk's
    visits <= executed <= counts per tile, executed == the plain visits
    with one item a tile, the 32-ray groups tested within [0, executed x
    ceil(tile_r / 32)]; the cull share printed; timed beside the production
    build, which is timed beside its run without the cull.  Returns the
    batch's record and the largest t difference to the plain walk among
    equal winners."""
    args, counts = b.args(), b.counts
    nocull_args = without_cull(args)
    prod = ci.closest_hit(*args, width=b.width)
    nocull = ci.closest_hit(*nocull_args, width=b.width)
    bt, bs, executed, tested = ci.closest_hit(*args, width=b.width,
                                              count_exec=True)
    one = ci.closest_hit(*args, width=b.width, chunk=max(b.width, 1),
                         count_exec=True)[2]
    work = {}
    bt_p, bs_p, plain, plain_tested = ci.closest_hit_plain(
        *args, stats=work, count_exec=True)
    torch.cuda.synchronize()
    same = (torch.equal(prod[0].view(torch.int32), bt.view(torch.int32))
            and torch.equal(prod[1], bs))
    kept = (torch.equal(prod[0].view(torch.int32), nocull[0].view(torch.int32))
            and torch.equal(prod[1], nocull[1]))
    below = int((plain > executed).sum())
    above = int((executed > counts).sum())
    equal = (one == plain).float().mean().item()
    groups = -(-b.tile_r // ci.CULL_GROUP)
    over = int(((tested < 0) | (tested > executed * groups)).sum())
    cull = exec_stats.cull_share(int(tested.sum()), int(executed.sum()),
                                 b.tile_r)
    plain_cull = exec_stats.cull_share(int(plain_tested.sum()),
                                       int(plain.sum()), b.tile_r)
    both = (bs >= 0) & (bs == bs_p)
    err = (bt[both] - bt_p[both]).abs().max().item() if both.any() else 0.0
    print(f"[{label}] closest_hit_exec: {counts.shape[0]} tiles x {b.tile_r} "
          f"rays; executed {int(executed.sum())}, plain walk {int(plain.sum())}, "
          f"scheduled {int(counts.sum())} visits; results bit-equal to the "
          f"production build: {same}, and to the production build without "
          f"the cull: {kept}; tiles with executed < plain {below}, "
          f"executed > counts {above}; one item a tile: executed == plain on "
          f"{equal:.6f} of tiles; cull share {cull * 100:.2f}% "
          f"({int(tested.sum())} of {int(executed.sum()) * groups} 32-ray "
          f"groups tested), plain walk {plain_cull * 100:.2f}%")
    require(same, f"closest_hit_exec changes the results at the {label} batch")
    require(kept, f"the cull changes closest_hit's results at the {label} batch")
    require(below == 0 and above == 0,
            f"closest_hit_exec at the {label} batch: {below} tiles below the "
            f"plain walk, {above} above their counts")
    require(over == 0, f"closest_hit_exec at the {label} batch: {over} tiles "
                       f"test more groups than their visits hold")
    require(equal >= EXEC_EQUAL_SHARE,
            f"closest_hit_exec with one item a tile equals the plain walk on "
            f"{equal} of tiles")
    prod_ms, ms = time_both(lambda: ci.closest_hit(*args, width=b.width),
                            lambda: ci.closest_hit(*args, width=b.width,
                                                   count_exec=True))
    cull_ms, nocull_ms = time_both(
        lambda: ci.closest_hit(*args, width=b.width),
        lambda: ci.closest_hit(*nocull_args, width=b.width))
    plain_ms = time_ms(lambda: ci.closest_hit_plain(*args, count_exec=True), 1,
                       warmup=0)
    bound_ms, bound_by = bound(walk_bytes(args) + 8 * args[0].shape[0]
                               + 4 * counts.shape[0],
                               work["tests"] * PAIR_TEST_OPS)
    print(f"closest_hit_exec at the {label} batch: counting build {ms:.4f} ms, "
          f"production build {prod_ms:.4f} ms ({(ms / prod_ms - 1) * 100:+.1f}%; "
          f"medians in turns, CUDA events), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {launches} launches on its path "
          f"[{card}]")
    print(f"closest_hit at the {label} batch: {cull_ms:.4f} ms with the cull, "
          f"{nocull_ms:.4f} ms with boxes that drop nothing "
          f"({(cull_ms / nocull_ms - 1) * 100:+.1f}%; medians in turns, CUDA "
          f"events) [{card}]")
    return dict(batch=label, launches=launches, ms=ms, production_ms=prod_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                executed=int(executed.sum()), plain_visits=int(plain.sum()),
                scheduled=int(counts.sum()), one_item_equal=equal,
                tested=int(tested.sum()), cull_share=cull,
                plain_cull_share=plain_cull, cull_ms=cull_ms,
                nocull_ms=nocull_ms), err


def pt_bounce_batch(r):
    """The first bounce pass's ray batch of one depth-4 path-traced sample
    of ``r``'s frame (the incoherent case), as its query builds it, and the
    counting build's launches on its path."""
    pos, rot = r.camera.snapshot()
    rays = []

    def isect(o, d, geo, tile_r=None):
        if len(rays) == 1:
            rays.append((o.clone(), d.clone(), tile_r or TILE_R))
        else:
            rays.append(None)
        return r.intersect_fn(o, d, geo, tile_r=tile_r)

    before = trace.launches()
    pathtrace_tile(r.dscene, pos, rot, 1, r.width, r.height,
                   max_depth=PT_DEPTH, intersect_fn=isect,
                   occluder_factory=r.occluder_factory)
    made = launched(before)["closest_hit_exec"]
    require(len(rays) > 1 and rays[1] is not None,
            "the PT sample ran no bounce pass")
    return exec_stats.ray_batch(r, *rays[1]), made


def bench_path(r, r_huge, frame_ms, card):
    """Phase 14's bench: the gates on the card, then measure at reduced
    frame counts; its line must carry bench.py's keys (but est_mfu_useful
    and vpu_tail_gops), finite and positive, and no error."""
    smoke = dxrt_bench.kernel_smoke(device=r.device)
    print(f"[bench] kernel_smoke on the card: {smoke}")
    golden = dxrt_bench.golden_tile_gate(device=r.device)
    print(f"[bench] golden_tile_gate: "
          f"{'skipped (no Dragon asset)' if golden is None else golden}")
    frames, whitted_frames, huge_frames = BENCH_FRAMES
    line = dxrt_bench.measure(r, frames, whitted_frames, huge=lambda: r_huge,
                              huge_frames=huge_frames)
    print(f"[bench] measure at {frames} / {whitted_frames} / {huge_frames} "
          f"frames: {json.dumps(line)}")
    keys = ("metric", "value", "unit", "vs_baseline", "pairs_per_ray",
            "est_mfu", "breakdown_ms", "whitted_1080p_ms", "mrays_1m_tris")
    errors = [k for k in line if k.endswith("_error")]
    require(not errors and all(k in line for k in keys),
            f"the bench line lacks keys or reports errors: {sorted(line)}")
    numbers = [line[k] for k in keys[4:] if k != "breakdown_ms"]
    numbers += [line["value"], line["vs_baseline"], *line["breakdown_ms"].values()]
    require(all(isinstance(v, float) and math.isfinite(v) and v > 0
                for v in numbers), f"the bench line's numbers: {line}")
    median = line["breakdown_ms"]["frame_ms"]
    print(f"[bench] mode-5 median {median:.4f} ms against phase 5's "
          f"{frame_ms:.4f} ms [{card}]")
    require(1 / BENCH_SPREAD <= median / frame_ms <= BENCH_SPREAD,
            f"the bench's mode-5 median {median} against {frame_ms}")
    return line


def tools_path(r, r_huge, frame_ms, card):
    """Phase 14 on the 100k Renderer and the 1M one.  Returns the kernels
    line's record of closest_hit_exec."""
    t0 = time.perf_counter()
    # Each batch's launches of the counting build on its path: exec_stats'
    # run for the primaries, the Whitted render for the bounce.
    trace.reset()
    made = {}
    for label, rr in (("100k 1080p primary", r), ("1M 1080p primary", r_huge)):
        before = trace.launches()
        exec_stats.run(rr, f"exec_stats: {label}")
        made[label] = launched(before)["closest_hit_exec"]
    torch.cuda.synchronize()
    launches = trace.launches()
    print(f"exec_stats launches: {dict(launches)}")
    require(all(n > 0 for n in made.values()),
            f"exec_stats did not launch closest_hit's counting build: {made}")

    isect, occf, rays, shadows = capturing(r)
    pos, rot = r.camera.snapshot()
    before = trace.launches()
    render_whitted(r.dscene, pos, rot, r.width, r.height,
                   max_depth=WHITTED_DEPTH, intersect_fn=isect,
                   occluder_factory=occf)
    made["100k 1080p Whitted bounce"] = launched(before)["closest_hit_exec"]
    bounce = exec_stats.ray_batch(r, *rays[1][:3])
    del rays, shadows
    pt_bounce, made["100k 1080p PT bounce"] = pt_bounce_batch(r)
    batches, err = [], 0.0
    for label, b in (("100k 1080p primary", exec_stats.primary_batch(r)),
                     ("100k 1080p Whitted bounce", bounce),
                     ("1M 1080p primary", exec_stats.primary_batch(r_huge)),
                     ("100k 1080p PT bounce", pt_bounce)):
        rec, e = count_build_batch(label, b, made[label], card)
        batches.append(rec)
        err = max(err, e)
    del bounce, pt_bounce

    micro = kernel_micro.run(r)
    require(micro["e_none_ms"] < micro["e_real_ms"] <= micro["e_all_ms"] * 1.05,
            f"kernel_micro: {micro}")
    cull = cull_stats.run(r)
    require(cull[64]["pairs_per_ray"] < cull[768]["pairs_per_ray"],
            "cull_stats: finer tiles list no fewer pairs")
    whitted_bench.run(r, WHITTED_DEPTH, frames=2)
    with tempfile.TemporaryDirectory() as out:
        require(verify_drive.main(["--out", out]) == 0, "verify_drive failed")
        for name in ("verify_cornell_bp_spp9.png", "verify_const_color.png"):
            png = os.path.join(out, name)
            require(os.path.exists(png), f"verify_drive wrote no {name}")
            require(read_png(png).max() > 0, f"verify_drive's {name} is black")
        print(f"verify_drive: wrote {sorted(os.listdir(out))}")
    bench_path(r, r_huge, frame_ms, card)
    print(f"measurement layer (phase 14): {time.perf_counter() - t0:.1f} s")
    first = batches[0]
    return dict(max_abs_err=err, library_ms=None, launches=launches["closest_hit_exec"],
                **{key: first[key] for key in ("ms", "production_ms", "plain_ms",
                                               "bound_ms", "bound_by")},
                batches=batches)



def precision_path(device, card):
    """Phase 8: the precision micro at the tool's own shapes."""
    trace.reset()
    require(pm.main([]) == 0, "the precision micro's entry point failed")
    torch.cuda.synchronize()
    launches = {v: trace.launches()[f"precision_micro.{v}"] for v in pm.VARIANTS}
    print(f"precision micro launches: {dict(launches)}")
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


def finish(card, kernels=None) -> int:
    """The last lines: the kernels line (the full run's), the card, ok."""
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=()) -> int:
    if list(argv) not in ([], ["multi"]):
        print("usage: chip_smoke.py [multi]", file=sys.stderr)
        return 2
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

    so, seconds = build_kernels()
    print(f"built {so.name} in {seconds:.2f} s")
    log = so.with_suffix(".log")
    if log.exists():
        text = log.read_text().strip()
        print(text)
        print(f"closest_hit_kernel registers and spill bytes (rays a thread, "
              f"count_exec): {closest_registers(text)}")

    if argv:  # phase 10 alone, for a host with a card a process
        n_tris, width, height = BIG_SCENE
        multi_path(Renderer(testscenes.bench_scene(n_tris, width, height),
                            width, height, device=device), card)
        return finish(card)

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

    held, whitted_launches = whitted_path(r, card)
    # any_hit's line carries the primary shadow batch's numbers on top.
    records["any_hit"] = dict(
        max_abs_err=0.0, library_ms=None, batches=[],
        **{key: held.any[0][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by")})
    held.into(records)
    pt_held, pt_launches, records["pt_draws"], shadow = pt_path(r, card)
    pt_held.into(records)
    records.update(shadow)
    multi_path(r, card).into(records)
    checks_path(r, card)
    oracles_path(r, card)
    torch.cuda.empty_cache()
    records["bin_clusters_super"], (huge, huge_err), huge_launches, r_huge = (
        huge_path(device, card))
    closest["batches"].append(huge)
    closest["max_abs_err"] = max(closest["max_abs_err"], huge_err)
    records["closest_hit_exec"] = tools_path(r, r_huge, frame_ms, card)
    del r, r_huge
    torch.cuda.empty_cache()
    variants = precision_path(device, card)
    native_path(card)

    # Each kernel's launches are read from the path it serves: the debug
    # path (bin_clusters, closest_hit), the Whitted path (any_hit), the
    # path-tracing path (pt_draws, shadow_keys, shadow_rays), the 1M path
    # (bin_clusters_super) and exec_stats (closest_hit_exec).
    launches["any_hit"] = whitted_launches["any_hit"]
    for name in ("pt_draws", "shadow_keys", "shadow_rays"):
        launches[name] = pt_launches[name]
    launches["bin_clusters_super"] = huge_launches["bin_clusters_super"]
    launches["closest_hit_exec"] = records["closest_hit_exec"].pop("launches")
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
               "closest_hit_exec": ("csrc/closest_hit.cu", f"{tpu}:788"),
               "any_hit": ("csrc/any_hit.cu", f"{tpu}:1001"),
               "bin_clusters_super": ("csrc/bin_clusters.cu", f"{tpu}:367"),
               "pt_draws": ("csrc/pt_draws.cu",
                            "directx_raytracer_tpu/render/pathtrace.py:99"),
               "shadow_keys": ("csrc/shadow_batch.cu",
                               "directx_raytracer_tpu/ops/shading.py:140"),
               "shadow_rays": ("csrc/shadow_batch.cu",
                               "directx_raytracer_tpu/ops/shading.py:244"),
               "precision_micro": ("csrc/precision_micro.cu",
                                   "tools/precision_micro.py:32")}
    kernels = []
    for name, (src, replaces) in sources.items():
        kernels.append(dict(name=name, route="cuda",
                            source=f"directx_raytracer_tpu_torch/{src}",
                            replaces=replaces, launches=launches[name],
                            **records[name]))
    print(windows_line())
    return finish(card, kernels)


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
