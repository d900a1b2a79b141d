#!/usr/bin/env python3
"""GPU smoke check of the PyTorch + CUDA port (directx_raytracer_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions; no
   CUDA device is a failure — nothing falls back to the CPU;
2. build both CUDA kernels from csrc/ (nvcc, seconds printed);
3. each kernel against its plain torch version on the card, at the shapes
   the main path gives it, on bench_scene(3_000) at 96x48 and
   bench_scene(100_000) at 1920x1080;
4. the main path: Renderer(bench_scene(100_000), 1920, 1080,
   device="cuda").render_frame(mode) for modes 0-6, with launch counters
   reset just before and read just after; frames must be finite and hit
   something; modes 3-6 must match the frame rendered through the plain
   versions, modes 0-2 their hit ids; one PNG is written to the temp dir;
5. timing with CUDA events: mode-5 frame ms and Mrays/s, and each kernel
   beside its plain version.

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

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import TILE_R, build_bvh, intersect_fused
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops.debug_shading import MISS_COLOR
from directx_raytracer_tpu_torch.ops.intersect import hit_record
from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.debug import render_debug
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.utils.image import to_u8, write_png

BIG_SCENE = (100_000, 1920, 1080)
SMALL_SCENE = (3_000, 96, 48)
KERNEL_REPS = 20
PLAIN_REPS = 3
FRAME_REPS = 15

# Tolerances, kernel vs plain version on the same card and inputs:
# * bin_clusters computes the plain version's ops in the same order with
#   IEEE divides, so it should agree exactly; 99.99% of overlap flags and
#   1e-6 relative on entries leave room only for a NaN-ordering corner.
BIN_OVERLAP_AGREE = 0.9999
BIN_ENTRY_RTOL = 1e-6
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
                tile_r=tile_r)


def check_bin(x, label):
    e_k, o_k = ci.bin_clusters(x["tp"], x["cb"])
    e_p, o_p = ci.bin_clusters_plain(x["tp"], x["cb"])
    torch.cuda.synchronize()
    agree = (o_k == o_p).float().mean().item()
    both = o_k & o_p
    err = (e_k[both] - e_p[both]).abs()
    rel = (err / e_p[both].abs()).max().item() if both.any() else 0.0
    max_abs = err.max().item() if both.any() else 0.0
    print(f"[{label}] bin_clusters: {tuple(o_k.shape)} pairs, "
          f"{int(o_p.sum())} overlapping, overlap agreement {agree:.6f}, "
          f"entry max rel err {rel:.3e}")
    require(agree >= BIN_OVERLAP_AGREE, f"bin_clusters overlap agreement {agree}")
    require(rel <= BIN_ENTRY_RTOL, f"bin_clusters entry rel err {rel}")
    return e_p, o_p, max_abs


def check_closest(x, e_p, o_p, label):
    visit, ventry, counts = ci.visit_lists(e_p, o_p)
    args = (x["o"], x["d"], x["t_init"], x["wrows"], visit, ventry, counts,
            x["tile_r"])
    bt_k, bs_k = ci.closest_hit(*args)
    bt_p, bs_p = ci.closest_hit_plain(*args)
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
    print(f"[{label}] closest_hit: {counts.shape[0]} tiles x {x['tile_r']} "
          f"rays, list length {visit.shape[1]}, {int(hp.sum())} hits; "
          f"hit/miss agreement {hit_agree:.6f}, winner agreement "
          f"{winner:.6f}, t within {T_RTOL:g} rel on {t_share:.6f}")
    require(hit_agree >= HIT_AGREE, f"closest_hit hit/miss agreement {hit_agree}")
    require(winner >= WINNER_AGREE, f"closest_hit winner agreement {winner}")
    require(t_share >= T_RTOL_SHARE, f"closest_hit t agreement {t_share}")
    return args, max_abs


def kernels_vs_plain(device):
    """Phase 3 (+ the kernel half of phase 5): returns per-kernel records
    measured at the main path's 1080p shapes."""
    records = {}
    for label, (n_tris, width, height) in (("3k 96x48", SMALL_SCENE),
                                           ("100k 1080p", BIG_SCENE)):
        x = kernel_inputs(n_tris, width, height, device)
        e_p, o_p, bin_err = check_bin(x, label)
        args, hit_err = check_closest(x, e_p, o_p, label)
        if (n_tris, width, height) != BIG_SCENE:
            continue
        records["bin_clusters"] = dict(
            max_abs_err=bin_err,
            ms=time_ms(lambda: ci.bin_clusters(x["tp"], x["cb"]), KERNEL_REPS),
            plain_ms=time_ms(lambda: ci.bin_clusters_plain(x["tp"], x["cb"]),
                             PLAIN_REPS))
        records["closest_hit"] = dict(
            max_abs_err=hit_err,
            ms=time_ms(lambda: ci.closest_hit(*args), KERNEL_REPS),
            plain_ms=time_ms(lambda: ci.closest_hit_plain(*args), PLAIN_REPS))
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
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched on the main path")
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

    records = kernels_vs_plain(device)
    for name, rec in records.items():
        print(f"{name} at 1080p/100k shapes: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms (medians, CUDA events) [{card}]")
    r, launches = main_path(device)

    frame_ms = time_ms(lambda: r.render_frame(5), FRAME_REPS, warmup=3)
    n_rays = r.width * r.height
    print(f"mode-5 frame at {r.width}x{r.height}, bench_scene(100_000): "
          f"{frame_ms:.4f} ms median of {FRAME_REPS}, "
          f"{n_rays / frame_ms / 1e3:.2f} Mrays/s [{card}]")

    sources = {"bin_clusters": ("csrc/bin_clusters.cu",
                                "directx_raytracer_tpu/bvh/pallas_intersect.py:307"),
               "closest_hit": ("csrc/closest_hit.cu",
                               "directx_raytracer_tpu/bvh/pallas_intersect.py:762")}
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
