"""Fused cluster intersection: the hand-written CUDA kernels and the
per-tile schedule between them.

Counterpart of ``directx_raytracer_tpu/bvh/pallas_intersect.py``: the
binning kernel ``_bin_kernel_body`` becomes ``bin_clusters``
(csrc/bin_clusters.cu), the closest-hit kernel ``_make_kernel`` becomes
``closest_hit`` (csrc/closest_hit.cu), and ``intersect_pallas`` becomes
``intersect_fused``.  A frame runs:

1. pad the rays to whole tiles of ``tile_r`` (origin 0, dir 1, seed 0:
   padding never hits) and seed each ray's best t with
   ``min(T_MAX, scene_exit_t * 1.001 + 1e-2)``;
2. per-tile origin/direction bounds (torch min/max reductions);
3. ``bin_clusters``: conservative entry distance and overlap flag of every
   (tile, cluster) pair;
4. the visit lists (torch): entries of non-overlapping pairs masked to
   +inf, each tile's row sorted, cut at the largest overlap count — the
   one host sync of a frame;
5. ``closest_hit``: each tile walks its list near to far and stops once
   the next entry exceeds the tile's largest best t.  No cluster is ever
   dropped: every overlapping cluster is either visited or provably
   farther than every ray's best.

Each kernel has a plain torch version here, ``bin_clusters_plain`` and
``closest_hit_plain``, computing the same function; the CPU tests run them
and the GPU check compares the kernels with them.  A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises.

The kernels are compiled with nvcc on first use, from the sources in
``csrc/``, into ``_build/`` next to this package, and bound with ctypes.
Each launch is counted in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..ops.intersect import Hit
from ..ops.rays import T_MAX, T_MIN
from .clustered import ClusterSet

TILE_R = 256  # default rays per tile (one 8x32 pixel tile)
MAX_TILE_R = 768  # closest_hit: 256 threads x at most 3 rays each
PLAIN_CHUNK = 128  # tiles per step of closest_hit_plain (~50 MB temporaries)
BIG = 1e30

# Kernel launches per wrapper since the last reset (plain integers; the
# plain versions never count).
LAUNCHES = {"bin_clusters": 0, "closest_hit": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bin_clusters.cu", "closest_hit.cu")
# -Xptxas -v reports each kernel's registers, shared memory and spills into
# the build log.  No --use_fast_math: both kernels need IEEE divides and
# unflushed denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libdxrt_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> tuple[Path, float]:
    """Compile csrc/*.cu into one shared library unless the library for
    these exact sources and flags exists.  Returns (path, seconds spent
    compiling, 0.0 if nothing was compiled).  The compiler's output goes
    to the ``.log`` file beside the library."""
    so = _library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / name) for name in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so, seconds


@functools.cache
def _lib() -> ctypes.CDLL:
    so, _ = build_kernels()
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dxrt_bin_clusters.argtypes = [p, p, p, p, i, i, p]
    lib.dxrt_bin_clusters.restype = i
    lib.dxrt_closest_hit.argtypes = [p] * 9 + [i, i, i, i, f, p]
    lib.dxrt_closest_hit.restype = i
    lib.dxrt_error_string.argtypes = [i]
    lib.dxrt_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launched(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    if err != 0:
        msg = lib.dxrt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
    LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def cluster_rows(cs: ClusterSet) -> torch.Tensor:
    """(8, C) f32 planar AABB rows [lo xyz | hi xyz | valid | 0] — the
    binning kernel's cluster operand (``planar_cluster_rows`` without the
    TPU's 128-lane padding)."""
    c = cs.aabb_min.shape[0]
    cb = cs.aabb_min.new_zeros((8, c))
    cb[0:3] = cs.aabb_min.T
    cb[3:6] = cs.aabb_max.T
    cb[6] = cs.valid.to(torch.float32)
    return cb


def tile_params(origins, dirs, tile_r: int, t_min=T_MIN) -> torch.Tensor:
    """(T, 16) f32 per-tile interval params for ``bin_clusters``:
    [o_lo xyz | o_hi xyz | d_lo xyz | d_hi xyz | len_hi | t_min | t_cap |
    pad], with len_hi = 1 (normalized rays) and t_cap = BIG (no cap)."""
    tiles = origins.shape[0] // tile_r
    o = origins.reshape(tiles, tile_r, 3)
    d = dirs.reshape(tiles, tile_r, 3)
    tp = origins.new_zeros((tiles, 16))
    tp[:, 0:3] = o.amin(dim=1)
    tp[:, 3:6] = o.amax(dim=1)
    tp[:, 6:9] = d.amin(dim=1)
    tp[:, 9:12] = d.amax(dim=1)
    tp[:, 12] = 1.0
    tp[:, 13] = t_min
    tp[:, 14] = BIG
    return tp


def bin_clusters_plain(tp: torch.Tensor, cb: torch.Tensor):
    """Plain torch version of ``bin_clusters``: the JAX package's
    ``bin_clusters_bits(impl="xla")`` slab formulation
    (pallas_intersect.py:274-292) on the kernel's operands.
    Returns entry (T, C) f32 and overlap (T, C) bool."""
    o_lo, o_hi = tp[:, 0:3], tp[:, 3:6]
    d_lo, d_hi = tp[:, 6:9], tp[:, 9:12]
    t_min, t_cap, len_hi = tp[:, 13:14], tp[:, 14:15], tp[:, 12:13]
    entry = tp.new_full((tp.shape[0], cb.shape[1]), -BIG)
    exit_ = tp.new_full((tp.shape[0], cb.shape[1]), BIG)
    for ax in range(3):
        n_lo = cb[None, ax, :] - o_hi[:, ax, None]
        n_hi = cb[None, 3 + ax, :] - o_lo[:, ax, None]
        dl, dh = d_lo[:, ax, None], d_hi[:, ax, None]
        same = (dl > 0) | (dh < 0)
        i_lo = torch.where(same, 1.0 / dh, -BIG)
        i_hi = torch.where(same, 1.0 / dl, BIG)
        prods = torch.stack([n_lo * i_lo, n_lo * i_hi, n_hi * i_lo,
                             n_hi * i_hi]).clamp(-BIG, BIG)
        entry = torch.maximum(entry, prods.amin(dim=0))
        exit_ = torch.minimum(exit_, prods.amax(dim=0))
    overlap = (entry <= exit_) & (exit_ >= t_min) & (cb[None, 6, :] > 0.5)
    entry = torch.maximum(entry, t_min)
    overlap = overlap & (entry <= t_cap)
    return entry / len_hi, overlap


def bin_clusters(tp: torch.Tensor, cb: torch.Tensor):
    """Entry (T, C) f32 and overlap (T, C) bool of every (tile, cluster)
    pair: the ``bin_clusters`` kernel for CUDA tensors, its plain version
    for CPU tensors."""
    if tp.device.type == "cpu":
        return bin_clusters_plain(tp, cb)
    tiles, c = tp.shape[0], cb.shape[1]
    _check("tp", tp, torch.float32, (tiles, 16), tp.device)
    _check("cb", cb, torch.float32, (8, c), tp.device)
    entry = torch.empty((tiles, c), dtype=torch.float32, device=tp.device)
    ovl = torch.empty((tiles, c), dtype=torch.uint8, device=tp.device)
    if tiles and c:
        lib = _lib()
        with torch.cuda.device(tp.device):
            stream = torch.cuda.current_stream(tp.device).cuda_stream
            err = lib.dxrt_bin_clusters(tp.data_ptr(), cb.data_ptr(),
                                        entry.data_ptr(), ovl.data_ptr(),
                                        tiles, c, stream)
        _launched(lib, "bin_clusters", err)
    return entry, ovl.view(torch.bool)


def visit_lists(entry: torch.Tensor, overlap: torch.Tensor):
    """Each tile's overlapping clusters, near to far.

    Returns visit (T, L) i32 cluster ids, their entries (T, L) f32 and the
    per-tile counts (T,) i32, with L the largest count; slots past a
    tile's count hold +inf entries.  Reading L is the frame's one host
    sync."""
    key = torch.where(overlap, entry, float("inf"))
    skey, order = torch.sort(key, dim=1, stable=True)
    counts = overlap.sum(dim=1, dtype=torch.int32)
    width = int(counts.max()) if counts.numel() else 0
    return (order[:, :width].to(torch.int32).contiguous(),
            skey[:, :width].contiguous(), counts)


# ---------------------------------------------------------------------------
# Closest hit
# ---------------------------------------------------------------------------


def woop_rows(cs: ClusterSet) -> torch.Tensor:
    """(C, 12, K) f32 Woop rows: row 4*a + j holds W[a][j] of each of the
    cluster's K triangles — the closest-hit kernel's per-visit operand."""
    c, k = cs.woop.shape[0], cs.woop.shape[1]
    return cs.woop.reshape(c, k, 12).transpose(1, 2).contiguous()


def closest_hit_plain(origins, dirs, init_t, wrows, visit, ventry, counts,
                      tile_r: int, t_min=T_MIN):
    """Plain torch version of ``closest_hit``: the same per-tile walk, one
    list position at a time for all live tiles at once (in chunks of
    ``PLAIN_CHUNK`` tiles to bound the (tiles, tile_r, K) temporaries).  Same
    float-op order as the kernel up to FMA contraction.  Returns best_t
    (N,) f32 and best_slot (N,) i32."""
    tiles = counts.shape[0]
    k = wrows.shape[2]
    o = origins.reshape(tiles, tile_r, 3)
    d = dirs.reshape(tiles, tile_r, 3)
    best_t = init_t.reshape(tiles, tile_r).clone()
    best_slot = torch.full((tiles, tile_r), -1, dtype=torch.int32,
                           device=origins.device)
    kk = torch.arange(k, dtype=torch.int32, device=origins.device)
    for i in range(visit.shape[1]):
        # Entries ascend along a list and best t only falls, so a tile that
        # stops here never resumes.
        live = (counts > i) & (ventry[:, i] <= best_t.amax(dim=1))
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        for sel in idx.split(PLAIN_CHUNK):
            cl = visit[sel, i]
            w = wrows[cl.long()][:, :, None, :]  # (A, 12, 1, K)
            ox, oy, oz = (o[sel, :, a, None] for a in range(3))  # (A, R, 1)
            dx, dy, dz = (d[sel, :, a, None] for a in range(3))
            ozp = w[:, 8] * ox + w[:, 9] * oy + w[:, 10] * oz + w[:, 11]
            dzp = w[:, 8] * dx + w[:, 9] * dy + w[:, 10] * dz
            t = -ozp / dzp
            u = ((w[:, 0] * ox + w[:, 1] * oy + w[:, 2] * oz + w[:, 3])
                 + t * (w[:, 0] * dx + w[:, 1] * dy + w[:, 2] * dz))
            v = ((w[:, 4] * ox + w[:, 5] * oy + w[:, 6] * oz + w[:, 7])
                 + t * (w[:, 4] * dx + w[:, 5] * dy + w[:, 6] * dz))
            ok = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= t_min)
            tk, ik = torch.where(ok, t, float("inf")).min(dim=2)  # lowest k on ties
            slot = cl[:, None] * k + kk[ik]
            bt, bs = best_t[sel], best_slot[sel]
            closer = (tk < bt) | ((tk == bt) & (slot < bs))
            best_t[sel] = torch.where(closer, tk, bt)
            best_slot[sel] = torch.where(closer, slot, bs)
    return best_t.reshape(-1), best_slot.reshape(-1)


def closest_hit(origins, dirs, init_t, wrows, visit, ventry, counts,
                tile_r: int, t_min=T_MIN):
    """Closest hit of every ray over its tile's visit list: the
    ``closest_hit`` kernel for CUDA tensors, its plain version for CPU
    tensors.  Returns best_t (N,) f32 and best_slot (N,) i32 (-1: no hit
    closer than the seed)."""
    if origins.device.type == "cpu":
        return closest_hit_plain(origins, dirs, init_t, wrows, visit, ventry,
                                 counts, tile_r, t_min)
    if not 1 <= tile_r <= MAX_TILE_R:
        raise ValueError(f"tile_r {tile_r} outside [1, {MAX_TILE_R}]")
    dev = origins.device
    tiles, width = visit.shape
    n = tiles * tile_r
    c, _, k = wrows.shape
    _check("origins", origins, torch.float32, (n, 3), dev)
    _check("dirs", dirs, torch.float32, (n, 3), dev)
    _check("init_t", init_t, torch.float32, (n,), dev)
    _check("wrows", wrows, torch.float32, (c, 12, k), dev)
    _check("visit", visit, torch.int32, (tiles, width), dev)
    _check("ventry", ventry, torch.float32, (tiles, width), dev)
    _check("counts", counts, torch.int32, (tiles,), dev)
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    if tiles:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dxrt_closest_hit(
                origins.data_ptr(), dirs.data_ptr(), init_t.data_ptr(),
                wrows.data_ptr(), visit.data_ptr(), ventry.data_ptr(),
                counts.data_ptr(), best_t.data_ptr(), best_slot.data_ptr(),
                tiles, tile_r, width, k, t_min, stream)
        _launched(lib, "closest_hit", err)
    return best_t, best_slot


# ---------------------------------------------------------------------------
# The fused query
# ---------------------------------------------------------------------------


def scene_exit_seed(origins, dirs, cs: ClusterSet, t_init):
    """``min(t_init, exit_t * 1.001 + 1e-2)``: a ray has no hit past the
    point where it leaves the box of the valid clusters, so tiles mixing
    hit and sky rays can stop early instead of being held open by the sky
    rays' T_MAX seeds.  Same arithmetic as the JAX ``_search``."""
    inf = float("inf")
    lo = torch.where(cs.valid[:, None], cs.aabb_min, inf).amin(dim=0)
    hi = torch.where(cs.valid[:, None], cs.aabb_max, -inf).amax(dim=0)
    tn = torch.full_like(t_init, -3e38)
    tf = torch.full_like(t_init, 3e38)
    for ax in range(3):
        d = dirs[:, ax]
        safe = torch.where(d.abs() < 1e-12,
                           torch.where(d < 0, -1e-12, 1e-12).to(d.dtype), d)
        inv = 1.0 / safe
        a = (lo[ax] - origins[:, ax]) * inv
        b = (hi[ax] - origins[:, ax]) * inv
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    exit_t = torch.where((tn <= tf) & (tf > 0), tf, T_MIN)
    return torch.minimum(t_init, exit_t * 1.001 + 1e-2)


def pad_and_seed(origins, dirs, cs: ClusterSet, tile_r: int):
    """Rays padded to whole tiles (origin 0, dir 1, seed 0: padding never
    hits) and each ray's seed best t, ``scene_exit_seed`` of T_MAX.
    Returns contiguous origins, dirs (M, 3) and t_init (M,)."""
    n = origins.shape[0]
    pad = (-n) % tile_r
    t_init = origins.new_full((n,), T_MAX)
    if pad:
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
        t_init = torch.cat([t_init, t_init.new_zeros((pad,))])
    origins, dirs = origins.contiguous(), dirs.contiguous()
    return origins, dirs, scene_exit_seed(origins, dirs, cs, t_init)


def intersect_fused(origins, dirs, cs: ClusterSet, wrows, tile_r: int = TILE_R,
                    plain: bool = False) -> Hit:
    """Closest hit via binning + the per-tile cluster walk.

    ``wrows`` is ``woop_rows(cs)``.  Returns a Hit with the exact t and
    slot (== triangle id: the geometry is treelet-ordered) and u = v = 0;
    ``ops.intersect.hit_record`` re-evaluates t/u/v and fetches the ids.
    ``plain=True`` runs the kernels' plain versions on any device (the
    reference the kernels are checked against on the card).
    """
    if not cs.identity_order:
        raise ValueError("intersect_fused needs treelet-ordered clusters")
    binner = bin_clusters_plain if plain else bin_clusters
    walker = closest_hit_plain if plain else closest_hit
    n = origins.shape[0]
    origins, dirs, t_init = pad_and_seed(origins, dirs, cs, tile_r)
    entry, overlap = binner(tile_params(origins, dirs, tile_r),
                            cluster_rows(cs))
    visit, ventry, counts = visit_lists(entry, overlap)
    best_t, best_slot = walker(origins, dirs, t_init, wrows, visit, ventry,
                               counts, tile_r)
    best_t, best_slot = best_t[:n], best_slot[:n]
    hit = best_slot >= 0
    zero = torch.zeros_like(best_t)
    return Hit(t=torch.where(hit, best_t, float("inf")), tri=best_slot,
               u=zero, v=zero)
