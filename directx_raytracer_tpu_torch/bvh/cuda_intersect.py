"""Fused cluster intersection: the hand-written CUDA kernels and the
per-tile schedule between them.

Counterpart of ``directx_raytracer_tpu/bvh/pallas_intersect.py``: the
binning kernels ``_bin_kernel_body`` and ``_bin_kernel_super_body`` become
the dense and superblock modes of one fused binning kernel
(csrc/bin_clusters.cu, wrapped by ``bin_lists``, which picks the mode on
the cluster count), the closest-hit kernel
``_make_kernel`` becomes ``closest_hit`` (csrc/closest_hit.cu), the any-hit
kernel ``_make_anyhit_kernel`` becomes ``any_hit`` (csrc/any_hit.cu), and
``intersect_pallas``/``occluded_pallas`` become ``intersect_fused``/
``occluded_fused``.  A closest-hit query runs:

1. pad the rays to whole tiles of ``tile_r`` (origin 0, dir 1, seed 0:
   padding never hits) and seed each ray's best t with
   ``min(T_MAX, scene_exit_t * 1.001 + 1e-2)``;
2. per-tile origin/direction bounds (torch min/max reductions);
3. ``bin_lists``: one kernel launch slab-tests every (tile, cluster)
   pair (in superblock mode only the clusters of superblocks whose hull
   the tile overlaps), and each tile's CTA compacts its overlapping
   clusters and sorts them by conservative entry distance, ties to the
   lower id, into its visit list; no (T, C) array is written.  Reading the
   largest count is the query's one host sync;
4. ``closest_hit``: each tile walks its list near to far and stops once
   the next entry exceeds the tile's largest best t.  No cluster is ever
   dropped: every overlapping cluster is either visited or provably
   farther than every ray's best.  The kernel cuts the lists into work
   items of ``CLOSEST_CHUNK`` positions that run in parallel and merge
   each ray's result as a packed (t, slot) key (``pack_keys``/
   ``unpack_keys``) with a 64-bit atomicMin.  Its counting build
   (``count_exec=True``, the TPU kernel's ``count_exec``) also returns
   the list positions each tile executed.

An occlusion query pads with parked rays (origin 1e30, dir 1, t_max 0),
bounds each tile over its armed rays only, caps its binning at its largest
t_max, and runs ``any_hit``, which stops a tile once the next entry
exceeds the largest t_max of its still-unblocked rays.

Both walks cull by the clusters' boxes (``cull_rows``, made once per BVH
as ``BVH.crows``): at each visit a warp runs a cluster's triangle tests
only if one of its rays can still take a hit, or be blocked, inside the
cluster's box; the results are those of testing every ray.

Each kernel has a plain torch version here (``bin_lists_plain``, built on
the (T, C) reference ``bin_clusters_plain``/``bin_clusters_super_plain``,
``closest_hit_plain``, ``any_hit_plain``) computing the same function; the
CPU tests run them and the GPU check compares the kernels with them.  A
wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.

The kernels are built, bound and launched by ``kernels.py`` of this
package, which counts each launch in ``utils.trace.COUNTS`` under
``launch.<kernel>``; each host sync of a query is counted under
``sync.<site>``, and the queries' parts are ``dxrt.query.*`` and
``dxrt.occluder.*`` spans (``utils/trace.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import check_tensor, launch
from ..ops.intersect import Hit
from ..ops.rays import T_MAX, T_MIN
from ..utils import trace
from ..utils.trace import span
from .clustered import ClusterSet

TILE_R = 256  # default rays per tile (one 8x32 pixel tile)
MAX_TILE_R = 768  # closest_hit: 256 threads x at most 3 rays each
ANYHIT_MAX_TILE_R = 256  # any_hit: one ray per thread
ANYHIT_CHUNK = 16  # any_hit: list positions per work item (one CTA each)
CLOSEST_CHUNK = 2  # closest_hit: list positions per work item
PLAIN_CHUNK = 128  # tiles per step of the plain walks (~50 MB temporaries)
BIG = 1e30
SUPER_BLOCK = 128  # clusters per superblock of the superblock binner
SUPER_MIN_C = 2048  # from this cluster count on, binning skips superblocks


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


def tile_params(origins, dirs, tile_r: int, t_min=T_MIN, t_cap=None,
                live=None) -> torch.Tensor:
    """(T, 16) f32 per-tile interval params for the binning kernel:
    [o_lo xyz | o_hi xyz | d_lo xyz | d_hi xyz | len_hi | t_min | t_cap |
    pad], with len_hi = 1 (normalized rays).  ``t_cap`` (T,) caps each
    tile's overlaps at that entry distance; None writes BIG (no cap).
    ``live`` (N,) bool bounds each tile over its live lanes only (all lanes
    of a tile that has none): a lane no cluster can matter to must not
    widen its tile's box."""
    tiles = origins.shape[0] // tile_r
    o = origins.reshape(tiles, tile_r, 3)
    d = dirs.reshape(tiles, tile_r, 3)
    tp = origins.new_zeros((tiles, 16))
    if live is None:
        tp[:, 0:3] = o.amin(dim=1)
        tp[:, 3:6] = o.amax(dim=1)
        tp[:, 6:9] = d.amin(dim=1)
        tp[:, 9:12] = d.amax(dim=1)
    else:
        live = live.reshape(tiles, tile_r, 1)
        live = live | ~live.any(dim=1, keepdim=True)
        inf = float("inf")
        tp[:, 0:3] = torch.where(live, o, inf).amin(dim=1)
        tp[:, 3:6] = torch.where(live, o, -inf).amax(dim=1)
        tp[:, 6:9] = torch.where(live, d, inf).amin(dim=1)
        tp[:, 9:12] = torch.where(live, d, -inf).amax(dim=1)
    tp[:, 12] = 1.0
    tp[:, 13] = t_min
    tp[:, 14] = BIG if t_cap is None else t_cap
    return tp


def bin_clusters_plain(tp: torch.Tensor, cb: torch.Tensor):
    """The slab test of every (tile, cluster) pair, the binning kernel's
    arithmetic: the JAX package's ``bin_clusters_bits(impl="xla")`` slab
    formulation (pallas_intersect.py:274-292) on the kernel's operands.
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


def super_rows(cb: torch.Tensor, block: int = SUPER_BLOCK) -> torch.Tensor:
    """(8, S) f32 superblock hull rows, S = ceil(C / block): the AABB hull
    of each run of ``block`` clusters of ``cb`` in ``cluster_rows`` layout,
    over its VALID clusters only (an invalid cluster's box must not drag a
    hull), with valid = any; a hull of no valid cluster is (BIG, -BIG).
    ``planar_super_rows`` without the TPU's 128-lane padding."""
    c = cb.shape[1]
    s = -(-c // block)
    r = torch.cat([cb, cb.new_zeros((8, s * block - c))], dim=1)
    r = r.reshape(8, s, block)
    lane_ok = r[6:7] > 0.5
    valid = r[6].amax(dim=-1)
    lo = torch.where(lane_ok, r[0:3], BIG).amin(dim=-1)
    hi = torch.where(lane_ok, r[3:6], -BIG).amax(dim=-1)
    sb = cb.new_zeros((8, s))
    sb[0:3] = torch.where(valid > 0.5, lo, BIG)
    sb[3:6] = torch.where(valid > 0.5, hi, -BIG)
    sb[6] = valid
    return sb


def _check_super(cb, sb, block: int) -> None:
    if block < 1:
        raise ValueError(f"block {block} < 1")
    s = -(-cb.shape[1] // block)
    if sb.shape != (8, s):
        raise ValueError(f"sb: shape {tuple(sb.shape)}, expected (8, {s}): "
                         f"super_rows(cb, block={block})")


def bin_clusters_super_plain(tp: torch.Tensor, cb: torch.Tensor,
                             sb: torch.Tensor, block: int = SUPER_BLOCK):
    """The superblock mode's (T, C) reference: the dense slab test,
    then entry = BIG and overlap = False for every cluster whose superblock
    hull (row of ``sb = super_rows(cb, block)``) the tile misses
    (``_bin_kernel_super_body``, pallas_intersect.py:367-393).  The slab
    test is inclusion-monotone, so the overlaps equal the dense ones."""
    _check_super(cb, sb, block)
    _, sovl = bin_clusters_plain(tp, sb)
    entry, ovl = bin_clusters_plain(tp, cb)
    keep = sovl.repeat_interleave(block, dim=1)[:, :cb.shape[1]]
    return torch.where(keep, entry, BIG), ovl & keep


def bin_clusters(tp: torch.Tensor, cb: torch.Tensor, sb=None):
    """The plain (T, C) reference of the binning layer: entry f32 and
    overlap bool of every (tile, cluster) pair.  Below ``SUPER_MIN_C``
    clusters the dense slab test; from there on the superblock one, with
    ``sb`` = ``super_rows(cb)`` (built here when not given)."""
    if cb.shape[1] < SUPER_MIN_C:
        return bin_clusters_plain(tp, cb)
    sb = super_rows(cb) if sb is None else sb
    return bin_clusters_super_plain(tp, cb, sb)


# A listed entry's key, (bits(entry) << 32) | cluster, and the high word of
# every unlisted pair's: +inf, so unlisted clusters sort last, by id.
_INF_BITS = 0x7F800000


def bin_lists_plain(tp: torch.Tensor, cb: torch.Tensor, sb=None,
                    block: int = SUPER_BLOCK):
    """Plain torch version of the fused binning kernel: the slab test of
    every (tile, cluster) pair (``bin_clusters_plain``, or with ``sb`` =
    ``super_rows(cb, block)`` ``bin_clusters_super_plain``), each row
    sorted by the kernel's packed int64 keys (bits(entry) << 32) | cluster
    with unlisted pairs at +inf, cut at the largest count.  Entries are >=
    t_min > 0, so this order is a stable sort of the masked entries:
    ``visit_lists``' result, bit for bit.  Returns visit (T, W) i32,
    ventry (T, W) f32, counts (T,) i32 and W, the largest count (one host
    sync)."""
    if sb is None:
        entry, overlap = bin_clusters_plain(tp, cb)
    else:
        entry, overlap = bin_clusters_super_plain(tp, cb, sb, block)
    ids = torch.arange(cb.shape[1], dtype=torch.int64, device=tp.device)
    high = torch.where(overlap, entry.view(torch.int32).to(torch.int64),
                       _INF_BITS)
    keys, _ = torch.sort((high << 32) | ids, dim=1)
    counts = overlap.sum(dim=1, dtype=torch.int32)
    width = int(counts.max()) if counts.numel() else 0
    keys = keys[:, :width]
    visit = (keys & 0xFFFFFFFF).to(torch.int32)
    ventry = (keys >> 32).to(torch.int32).view(torch.float32)
    return visit, ventry, counts, width


def launch_bin_lists(tp: torch.Tensor, cb: torch.Tensor, sb=None,
                     block: int = SUPER_BLOCK):
    """Launch the fused binning kernel on CUDA tensors, in dense mode (``sb``
    None) or superblock mode (``sb`` = ``super_rows(cb, block)``), without
    a host sync.  Returns visit (T, C) i32, ventry (T, C) f32 and meta
    (T + 1,) i32: row t of the lists holds its first meta[t] positions, near
    to far (the rest is never written); meta[T] is the largest count.
    Counted under ``launch.bin_clusters`` (dense) or
    ``launch.bin_clusters_super``."""
    dev = tp.device
    tiles, c = tp.shape[0], cb.shape[1]
    check_tensor("tp", tp, torch.float32, (tiles, 16), dev)
    check_tensor("cb", cb, torch.float32, (8, c), dev)
    s = 0
    if sb is not None:
        _check_super(cb, sb, block)
        s = sb.shape[1]
        check_tensor("sb", sb, torch.float32, (8, s), dev)
    visit = torch.empty((tiles, c), dtype=torch.int32, device=dev)
    ventry = torch.empty((tiles, c), dtype=torch.float32, device=dev)
    meta = torch.empty((tiles + 1,), dtype=torch.int32, device=dev)
    if not (tiles and c):
        meta.zero_()
    else:
        launch("bin_clusters" if sb is None else "bin_clusters_super",
               "dxrt_bin_lists", dev, tp.data_ptr(), cb.data_ptr(),
               None if sb is None else sb.data_ptr(), visit.data_ptr(),
               ventry.data_ptr(), meta.data_ptr(), tiles, c, s, block, c)
    return visit, ventry, meta


def bin_lists(tp: torch.Tensor, cb: torch.Tensor, sb=None, plain: bool = False,
              mode=None, block: int = SUPER_BLOCK):
    """Each tile's visit list: the clusters its params ``tp`` (T, 16)
    overlap among ``cb`` (8, C), near to far, ties to the lower id.
    Returns visit and ventry (T, stride) i32/f32, counts (T,) i32 and the
    width, the largest count (reading it is the query's one host sync,
    ``sync.bin_width``, whichever version runs); row t's first counts[t]
    positions are its list.  The fused kernel for
    CUDA tensors (stride C, the rest of each row unwritten), its plain
    version ``bin_lists_plain`` for CPU tensors or with ``plain=True``
    (stride = width).

    ``mode`` "dense" tests every pair, "super" first the superblock hulls
    ``sb`` (``super_rows(cb, block)``, built here when not given); None
    picks "super" from ``SUPER_MIN_C`` clusters on.  Both give the same
    lists."""
    if mode is None:
        mode = "dense" if cb.shape[1] < SUPER_MIN_C else "super"
    if mode == "dense":
        sb = None
    elif mode == "super":
        sb = super_rows(cb, block) if sb is None else sb
    else:
        raise ValueError(f"mode {mode!r}: expected 'dense' or 'super'")
    trace.count("sync.bin_width")
    if plain or tp.device.type == "cpu":
        return bin_lists_plain(tp, cb, sb, block)
    visit, ventry, meta = launch_bin_lists(tp, cb, sb, block)
    tiles = tp.shape[0]
    return visit, ventry, meta[:tiles], int(meta[tiles])


def visit_lists(entry: torch.Tensor, overlap: torch.Tensor):
    """Each tile's overlapping clusters, near to far, from the (T, C)
    reference (``bin_clusters``): what ``bin_lists`` computes in one
    kernel, kept as the reference it is tested against.

    Returns visit (T, L) i32 cluster ids, their entries (T, L) f32 and the
    per-tile counts (T,) i32, with L the largest count; slots past a
    tile's count hold +inf entries.  Reading L is the query's one host
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
    """(C, K, 12) f32 Woop rows, triangle-major: entry [c, kk, 4*a + j]
    holds W[a][j] of the cluster's triangle kk (``cs.woop`` as it is, made
    contiguous) — the walks' per-visit operand, 48 bytes (three float4) a
    triangle."""
    c, k = cs.woop.shape[0], cs.woop.shape[1]
    return cs.woop.reshape(c, k, 12).contiguous()


CULL_GAMMA = 2.0 ** -16  # the cull boxes' margin per unit of error scale
CULL_GROUP = 32  # rays a warp culls together (closest_hit: its j-th rays)
CULL_ROWS_CHUNK = 1024  # clusters a step of cull_rows' float64 bounds


def cull_rows(wrows: torch.Tensor) -> torch.Tensor:
    """(C, 8) f32 cull boxes [lo xyz | hi xyz | f | 0], one a cluster of
    ``wrows`` (``woop_rows``): the walks test a ray against a cluster's
    triangles only if it meets the box grown by ``f * max|o|`` at some t in
    [t_min, end], end its best t (closest_hit) or its t_max (any_hit).

    The box must hold every point o + t d at which the Woop test accepts
    one of the cluster's triangles, rounding included, so it is taken from
    the f32 rows themselves, not from the scene's vertices: the triangle
    each row maps to the unit triangle (inverted in float64), grown by a
    bound on how far the test's f32 arithmetic can move an accepted point.
    The test rounds each dot product of a row (a, a_w) with (o, 1) and t d
    to within a few ulp of |a|_1 (|o| + |t d|) + |a_w|, and a Woop-space
    error moves the world point by it times the columns e1, e2, n of the
    row's inverse.  With |t d| <= |o| + |p| and |p| <= B, the box's largest
    coordinate, that is at most CULL_GAMMA * (k1 * (2|o| + 2B) + k0) for

        k1 = (|e1| + |e2|)(|a|_1 + |b|_1) + |n| |c|_1,
        k0 = (|e1| + |e2|)(|a_w| + |b_w|) + |n| |c_w|     (max norms),

    the largest over the cluster's triangles.  CULL_GAMMA = 2^-16 is 128
    f32 ulp, several times the ulp the test's rounding can add up to.  A
    slender triangle has a large k1 and widens its own cluster's box, never
    another's.  Sentinel rows (zero linear part) never accept and add
    nothing; a cluster of sentinels only has an empty box (lo > hi); a
    cluster whose bound is not finite has an unbounded one.  Made once per
    BVH (``build_bvh``); nothing of it runs a frame.

    Why one margin serves both walks.  The bound is on where an ACCEPTED
    point lies, whatever t the walk asks about: t enters it only through
    |t d| <= |o| + |p|, which holds at every accepted t.  A pair the
    closest-hit walk needs is accepted at t_min <= t <= best; a pair that
    blocks a shadow ray at t_min <= t < t_max, so its t lies in [t_min,
    t_max], the interval the any-hit cull slab-tests (closed at t_max: one
    end wider than the walk needs, never narrower).  Its point lies in the
    grown box, so the ray's segment over that interval meets the box and
    the pair is kept, as a closest hit at t <= best is.  The slab test's
    own rounding, a few ulp of each face distance and of each t, lies far
    inside the margin's 2^-15 |o|.  The any-hit walk lets only live, armed
    (t_max > t_min) and unblocked rays vote."""
    c = wrows.shape[0]
    # In chunks of clusters: the float64 temporaries of a 1M-triangle scene
    # would take ~0.1 GB at once.
    lo, hi, k1, k0, any_real = (torch.cat(x) for x in zip(*(
        _woop_bounds(w) for w in wrows.split(CULL_ROWS_CHUNK))))
    inf = float("inf")
    big = torch.maximum(lo.abs(), hi.abs()).amax(dim=1)
    pad = CULL_GAMMA * (2.0 * k1 * big + k0)
    f = 2.0 * CULL_GAMMA * k1
    bounded = torch.isfinite(pad) & torch.isfinite(f) & torch.isfinite(big)
    grow = (any_real & bounded)[:, None]
    unbounded = (any_real & ~bounded)[:, None]
    lo = torch.where(unbounded, -inf, torch.where(grow, lo - pad[:, None], lo))
    hi = torch.where(unbounded, inf, torch.where(grow, hi + pad[:, None], hi))
    f = torch.where(grow[:, 0], f, 0.0)
    # To f32, rounded outward (f up).
    down = torch.tensor(-inf, dtype=torch.float32, device=wrows.device)
    lo32, hi32, f32 = lo.float(), hi.float(), f.float()
    lo32 = torch.where(lo32.double() > lo, torch.nextafter(lo32, down), lo32)
    hi32 = torch.where(hi32.double() < hi, torch.nextafter(hi32, -down), hi32)
    f32 = torch.where(f32.double() < f, torch.nextafter(f32, -down), f32)
    return torch.cat([lo32, hi32, f32[:, None], f32.new_zeros((c, 1))],
                     dim=1).contiguous()


def unbounded_rows(crows: torch.Tensor) -> torch.Tensor:
    """Cull boxes of ``crows``' shape that drop nothing: closest_hit then
    runs every ray's tests at every visit, as a walk without the cull
    would (the reference the cull's checks hold it to)."""
    inf = float("inf")
    box = torch.tensor([-inf, -inf, -inf, inf, inf, inf, 0.0, 0.0],
                       device=crows.device)
    return box.expand(crows.shape).contiguous()


def _woop_bounds(wrows):
    """``cull_rows``' float64 bounds of clusters ``wrows`` (C, K, 12): the
    box (C, 3) x 2 of the triangles the rows map to the unit triangle, k1
    and k0 (C,), and whether a cluster has a non-sentinel row (C,)."""
    c, k, _ = wrows.shape
    w = wrows.to(torch.float64).reshape(c, k, 3, 4)
    m, tr = w[..., :3], w[..., 3]
    r0, r1, r2 = m.unbind(dim=-2)
    # The inverse's columns: e1, e2, n = (r1 x r2, r2 x r0, r0 x r1) / det.
    cols = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                        torch.linalg.cross(r0, r1)], dim=-2)  # (C, K, 3, 3)
    det = (r0 * cols[..., 0, :]).sum(dim=-1)
    real = m.ne(0).flatten(-2).any(dim=-1)
    cols = cols / torch.where(real, det, 1.0)[..., None, None]
    v0 = -(tr[..., :, None] * cols).sum(dim=-2)  # -(tr_0 e1 + tr_1 e2 + tr_2 n)
    verts = torch.stack([v0, v0 + cols[..., 0, :], v0 + cols[..., 1, :]])
    inf = float("inf")
    lo = torch.where(real[..., None], verts.amin(dim=0), inf).amin(dim=1)
    hi = torch.where(real[..., None], verts.amax(dim=0), -inf).amax(dim=1)
    cn = cols.abs().amax(dim=-1)  # (C, K, 3): |e1|, |e2|, |n|
    rn = m.abs().sum(dim=-1)  # |a|_1, |b|_1, |c|_1
    tn = tr.abs()
    k1 = ((cn[..., 0] + cn[..., 1]) * (rn[..., 0] + rn[..., 1])
          + cn[..., 2] * rn[..., 2])
    k0 = ((cn[..., 0] + cn[..., 1]) * (tn[..., 0] + tn[..., 1])
          + cn[..., 2] * tn[..., 2])
    return (lo, hi, torch.where(real, k1, 0.0).amax(dim=1),
            torch.where(real, k0, 0.0).amax(dim=1), real.any(dim=1))


def cull_keep(o, d, best, box, t_min=T_MIN):
    """The plain twin of the walks' cull (walk.cuh ``needs_box``): whether
    each ray (o, d) (..., 3) meets the cull box ``box`` (..., 8) (a row of
    ``cull_rows``, broadcast against the rays) grown by ``f * max|o|`` at
    some t in [t_min, best], (...) bool; the any-hit walk passes t_max as
    best.  The kernel's arithmetic, up to FMA contraction: a zero
    direction component's infinite reciprocal gives +-inf or, in a face's
    plane, NaN, which the NaN-dropping fmax/fmin keep."""
    po = box[..., 6] * o.abs().amax(dim=-1)
    lo = box[..., 0:3] - po[..., None] - o
    hi = box[..., 3:6] + po[..., None] - o
    inv = 1.0 / d
    tl, th = lo * inv, hi * inv
    neg = torch.signbit(d)
    near, far = torch.where(neg, th, tl), torch.where(neg, tl, th)
    entry = torch.full_like(best, t_min)
    exit_ = best.clone()
    for ax in range(3):
        entry = torch.fmax(entry, near[..., ax])
        exit_ = torch.fmin(exit_, far[..., ax])
    return entry <= exit_


def _group_any(mask: torch.Tensor, tile_r: int) -> torch.Tensor:
    """(A, ceil(tile_r / 32)) bool: whether each 32-ray group of the tiles'
    rays ``mask`` (A, tile_r) holds a True (a walk's warp; the last group of
    a tile that is no multiple of 32 holds its tail)."""
    groups = -(-tile_r // CULL_GROUP)
    mask = torch.nn.functional.pad(mask, (0, groups * CULL_GROUP - tile_r))
    return mask.reshape(-1, groups, CULL_GROUP).any(dim=2)


def _woop_tests(w, o, d, sel):
    """t, u, v of the tiles ``sel``'s rays against clusters ``w`` (A, K,
    12): (A, R, K) each, today's formulas with an IEEE divide."""
    w = w.transpose(1, 2)[:, :, None, :]  # (A, 12, 1, K)
    ox, oy, oz = (o[sel, :, a, None] for a in range(3))  # (A, R, 1)
    dx, dy, dz = (d[sel, :, a, None] for a in range(3))
    ozp = w[:, 8] * ox + w[:, 9] * oy + w[:, 10] * oz + w[:, 11]
    dzp = w[:, 8] * dx + w[:, 9] * dy + w[:, 10] * dz
    t = -ozp / dzp
    u = ((w[:, 0] * ox + w[:, 1] * oy + w[:, 2] * oz + w[:, 3])
         + t * (w[:, 0] * dx + w[:, 1] * dy + w[:, 2] * dz))
    v = ((w[:, 4] * ox + w[:, 5] * oy + w[:, 6] * oz + w[:, 7])
         + t * (w[:, 4] * dx + w[:, 5] * dy + w[:, 6] * dz))
    return t, u, v


def closest_hit_plain(origins, dirs, init_t, wrows, crows, visit, ventry,
                      counts, tile_r: int, t_min=T_MIN, stats=None,
                      count_exec: bool = False):
    """Plain torch version of ``closest_hit``: the same per-tile walk, one
    list position at a time for all live tiles at once (in chunks of
    ``PLAIN_CHUNK`` tiles to bound the (tiles, tile_r, K) temporaries).  Same
    float-op order as the kernel up to FMA contraction.  Returns best_t
    (N,) f32 and best_slot (N,) i32; with ``count_exec`` also each tile's
    visits (T,) i32, the list positions its walk executed, and tested (T,)
    i32, the 32-ray groups of its visits in which a ray passes the kernel's
    cull (``cull_keep`` against ``crows``, ``cull_rows(wrows)``, at the
    walk's best t).  The walk tests every ray of a visit whatever the cull
    says, so its results are the reference the cull is held to.

    ``stats``, a dict, gets the work the walk's early-out leaves: the
    (tile, cluster) pairs visited under ``"visits"``, the (ray, triangle)
    tests they need under ``"tests"``, and under ``"kept_tests"`` those of
    the 32-ray groups the cull keeps."""
    tiles = counts.shape[0]
    visits = torch.zeros((tiles,), dtype=torch.int32, device=origins.device)
    tested = torch.zeros_like(visits)
    groups = -(-tile_r // CULL_GROUP)
    group_rays = (tile_r - CULL_GROUP * torch.arange(
        groups, device=origins.device)).clamp(max=CULL_GROUP)
    k = wrows.shape[1]
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
        visits += live
        if stats is not None:
            stats["visits"] = stats.get("visits", 0) + idx.numel()
            stats["tests"] = stats.get("tests", 0) + idx.numel() * tile_r * k
        for sel in idx.split(PLAIN_CHUNK):
            cl = visit[sel, i]
            bt, bs = best_t[sel], best_slot[sel]
            if count_exec or stats is not None:
                kept = _group_any(cull_keep(o[sel], d[sel], bt,
                                            crows[cl.long(), None], t_min),
                                  tile_r)
                tested[sel] += kept.sum(dim=1, dtype=torch.int32)
                if stats is not None:
                    stats["kept_tests"] = (stats.get("kept_tests", 0)
                                           + int((kept * group_rays).sum()) * k)
            t, u, v = _woop_tests(wrows[cl.long()], o, d, sel)
            ok = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= t_min)
            tk, ik = torch.where(ok, t, float("inf")).min(dim=2)  # lowest k on ties
            slot = cl[:, None] * k + kk[ik]
            closer = (tk < bt) | ((tk == bt) & (slot < bs))
            best_t[sel] = torch.where(closer, tk, bt)
            best_slot[sel] = torch.where(closer, slot, bs)
    if count_exec:
        return best_t.reshape(-1), best_slot.reshape(-1), visits, tested
    return best_t.reshape(-1), best_slot.reshape(-1)


def pack_keys(t: torch.Tensor, slot=None) -> torch.Tensor:
    """(N,) i64 keys ``(bits(t) << 32) | (slot + 1)``, the closest-hit
    kernel's merge operand: for t >= 0 the bits of t order as the floats
    do, so the least key is the least t, ties to the lower slot.
    ``slot=None`` gives the seeds ``(bits(t) << 32) | 0``, which a hit at
    exactly t never beats (slot + 1 >= 1)."""
    keys = t.contiguous().view(torch.int32).to(torch.int64) << 32
    return keys if slot is None else keys | (slot.to(torch.int64) + 1)


def unpack_keys(keys: torch.Tensor):
    """Inverse of ``pack_keys``: t (N,) f32 and slot (N,) i32, -1 for a
    seed.  t is a strided view of the keys' high words (little-endian:
    each key is its low word, then its high word)."""
    words = keys.view(torch.int32).view(-1, 2)
    return words[:, 1].view(torch.float32), words[:, 0] - 1


def closest_hit(origins, dirs, init_t, wrows, crows, visit, ventry, counts,
                tile_r: int, t_min=T_MIN, chunk: int = CLOSEST_CHUNK,
                width=None, count_exec: bool = False):
    """Closest hit of every ray over its tile's visit list: the
    ``closest_hit`` kernel for CUDA tensors, its plain version for CPU
    tensors.  Returns best_t (N,) f32 and best_slot (N,) i32 (-1: no hit
    closer than the seed).  Seeds must be >= 0 (``pack_keys``).  ``crows``
    is ``cull_rows(wrows)``: at each visit a warp runs the triangle tests
    of its j-th rays only if one of them meets the cluster's cull box
    before its best t; the results are those of a walk that tests every
    ray.

    ``count_exec=True`` launches the kernel's counting build (counted as
    "closest_hit_exec"; the same results) and also returns executed (T,)
    i32, the list positions each tile's work items executed (passed the
    early-out gate): between the plain walk's visits and the counts, equal
    to the visits with one item a tile (``chunk`` >= ``width``); and tested
    (T,) i32, the 32-ray groups of those visits whose triangle tests ran,
    at most executed x ceil(tile_r / 32).  On CPU tensors they are the
    plain walk's (``closest_hit_plain``).

    ``visit``/``ventry`` (T, stride) hold each tile's list in its first
    counts[t] positions (nothing past them is read); ``width``, at least
    the largest count, sizes the schedule (None: the stride).

    The kernel cuts each list into work items of ``chunk`` positions,
    takes them depth by depth (every tile's depth j before any tile's depth
    j + 1, tiles with the most items first), and merges each ray's result
    through its packed key; it numbers the items itself, so the query
    gains no host sync.  A list longer than 24 K chunks (K the cluster
    width) takes longer chunks."""
    if origins.device.type == "cpu":
        return closest_hit_plain(origins, dirs, init_t, wrows, crows, visit,
                                 ventry, counts, tile_r, t_min,
                                 count_exec=count_exec)
    if not 1 <= tile_r <= MAX_TILE_R:
        raise ValueError(f"tile_r {tile_r} outside [1, {MAX_TILE_R}]")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    dev = origins.device
    tiles, stride = visit.shape
    width = stride if width is None else width
    if not 0 <= width <= stride:
        raise ValueError(f"width {width} outside [0, {stride}]")
    n = tiles * tile_r
    c, k, _ = wrows.shape
    check_tensor("origins", origins, torch.float32, (n, 3), dev)
    check_tensor("dirs", dirs, torch.float32, (n, 3), dev)
    check_tensor("init_t", init_t, torch.float32, (n,), dev)
    check_tensor("wrows", wrows, torch.float32, (c, k, 12), dev)
    check_tensor("crows", crows, torch.float32, (c, 8), dev)
    if crows.data_ptr() % 16:
        raise ValueError("crows: not 16-byte aligned")
    check_tensor("visit", visit, torch.int32, (tiles, stride), dev)
    check_tensor("ventry", ventry, torch.float32, (tiles, stride), dev)
    check_tensor("counts", counts, torch.int32, (tiles,), dev)
    keys = pack_keys(init_t)
    executed = tested = None
    if count_exec:
        executed = torch.zeros((tiles,), dtype=torch.int32, device=dev)
        tested = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    if tiles:
        # The kernel's counting sort holds depths + 1 <= 24 K ints.
        chunk = max(chunk, -(-width // (24 * k - 1)))
        depths = -(-width // chunk)
        order = torch.empty((tiles,), dtype=torch.int32, device=dev)
        offs = torch.empty((depths + 1,), dtype=torch.int32, device=dev)
        sched = torch.zeros((2,), dtype=torch.int32, device=dev)
        launch("closest_hit_exec" if count_exec else "closest_hit",
               "dxrt_closest_hit", dev, origins.data_ptr(), dirs.data_ptr(),
               wrows.data_ptr(), crows.data_ptr(), visit.data_ptr(),
               ventry.data_ptr(), counts.data_ptr(), order.data_ptr(),
               offs.data_ptr(), sched.data_ptr(), keys.data_ptr(),
               None if executed is None else executed.data_ptr(),
               None if tested is None else tested.data_ptr(), tiles, depths,
               tile_r, stride, k, t_min, chunk)
    if count_exec:
        return (*unpack_keys(keys), executed, tested)
    return unpack_keys(keys)


# ---------------------------------------------------------------------------
# Any hit
# ---------------------------------------------------------------------------


def any_hit_plain(origins, dirs, t_max, wrows, crows, visit, ventry, counts,
                  tile_r: int, t_min=T_MIN, stats=None,
                  count_exec: bool = False):
    """Plain torch version of ``any_hit``: the same per-tile walk, one list
    position at a time for all live tiles at once (in chunks of
    ``PLAIN_CHUNK`` tiles), with the kernel's cull.  A tile stops at the
    first entry past the largest t_max of its still-unblocked rays.  At a
    visit, a 32-ray group runs the cluster's tests only if one of its open
    rays (armed, t_max > t_min, and not yet blocked) meets the cluster's
    cull box before its t_max (``cull_keep`` against ``crows``,
    ``cull_rows(wrows)``; ``unbounded_rows(crows)`` gives the walk without
    the cull, which the cull's checks hold it to).  Same float-op order as
    the kernel up to FMA contraction.  Returns blocked (N,) bool; with
    ``count_exec`` also open_groups and tested (T,) i32, each tile's 32-ray
    groups that held an open ray at a visit and those whose tests ran.

    ``stats``, a dict, gets the work the walk's early-out leaves: the
    (tile, cluster) pairs visited under ``"visits"``, K (ray, triangle)
    tests for each open ray of a visit under ``"tests"`` (whatever the cull
    skips), and the sums of open_groups and tested under ``"open_groups"``
    and ``"tested"``."""
    tiles = counts.shape[0]
    k = wrows.shape[1]
    o = origins.reshape(tiles, tile_r, 3)
    d = dirs.reshape(tiles, tile_r, 3)
    tm = t_max.reshape(tiles, tile_r)
    blocked = torch.zeros((tiles, tile_r), dtype=torch.bool,
                          device=origins.device)
    open_groups = torch.zeros((tiles,), dtype=torch.int32,
                              device=origins.device)
    tested = torch.zeros_like(open_groups)
    for i in range(visit.shape[1]):
        # Entries ascend along a list and the gate only falls, so a tile
        # that stops here never resumes.
        gate = torch.where(blocked, -BIG, tm).amax(dim=1)
        live = (counts > i) & (ventry[:, i] <= gate)
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        if stats is not None:
            open_rays = int(((tm[idx] > t_min) & ~blocked[idx]).sum())
            stats["visits"] = stats.get("visits", 0) + idx.numel()
            stats["tests"] = stats.get("tests", 0) + open_rays * k
        for sel in idx.split(PLAIN_CHUNK):
            cl = visit[sel, i].long()
            tms = tm[sel]
            open_ = (tms > t_min) & ~blocked[sel]
            opened = _group_any(open_, tile_r)
            run = _group_any(open_ & cull_keep(o[sel], d[sel], tms,
                                               crows[cl, None], t_min), tile_r)
            open_groups[sel] += opened.sum(dim=1, dtype=torch.int32)
            tested[sel] += run.sum(dim=1, dtype=torch.int32)
            t, u, v = _woop_tests(wrows[cl], o, d, sel)
            ok = ((u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= t_min)
                  & (t < tms[:, :, None]))
            runs = run.repeat_interleave(CULL_GROUP, dim=1)[:, :tile_r]
            blocked[sel] |= ok.any(dim=2) & runs
    if stats is not None:
        stats["open_groups"] = (stats.get("open_groups", 0)
                                + int(open_groups.sum()))
        stats["tested"] = stats.get("tested", 0) + int(tested.sum())
    if count_exec:
        return blocked.reshape(-1), open_groups, tested
    return blocked.reshape(-1)


def anyhit_work_items(counts: torch.Tensor, chunk: int = ANYHIT_CHUNK):
    """The any_hit kernel's work items: each tile's list positions
    [0, count) cut into runs of ``chunk``.  Returns (tile id, first
    position) as (W,) i32 each, W = sum(ceil(count / chunk)); reading W is
    one host sync (``sync.anyhit_items``)."""
    chunks = (counts.long() + chunk - 1) // chunk
    trace.count("sync.anyhit_items")
    n_items = int(chunks.sum())
    dev = counts.device
    work_tile = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), chunks, output_size=n_items)
    first = torch.cumsum(chunks, 0) - chunks  # each tile's first item
    start = (torch.arange(n_items, device=dev) - first[work_tile]) * chunk
    return work_tile.to(torch.int32), start.to(torch.int32)


def any_hit(origins, dirs, t_max, wrows, crows, visit, ventry, counts,
            tile_r: int, t_min=T_MIN, count_exec: bool = False):
    """Whether some triangle of its tile's visit list lies in [t_min,
    t_max) along each ray: the ``any_hit`` kernel for CUDA tensors, its
    plain version for CPU tensors.  Rays with t_max <= t_min are never
    blocked.  Returns blocked (N,) bool.  ``crows`` is ``cull_rows(wrows)``:
    at each visit a warp runs the triangle tests of its rays only if one of
    its open rays (armed and not yet blocked) meets the cluster's cull box
    before its t_max; blocked is that of a walk that tests every open ray.

    ``count_exec=True`` launches the kernel's counting build (counted as
    "any_hit_exec"; the same blocked) and also returns open_groups and
    tested (T,) i32: each tile's 32-ray groups that held an open ray at the
    visits its work items executed, and those whose triangle tests ran (1 -
    tested / open_groups is the share the cull skips).  On CPU tensors they
    are the plain walk's (``any_hit_plain``).  The kernel's equal the plain
    walk's on a tile whose list is one work item, but where FMA contraction
    flips a knife-edge test, and are no fewer on the others: a later item
    starts with no ray blocked.

    The kernel cuts each tile's list into work items of ``ANYHIT_CHUNK``
    positions that run in parallel (occlusion is an OR over clusters, so the
    result is the walk's); sizing the grid is one host sync.  ``visit``/``ventry``
    (T, stride) hold each tile's list in its first counts[t] positions;
    nothing past them is read."""
    if origins.device.type == "cpu":
        return any_hit_plain(origins, dirs, t_max, wrows, crows, visit,
                             ventry, counts, tile_r, t_min,
                             count_exec=count_exec)
    if not 1 <= tile_r <= ANYHIT_MAX_TILE_R:
        raise ValueError(f"tile_r {tile_r} outside [1, {ANYHIT_MAX_TILE_R}]")
    dev = origins.device
    tiles, stride = visit.shape
    n = tiles * tile_r
    c, k, _ = wrows.shape
    check_tensor("origins", origins, torch.float32, (n, 3), dev)
    check_tensor("dirs", dirs, torch.float32, (n, 3), dev)
    check_tensor("t_max", t_max, torch.float32, (n,), dev)
    check_tensor("wrows", wrows, torch.float32, (c, k, 12), dev)
    check_tensor("crows", crows, torch.float32, (c, 8), dev)
    if crows.data_ptr() % 16:
        raise ValueError("crows: not 16-byte aligned")
    check_tensor("visit", visit, torch.int32, (tiles, stride), dev)
    check_tensor("ventry", ventry, torch.float32, (tiles, stride), dev)
    check_tensor("counts", counts, torch.int32, (tiles,), dev)
    blocked = torch.zeros((n,), dtype=torch.uint8, device=dev)
    open_groups = tested = None
    if count_exec:
        open_groups = torch.zeros((tiles,), dtype=torch.int32, device=dev)
        tested = torch.zeros((tiles,), dtype=torch.int32, device=dev)
    with span("dxrt.occluder.items"):
        work_tile, work_start = anyhit_work_items(counts)
    n_items = work_tile.shape[0]
    if n_items:
        launch("any_hit_exec" if count_exec else "any_hit", "dxrt_any_hit",
               dev, origins.data_ptr(), dirs.data_ptr(), t_max.data_ptr(),
               wrows.data_ptr(), crows.data_ptr(), visit.data_ptr(),
               ventry.data_ptr(), counts.data_ptr(), work_tile.data_ptr(),
               work_start.data_ptr(), blocked.data_ptr(),
               None if open_groups is None else open_groups.data_ptr(),
               None if tested is None else tested.data_ptr(), n_items, tile_r,
               stride, k, t_min, ANYHIT_CHUNK)
    if count_exec:
        return blocked.view(torch.bool), open_groups, tested
    return blocked.view(torch.bool)


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


@dataclass
class ClosestQuery:
    """A closest-hit query's operands: rays padded to whole tiles with
    their seeds (``pad_and_seed``), the clusters' Woop rows and cull boxes,
    each tile's visit list from ``bin_lists`` (``width`` the longest
    list)."""

    origins: torch.Tensor
    dirs: torch.Tensor
    t_init: torch.Tensor
    wrows: torch.Tensor
    crows: torch.Tensor
    visit: torch.Tensor
    ventry: torch.Tensor
    counts: torch.Tensor
    tile_r: int
    width: int

    def args(self):
        """The positional operands of ``closest_hit``/``closest_hit_plain``."""
        return (self.origins, self.dirs, self.t_init, self.wrows, self.crows,
                self.visit, self.ventry, self.counts, self.tile_r)


def closest_query(origins, dirs, cs: ClusterSet, wrows, tile_r: int = TILE_R,
                  plain: bool = False, srows=None, crows=None) -> ClosestQuery:
    """The closest-hit walk's operands for a ray batch: padded, seeded and
    binned.  ``wrows``, ``srows``, ``crows`` and ``plain`` as in
    ``intersect_fused``.  Spans ``dxrt.query.stage`` (padding, seeds, tile
    and cluster rows) and ``dxrt.query.bin`` (the lists and their width's
    read)."""
    with span("dxrt.query.stage"):
        origins, dirs, t_init = pad_and_seed(origins, dirs, cs, tile_r)
        tp, cb = tile_params(origins, dirs, tile_r), cluster_rows(cs)
        crows = cull_rows(wrows) if crows is None else crows
    with span("dxrt.query.bin"):
        visit, ventry, counts, width = bin_lists(tp, cb, srows, plain=plain)
    return ClosestQuery(origins, dirs, t_init, wrows, crows, visit, ventry,
                        counts, tile_r, width)


def intersect_fused(origins, dirs, cs: ClusterSet, wrows, tile_r: int = TILE_R,
                    plain: bool = False, srows=None, crows=None) -> Hit:
    """Closest hit via binning + the per-tile cluster walk.

    ``wrows`` is ``woop_rows(cs)``, ``srows`` optionally
    ``super_rows(cluster_rows(cs))`` (built on demand when the cluster count
    calls for the superblock binner) and ``crows`` optionally
    ``cull_rows(wrows)``: left out, the query builds the boxes anew at each
    call, so every caller that holds a BVH passes its ``crows``.  Returns a
    Hit with the exact t and slot (== triangle id: the geometry is
    treelet-ordered) and u = v = 0;
    ``ops.intersect.hit_record`` re-evaluates t/u/v and fetches the ids.
    ``plain=True`` runs the kernels' plain versions on any device (the
    reference the kernels are checked against on the card).  The walk
    and the unpadding are the span ``dxrt.query.walk``.
    """
    if not cs.identity_order:
        raise ValueError("intersect_fused needs treelet-ordered clusters")
    n = origins.shape[0]
    q = closest_query(origins, dirs, cs, wrows, tile_r, plain, srows, crows)
    with span("dxrt.query.walk"):
        best_t, best_slot = (closest_hit_plain(*q.args()) if plain
                             else closest_hit(*q.args(), width=q.width))
        best_t, best_slot = best_t[:n], best_slot[:n]
        hit = best_slot >= 0
        zero = torch.zeros_like(best_t)
        return Hit(t=torch.where(hit, best_t, float("inf")), tri=best_slot,
                   u=zero, v=zero)


def pad_and_cap(origins, dirs, t_max, tile_r: int):
    """Shadow rays padded to whole tiles with parked rays (origin 1e30,
    dir 1, t_max 0: they bin nothing and are never blocked), and each
    tile's binning cap ``max(t_max over the tile) * (1 + 2**-11) + 1e-7``
    (pallas_intersect.py:1166-1191): a cluster entered past every ray's
    t_max cannot occlude, and a fully disarmed tile bins nothing.  Returns
    contiguous origins, dirs (M, 3), t_max (M,) and t_cap (M / tile_r,)."""
    pad = (-origins.shape[0]) % tile_r
    if pad:
        origins = torch.cat([origins, origins.new_full((pad, 3), 1e30)])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros((pad,))])
    t_cap = t_max.reshape(-1, tile_r).amax(dim=1) * (1.0 + 2.0 ** -11) + 1e-7
    return origins.contiguous(), dirs.contiguous(), t_max.contiguous(), t_cap


def anyhit_schedule(origins, dirs, t_max, cs: ClusterSet, wrows, crows,
                    tile_r: int = TILE_R, plain: bool = False, srows=None):
    """The any-hit walk's operands for a shadow batch: rays padded to whole
    tiles (``pad_and_cap``), each tile bounded over its ARMED rays
    (t_max > T_MIN) only and capped at its largest t_max, binned, and cut
    into visit lists (``bin_lists``).  Returns ``any_hit``'s positional
    operands (origins, dirs, t_max, wrows, crows, visit, ventry, counts,
    tile_r), the clusters' Woop rows and cull boxes passed through.

    Bounding over armed rays is exact (a disarmed ray is never blocked) and
    matters: a Morton-sorted shadow batch has one tile per light where the
    armed rays meet the parked tail (origin 1e30), whose all-lane box would
    bin every cluster and leave one CTA walking them all.

    Spans ``dxrt.occluder.stage`` (padding, caps, tile and cluster rows)
    and ``dxrt.occluder.bin``."""
    with span("dxrt.occluder.stage"):
        origins, dirs, t_max, t_cap = pad_and_cap(origins, dirs, t_max, tile_r)
        tp = tile_params(origins, dirs, tile_r, t_cap=t_cap, live=t_max > T_MIN)
        cb = cluster_rows(cs)
    with span("dxrt.occluder.bin"):
        visit, ventry, counts, _ = bin_lists(tp, cb, srows, plain=plain)
    return origins, dirs, t_max, wrows, crows, visit, ventry, counts, tile_r


def occluded_fused(origins, dirs, cs: ClusterSet, wrows, crows, t_max,
                   tile_r: int = TILE_R, plain: bool = False,
                   srows=None) -> torch.Tensor:
    """Any hit: (N,) bool, True where a triangle lies in [T_MIN, t_max[i])
    along ray i: ``anyhit_schedule``, then the any-hit walk (the span
    ``dxrt.occluder.walk``, with the kernel path's ``dxrt.occluder.items``
    inside).  ``wrows``, ``srows`` and ``plain`` as in ``intersect_fused``;
    ``crows`` is ``cull_rows(wrows)``, which a caller holding a BVH passes
    as ``bvh.crows`` (the query never builds it)."""
    args = anyhit_schedule(origins, dirs, t_max, cs, wrows, crows, tile_r,
                           plain, srows)
    with span("dxrt.occluder.walk"):
        blocked = (any_hit_plain if plain else any_hit)(*args)
        return blocked[:origins.shape[0]]
