"""The wavefront: the ray queue and the pass loop of the Whitted and
path-traced frames.

Counterpart of the queue and pass half of
``directx_raytracer_tpu/render/whitted.py`` (``PIXEL_SENTINEL``,
``_compact_sort``, ``_shade_pass``, ``_shade_pass_bounce``) and of
``directx_raytracer_tpu/render/pathtrace.py`` (``_pt_pass``,
``_pt_pass_bounce``), as plain functions on the scene tensors' device.

A wavefront is a queue of rows (origins, dirs, RGB throughput, pixel id,
active flag).  The primary wavefront (``primary_wavefront``) holds one ray
a pixel, generated in the framebuffer's order (tile-major: coherent tiles
feed the binned intersector); every later one is a compacted queue of
fixed capacity whose live rows come first.  ``run_passes`` runs a frame's
passes over it, each a ``dxrt.pass`` span (utils/trace.py):

1. a bounce pass takes the live prefix of its queue, whose length the
   previous compaction has read (an all-parked queue skips the pass);
2. ``dxrt.query``, the closest hit, and ``dxrt.hit_record``, one
   packed-record gather of the surface attributes (``closest_hits``);
3. ``dxrt.shade``: the frame's shading step, the loop's one varying part;
4. ``dxrt.commit``: the contributions into the framebuffer, a plain add on
   the primary pass (its rays are in framebuffer order), one scatter-add
   by pixel id after it;
5. ``dxrt.compact``, unless it is the last pass: the continuations into
   the next queue, with one stable key sort and one gather of the live
   rows (``_compact_sort``).  Reading the live count is the pass's host
   sync.

A shading step is called as ``shade(state, hit, rec, depth, last)`` and
returns (contrib, branches): the (N, 3) terminal contribution of each row
(zero for inactive rows) and the rows' continuations as a tuple of one or
two candidate dicts of N rows each, which the last pass never reads (it
may return None).  With two, the second is the branch an overflowing queue
drops first.

The debug build's guards (``utils.checks``) sit on the commit, where a
value becomes user-visible: a non-finite contribution, a live primary
ray's pixel id outside the framebuffer, and a queue id that is neither in
the framebuffer nor the parked sentinel.
"""

from __future__ import annotations

import torch

from ..ops.intersect import hit_record, intersect_bruteforce, occluded_bruteforce
from ..ops.rays import generate_rays, generate_rays_tiled
from ..utils import checks, trace
from ..utils.trace import span
from .debug import isect_kwargs

# Pixel ids ride the compacted queue's packed f32 row as their NUMERIC value
# (exact for ids < 2^24), never as a bitcast int32 pattern: small ids bitcast
# to f32 denormals, which a flush-to-zero data path destroys.  2^24 doubles
# as the parked-slot sentinel: >= any frame's pixel count, so the
# framebuffer scatter sends it to the sink row.
PIXEL_SENTINEL = 1 << 24

# A parked queue row: origin far outside the scene with strictly positive
# direction components, so its tiles bin to nothing; no throughput.
_PARK = (1e30, 1e30, 1e30, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, float(PIXEL_SENTINEL))


def _default_intersect(origins, dirs, geo, tile_r=None):
    return intersect_bruteforce(origins, dirs, geo.woop)


def _default_occluder(geo):
    def occluder(origins, dirs, max_t):
        return occluded_bruteforce(origins, dirs, geo.woop, max_t)

    return occluder


def queue_capacity(n_pix: int, queue_factor: int) -> int:
    """Bounce-queue rows: ``n_pix * queue_factor`` rounded up to whole
    chunks of ``ceil(max(q // 16, 256) / 256) * 256`` rows — the JAX
    package's capacity (whitted.py:504-506), so alive and dropped counts
    compare pass by pass."""
    q = n_pix * queue_factor
    chunk = -(-max(q // 16, 256) // 256) * 256
    return -(-q // chunk) * chunk


def _compact_sort(cand: dict, capacity: int, scene_lo, scene_hi,
                  split_at: int | None = None):
    """Compact + coherence-sort candidate rays into a queue of ``capacity``
    rows with one stable key sort and one gather of the live rows.

    Sort key (int32), most- to least-significant: inactive (parked last) |
    droppable branch (candidate indices >= ``split_at``, the
    Fresnel-reflection half — overflow drops it before the transmission
    half) | direction octant (3b) | origin Morton cell (24b).  Rows past the
    live prefix are parked.  Reading the live count is the pass's host
    sync (``sync.compact_count``), and the parked row's copy another
    (``sync.park_row``).

    Returns (queue, n_alive, n_dropped), the counts as Python ints and
    n_alive clamped to ``capacity``.
    """
    o = cand["origins"]
    d = cand["dirs"]
    q2 = o.shape[0]
    active = cand["active"]
    dev = o.device
    i32 = torch.int32

    ext = (scene_hi - scene_lo).clamp(min=1e-12)
    cell = ((o - scene_lo) / ext * 256.0).clamp(0.0, 255.0).to(i32)
    morton = torch.zeros((q2,), dtype=i32, device=dev)
    for bit in range(8):
        for ax in range(3):
            morton = morton | (((cell[:, ax] >> bit) & 1) << (3 * bit + ax))
    octant = (((d[:, 0] > 0).to(i32) << 2) | ((d[:, 1] > 0).to(i32) << 1)
              | (d[:, 2] > 0).to(i32))
    key = (octant << 24) | morton
    if split_at is not None:
        late = torch.arange(q2, dtype=i32, device=dev) >= split_at
        key = key | (late.to(i32) << 27)
    key = torch.where(active, key, 1 << 29)
    order = torch.sort(key, stable=True).indices

    trace.count("sync.compact_count")
    n_active = int(active.sum())
    n_alive = min(n_active, capacity)
    src = torch.cat(
        [o, d, cand["throughput"],
         cand["pixel"].clamp(max=PIXEL_SENTINEL).to(torch.float32)[:, None]],
        dim=1)
    packed = trace.upload(_PARK, dev, "park_row").repeat(capacity, 1)
    packed[:n_alive] = src[order[:n_alive]]
    queue = {
        "origins": packed[:, 0:3],
        "dirs": packed[:, 3:6],
        "throughput": packed[:, 6:9],
        "pixel": packed[:, 9].to(i32),
        "active": torch.arange(capacity, device=dev) < n_alive,
    }
    return queue, n_alive, max(n_active - capacity, 0)


def new_framebuffer(n_pix: int, device) -> torch.Tensor:
    """(n_pix + 1, 3) f32 zeros: the frame's pixel rows and one sink row
    for the ids the scatter must drop.  The queue carries pixel ids as f32
    values below ``PIXEL_SENTINEL``, so a larger frame raises."""
    if n_pix >= PIXEL_SENTINEL:
        raise ValueError(f"{n_pix} pixels: ids must stay below {PIXEL_SENTINEL}")
    return torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=device)


def primary_wavefront(cam_position, cam_rotation, width: int, height: int,
                      offset, row_start: int, rows: int, tile,
                      throughput: torch.Tensor) -> dict:
    """The primary wavefront of the full-width row band [row_start,
    row_start + rows) of a (height x width) frustum: one ray a pixel
    through sub-pixel ``offset``, in the framebuffer's order (tile-major
    in ``tile`` = (th, tw), raster order when None), carrying
    ``throughput`` (rows * width, 3), on that tensor's device."""
    dev = throughput.device
    if tile is None:
        origins, dirs = generate_rays(cam_position, cam_rotation, width,
                                      height, offset, row_start, rows,
                                      device=dev)
    else:
        origins, dirs = generate_rays_tiled(
            cam_position, cam_rotation, width, height, tile[0], tile[1],
            offset, row_start, rows, device=dev)
    n_pix = width * rows
    return {
        "origins": origins,
        "dirs": dirs,
        "throughput": throughput,
        "pixel": torch.arange(n_pix, dtype=torch.int32, device=dev),
        "active": torch.ones((n_pix,), dtype=torch.bool, device=dev),
    }


def closest_hits(geo, state, intersect_fn, tile_r=None):
    """The closest hit of each row of ``state`` (span ``dxrt.query``), then
    its record (``dxrt.hit_record``): (hit, rec) as
    ``ops.intersect.hit_record`` gives them.  ``tile_r`` overrides the
    intersector's ray chunk (``render.debug.isect_kwargs``)."""
    with span("dxrt.query"):
        hit = intersect_fn(state["origins"], state["dirs"], geo,
                           **isect_kwargs(intersect_fn, tile_r))
    with span("dxrt.hit_record"):
        hit, _, _, _, rec = hit_record(state["origins"], state["dirs"],
                                       geo.packed, hit)
    return hit, rec


def _commit(framebuffer, state, contrib, primary: bool) -> None:
    sink = framebuffer.shape[0] - 1
    ids = state["pixel"]
    checks.check(lambda: torch.isfinite(contrib).all(),
                 "non-finite framebuffer contribution in shade pass")
    if primary:
        # The add is by position: a live ray's id outside the framebuffer
        # would ride the queue, and a bounce's commit would drop it unseen.
        checks.check(
            lambda: (~state["active"] | ((ids >= 0) & (ids < sink))).all(),
            "wavefront pixel id out of framebuffer range")
        framebuffer[:contrib.shape[0]] += contrib
        return
    # The queue invariant, on the ids as the queue holds them (before they
    # are redirected to the sink): live ids in range, parked ids exactly the
    # sentinel.
    checks.check(
        lambda: ((ids >= 0) & ((ids < sink) | (ids == PIXEL_SENTINEL))).all(),
        "bounce commit pixel id outside framebuffer/sentinel range")
    ids = torch.where((ids >= 0) & (ids < sink), ids, sink)
    framebuffer.index_add_(0, ids.long(), contrib)


def _pass(dscene, state, framebuffer, shade, intersect_fn, depth: int,
          last: bool, capacity: int, n_alive: int | None = None,
          tile_r=None):
    """One pass: over every row of ``state`` on the primary pass
    (``n_alive`` None), over its live prefix ``state[:n_alive]`` on a
    bounce.  ``tile_r`` is the primary pass's ray chunk (the pixel tile).
    Returns (the next queue of ``capacity`` rows or None after the last
    pass, its live count, the rows its compaction dropped)."""
    geo = dscene.geometry
    primary = n_alive is None
    if not primary:
        if n_alive == 0:  # an all-parked queue stays one
            return (None if last else state), 0, 0
        state = {k: v[:n_alive] for k, v in state.items()}
    hit, rec = closest_hits(geo, state, intersect_fn, tile_r)
    with span("dxrt.shade"):
        contrib, branches = shade(state, hit, rec, depth, last)
    with span("dxrt.commit"):
        _commit(framebuffer, state, contrib, primary)
    if last:  # the continuations are never consumed: no compaction
        return None, 0, 0
    with span("dxrt.compact"):
        cand, split_at = branches[0], None
        if len(branches) == 2:  # the second branch goes after the first
            cand = {k: torch.cat([branches[0][k], branches[1][k]])
                    for k in cand}
            split_at = branches[0]["origins"].shape[0]
        return _compact_sort(cand, capacity, geo.scene_lo, geo.scene_hi,
                             split_at)


def run_passes(dscene, state, framebuffer, shade, intersect_fn, tile_r,
               max_depth: int, capacity: int) -> list:
    """``max_depth`` passes from the primary wavefront ``state`` into
    ``framebuffer`` (``new_framebuffer``), shading with ``shade``; the
    bounce queues hold ``capacity`` rows (``queue_capacity``).  Returns
    each pass's (alive, dropped): the rows its compaction kept and those
    the queue had no room for, 0 and 0 for the last pass and for a pass
    over an empty queue."""
    stats, n_alive = [], None
    for depth in range(max_depth):
        with span("dxrt.pass"):
            state, n_alive, dropped = _pass(
                dscene, state, framebuffer, shade, intersect_fn, depth,
                depth == max_depth - 1, capacity, n_alive=n_alive,
                tile_r=tile_r if depth == 0 else None)
        stats.append((n_alive, dropped))
    return stats
