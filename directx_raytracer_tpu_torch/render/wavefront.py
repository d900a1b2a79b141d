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

A wavefront may hold several sub-pixel samples of the same pixels at once
(``n_samples`` > 1): the primary wavefront is the samples' rows back to
back, each row carries its sample's index under ``sample``, and each
compaction keeps every sample's queue of ``capacity`` rows as if the sample
ran alone, its live rows packed sample after sample.  A pass then pays its
launches and its host sync once for all the samples.

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
                  split_at: int | None = None, n_samples: int = 1):
    """Compact + coherence-sort candidate rays into a queue of ``capacity``
    rows with one stable key sort and one gather of the live rows.

    Sort key (int32), most- to least-significant: inactive (parked last) |
    droppable branch (candidate indices >= ``split_at``, the
    Fresnel-reflection half — overflow drops it before the transmission
    half) | direction octant (3b) | origin Morton cell (24b).  Rows past the
    live prefix are parked.  Reading the live count is the pass's host
    sync (``sync.compact_count``), and the parked row's copy another
    (``sync.park_row``).  With ``split_at`` the list is two branches of
    ``split_at`` rows each, and that one read gives the live count of
    both: the droppable branch's is counted under ``whitted.split``.  The
    live rows the queue has no room for are counted under
    ``wavefront.dropped``.

    With ``n_samples`` > 1 the rows are that many samples' (``cand``'s
    ``sample`` column): the sample's index sits above the key, so each
    sample's live rows sort together and in the order they would sort
    alone, each sample keeps at most ``capacity`` of them, and the queue
    (``n_samples * capacity`` rows, with its ``sample`` column) holds them
    sample after sample.  The one read gives every sample's counts.

    Returns (queue, n_alive, n_dropped), the counts as Python ints and
    n_alive clamped to ``capacity``; with ``n_samples`` > 1, lists of one
    count a sample.
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
    if n_samples > 1:
        return _compact_samples(cand, key, capacity, split_at, n_samples)
    key = torch.where(active, key, 1 << 29)
    order = torch.sort(key, stable=True).indices

    trace.count("sync.compact_count")
    if split_at is None:
        n_active = int(active.sum())
    else:
        n_first, n_split = active.view(2, split_at).sum(dim=1).tolist()
        n_active = n_first + n_split
        trace.count("whitted.split", n_split)
    n_alive = min(n_active, capacity)
    trace.count("wavefront.dropped", n_active - n_alive)
    return (_gather_queue(cand, order[:n_alive], capacity), n_alive,
            max(n_active - capacity, 0))


def _compact_samples(cand: dict, key, capacity: int, split_at, n_samples: int):
    """``_compact_sort`` over ``n_samples`` samples' rows, from their
    (int32, active rows') sort key."""
    active = cand["active"]
    dev = active.device
    sample = cand["sample"].long()
    key = torch.where(active, key.long() | (sample << 28), 1 << 62)
    key, order = torch.sort(key, stable=True)
    # The live rows of sample s, branch b (the droppable bit, 1 << 27) start
    # at the first key >= (2s + b) << 27: one search gives every count.
    bounds = torch.arange(2 * n_samples + 1, device=dev) << 27
    counts = torch.searchsorted(key, bounds).diff()

    trace.count("sync.compact_count")
    counts = counts.tolist()
    first, split = counts[0::2], counts[1::2]
    live = [a + b for a, b in zip(first, split)]
    alive = [min(n, capacity) for n in live]
    if split_at is not None:
        trace.count("whitted.split", sum(split))
    trace.count("wavefront.dropped", sum(live) - sum(alive))
    take = order[:sum(alive)]
    if alive != live:  # each sample's first rows, the rest dropped
        starts = [0]
        for n in live[:-1]:
            starts.append(starts[-1] + n)
        take = torch.cat([order[s:s + n] for s, n in zip(starts, alive)])
    queue = _gather_queue(cand, take, n_samples * capacity)
    queue["sample"] = torch.zeros(n_samples * capacity, dtype=torch.int32,
                                  device=dev)
    queue["sample"][:take.shape[0]] = cand["sample"][take]
    return queue, alive, [n - a for n, a in zip(live, alive)]


def _gather_queue(cand: dict, take, rows: int) -> dict:
    """A queue of ``rows`` rows: ``cand``'s rows ``take`` in front, parked
    rows after them."""
    dev = cand["origins"].device
    n_alive = take.shape[0]
    src = torch.cat(
        [cand["origins"], cand["dirs"], cand["throughput"],
         cand["pixel"].clamp(max=PIXEL_SENTINEL).to(torch.float32)[:, None]],
        dim=1)
    packed = trace.upload(_PARK, dev, "park_row").repeat(rows, 1)
    packed[:n_alive] = src[take]
    return {
        "origins": packed[:, 0:3],
        "dirs": packed[:, 3:6],
        "throughput": packed[:, 6:9],
        "pixel": packed[:, 9].to(torch.int32),
        "active": torch.arange(rows, device=dev) < n_alive,
    }


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
        if contrib.shape[0] > sink:  # the samples' rows, back to back
            contrib = contrib.view(-1, sink, 3).sum(dim=0)
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
          tile_r=None, n_samples: int = 1):
    """One pass: over every row of ``state`` on the primary pass
    (``n_alive`` None), over its live prefix ``state[:n_alive]`` on a
    bounce.  ``tile_r`` is the primary pass's ray chunk (the pixel tile).
    Returns (the next queue of ``capacity`` rows a sample or None after the
    last pass, its live count, the rows its compaction dropped), the counts
    as ``_compact_sort`` gives them."""
    geo = dscene.geometry
    primary = n_alive is None
    if not primary:
        if n_alive == 0:  # an all-parked queue stays one
            zero = 0 if n_samples == 1 else [0] * n_samples
            return (None if last else state), zero, zero
        state = {k: v[:n_alive] for k, v in state.items()}
    hit, rec = closest_hits(geo, state, intersect_fn, tile_r)
    with span("dxrt.shade"):
        contrib, branches = shade(state, hit, rec, depth, last)
    with span("dxrt.commit"):
        _commit(framebuffer, state, contrib, primary)
    if last:  # the continuations are never consumed: no compaction
        zero = 0 if n_samples == 1 else [0] * n_samples
        return None, zero, zero
    with span("dxrt.compact"):
        cand, split_at = branches[0], None
        if len(branches) == 2:  # the second branch goes after the first
            cand = {k: torch.cat([branches[0][k], branches[1][k]])
                    for k in cand}
            split_at = branches[0]["origins"].shape[0]
        if n_samples > 1:
            cand["sample"] = torch.cat([state["sample"]] * len(branches))
        return _compact_sort(cand, capacity, geo.scene_lo, geo.scene_hi,
                             split_at, n_samples)


def run_passes(dscene, state, framebuffer, shade, intersect_fn, tile_r,
               max_depth: int, capacity: int, n_samples: int = 1) -> list:
    """``max_depth`` passes from the primary wavefront ``state`` into
    ``framebuffer`` (``new_framebuffer``), shading with ``shade``; the
    bounce queues hold ``capacity`` rows a sample (``queue_capacity``).
    ``state`` holds ``n_samples`` samples' rows (see the module doc).
    Returns each pass's (alive, dropped): the rows its compaction kept and
    those the queue had no room for, 0 and 0 for the last pass and for a
    pass over an empty queue; with ``n_samples`` > 1, lists of one count a
    sample."""
    stats, n_alive = [], None
    for depth in range(max_depth):
        with span("dxrt.pass"):
            state, alive, dropped = _pass(
                dscene, state, framebuffer, shade, intersect_fn, depth,
                depth == max_depth - 1, capacity, n_alive=n_alive,
                tile_r=tile_r if depth == 0 else None, n_samples=n_samples)
        stats.append((alive, dropped))
        n_alive = alive if n_samples == 1 else sum(alive)
    return stats
