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
   the next queue (``compact``): the sort keys in one launch
   (``compact_keys``), one stable key sort, the queue in one launch
   (``compact_gather``), both kernels of ``csrc/compact.cu`` with plain
   twins that CPU tensors take.  Reading the live counts is the pass's
   host sync.

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

from ..kernels import check_tensor, launch
from ..ops.intersect import hit_record, intersect_bruteforce, occluded_bruteforce
from ..ops.rays import generate_rays, generate_rays_tiled
from ..ops.shading import morton_key
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


def key_dtype(n_samples: int) -> torch.dtype:
    """The compaction's sort key: i32 where the inactive rows' key
    ``n_samples << 28``, above every live key, fits (``n_samples`` <= 7),
    else i64.  Both give the stable sort the same permutation."""
    return torch.int32 if n_samples << 28 <= 2**31 - 1 else torch.int64


def _column(branches, name: str):
    """Column ``name`` of the candidate list: the branches' rows, A then B."""
    if len(branches) == 1:
        return branches[0][name]
    return torch.cat([b[name] for b in branches])


def compact_keys_plain(branches, sample, n_samples: int, lo, hi):
    """The sort key of each candidate row of ``branches`` (one or two dicts
    of N rows: A, then B) as torch chains, ``key_dtype(n_samples)``; most-
    to least-significant: the row's sample (``sample[row mod N]``, None
    for one sample) | B | direction octant (3b) | origin Morton cell in
    the box (lo, hi) (24b); ``n_samples << 28`` for an inactive row."""
    o, d = _column(branches, "origins"), _column(branches, "dirs")
    active = _column(branches, "active")
    q2, dev, i32 = o.shape[0], o.device, torch.int32
    octant = (((d[:, 0] > 0).to(i32) << 2) | ((d[:, 1] > 0).to(i32) << 1)
              | (d[:, 2] > 0).to(i32))
    key = ((octant << 24) | morton_key(o, lo, hi, 8)).to(key_dtype(n_samples))
    if len(branches) == 2:
        late = torch.arange(q2, device=dev) >= branches[0]["origins"].shape[0]
        key = key | (late.to(key.dtype) << 27)
    if sample is not None:
        key = key | (torch.cat([sample] * len(branches)).to(key.dtype) << 28)
    return torch.where(active, key, n_samples << 28)


def compact_gather_plain(branches, order, bounds, capacity: int,
                         n_samples: int) -> dict:
    """The queue of ``n_samples * capacity`` rows as torch chains: from the
    stable sort's ``order`` and ``bounds`` (``compact``), each sample's
    first ``capacity`` live rows, sample after sample, then parked rows;
    with ``n_samples`` > 1 a ``sample`` column (0 on parked rows)."""
    b = bounds.tolist()
    kept = [min(b[2 * s + 2] - b[2 * s], capacity) for s in range(n_samples)]
    take = torch.cat([order[b[2 * s]:b[2 * s] + n]
                      for s, n in enumerate(kept)])
    cand = {k: _column(branches, k)
            for k in ("origins", "dirs", "throughput", "pixel")}
    rows = n_samples * capacity
    queue = _gather_queue(cand, take, rows)
    if n_samples > 1:
        dev = take.device
        queue["sample"] = torch.zeros(rows, dtype=torch.int32, device=dev)
        queue["sample"][:take.shape[0]] = torch.repeat_interleave(
            torch.arange(n_samples, dtype=torch.int32, device=dev),
            torch.tensor(kept, device=dev))
    return queue


def _gather_queue(cand: dict, take, rows: int) -> dict:
    """A queue of ``rows`` rows: ``cand``'s rows ``take`` in front, parked
    rows after them."""
    dev = cand["origins"].device
    n_alive = take.shape[0]
    src = torch.cat(
        [cand["origins"], cand["dirs"], cand["throughput"],
         cand["pixel"].clamp(max=PIXEL_SENTINEL).to(torch.float32)[:, None]],
        dim=1)
    packed = torch.tensor(_PARK, dtype=torch.float32, device=dev).repeat(rows, 1)
    packed[:n_alive] = src[take]
    return {
        "origins": packed[:, 0:3],
        "dirs": packed[:, 3:6],
        "throughput": packed[:, 6:9],
        "pixel": packed[:, 9].to(torch.int32),
        "active": torch.arange(rows, device=dev) < n_alive,
    }


def _operand(name: str, x, dtype, shape, device):
    """``x`` as a kernel reads it: ``dtype`` and ``shape`` on ``device``
    (else raise), its last axis adjacent (copied when it is not)."""
    if x.dtype != dtype or x.device != device or tuple(x.shape) != shape:
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"expected {dtype} {shape} on {device}")
    return x if x.stride(-1) == 1 else x.contiguous()


def _branch_operands(branches, names, device) -> tuple[list, list]:
    """Each branch's columns ``names`` as the kernels read them (see
    ``csrc/compact.cu``): a pointer and a row stride for a 3-wide f32
    column, a pointer for pixel and active; None and 0 for an absent
    branch B.  Returns (the launch arguments, the tensors they point into,
    which the caller holds until the launch so that no allocation before
    it takes their memory)."""
    n = branches[0]["origins"].shape[0]
    args, held = [], []
    for b in (*branches, None)[:2]:
        for name in names:
            if name in ("pixel", "active"):
                if b is None:
                    args.append(None)
                    continue
                dtype = torch.int32 if name == "pixel" else torch.bool
                x = _operand(name, b[name], dtype, (n,), device)
                args.append(x.data_ptr())
            else:
                if b is None:
                    args += [None, 0]
                    continue
                x = _operand(name, b[name], torch.float32, (n, 3), device)
                args += [x.data_ptr(), x.stride(0)]
            held.append(x)
    return args, held


def compact_keys(branches, sample, n_samples: int, lo, hi):
    """``compact_keys_plain``'s keys: for CUDA tensors one launch of
    ``csrc/compact.cu``'s key kernel, counted as ``launch.compact_keys``;
    for CPU tensors the plain chains."""
    device = branches[0]["origins"].device
    if device.type == "cpu":
        return compact_keys_plain(branches, sample, n_samples, lo, hi)
    n = branches[0]["origins"].shape[0]
    args, held = _branch_operands(branches, ("origins", "dirs", "active"),
                                  device)
    check_tensor("lo", lo, torch.float32, (3,), device)
    check_tensor("hi", hi, torch.float32, (3,), device)
    if sample is not None:
        sample = _operand("sample", sample, torch.int32, (n,), device)
    key = torch.empty((len(branches) * n,), dtype=key_dtype(n_samples),
                      device=device)
    if n == 0:
        return key
    launch("compact_keys", "dxrt_compact_keys", device, *args, n,
           len(branches), None if sample is None else sample.data_ptr(),
           lo.data_ptr(), hi.data_ptr(), n_samples,
           int(key.dtype == torch.int64), key.data_ptr())
    return key


def compact_gather(branches, order, bounds, capacity: int,
                   n_samples: int) -> dict:
    """``compact_gather_plain``'s queue: for CUDA tensors one launch of
    ``csrc/compact.cu``'s gather kernel, counted as
    ``launch.compact_gather``, which reads the counts in ``bounds`` on the
    card; for CPU tensors the plain chains."""
    device = branches[0]["origins"].device
    if device.type == "cpu":
        return compact_gather_plain(branches, order, bounds, capacity,
                                    n_samples)
    n = branches[0]["origins"].shape[0]
    args, held = _branch_operands(
        branches, ("origins", "dirs", "throughput", "pixel"), device)
    check_tensor("order", order, torch.int64, (len(branches) * n,), device)
    check_tensor("bounds", bounds, torch.int64, (2 * n_samples + 1,), device)
    rows = n_samples * capacity
    packed = torch.empty((rows, 10), dtype=torch.float32, device=device)
    pixel = torch.empty((rows,), dtype=torch.int32, device=device)
    active = torch.empty((rows,), dtype=torch.bool, device=device)
    sample = (torch.empty((rows,), dtype=torch.int32, device=device)
              if n_samples > 1 else None)
    launch("compact_gather", "dxrt_compact_gather", device, *args, n,
           order.data_ptr(), bounds.data_ptr(), n_samples, capacity,
           packed.data_ptr(), pixel.data_ptr(), active.data_ptr(),
           None if sample is None else sample.data_ptr())
    queue = {"origins": packed[:, 0:3], "dirs": packed[:, 3:6],
             "throughput": packed[:, 6:9], "pixel": pixel, "active": active}
    if sample is not None:
        queue["sample"] = sample
    return queue


def compact(branches, capacity: int, scene_lo, scene_hi, sample=None,
            n_samples: int = 1):
    """Compact + coherence-sort the candidate rows of ``branches`` (one or
    two dicts of N rows: A, then B, the Fresnel-reflection half that an
    overflowing queue drops first) into a queue of ``capacity`` rows a
    sample, with one key launch (``compact_keys``), one stable key sort
    and one gather launch (``compact_gather``).

    Sort key, most- to least-significant: inactive (parked last) | sample
    | branch B | direction octant (3b) | origin Morton cell (24b).  With
    ``n_samples`` > 1 the rows are that many samples' (``sample``, N rows:
    a row's sample, the same in both branches), so each sample's live rows
    sort together and in the order they would sort alone, each sample keeps
    at most ``capacity`` of them, and the queue (``n_samples * capacity``
    rows, with its ``sample`` column) holds them sample after sample.  Rows
    past the live ones are parked.  One search of the sorted keys gives
    every (sample, branch)'s live count, and reading it is the compaction's
    one host sync (``sync.compact_count``); the gather reads the counts on
    the card.  Branch B's live rows count under ``whitted.split``, the live
    rows the queue has no room for under ``wavefront.dropped``.

    Returns (queue, n_alive, n_dropped), the counts as Python ints and
    n_alive clamped to ``capacity``; with ``n_samples`` > 1, lists of one
    count a sample.
    """
    key = compact_keys(branches, sample, n_samples, scene_lo, scene_hi)
    key, order = torch.sort(key, stable=True)
    # The live rows of sample s, branch b (the droppable bit, 1 << 27) start
    # at the first key >= (2s + b) << 27.
    step = 1 << 27
    bounds = torch.searchsorted(key, torch.arange(
        0, (2 * n_samples + 1) * step, step, dtype=key.dtype, device=key.device))
    trace.count("sync.compact_count")
    b = bounds.tolist()
    queue = compact_gather(branches, order, bounds, capacity, n_samples)
    live = [b[2 * s + 2] - b[2 * s] for s in range(n_samples)]
    alive = [min(n, capacity) for n in live]
    if len(branches) == 2:
        trace.count("whitted.split", sum(b[2 * s + 2] - b[2 * s + 1]
                                         for s in range(n_samples)))
    trace.count("wavefront.dropped", sum(live) - sum(alive))
    dropped = [n - a for n, a in zip(live, alive)]
    if n_samples == 1:
        return queue, alive[0], dropped[0]
    return queue, alive, dropped


def _compact_sort(cand: dict, capacity: int, scene_lo, scene_hi,
                  split_at: int | None = None, n_samples: int = 1):
    """``compact`` over one candidate list, the JAX package's form: with
    ``split_at`` its rows are two branches of ``split_at`` rows each (A,
    then B), and with ``n_samples`` > 1 its ``sample`` column holds each
    row's sample."""
    if split_at is None:
        branches = (cand,)
    else:
        branches = ({k: v[:split_at] for k, v in cand.items()},
                    {k: v[split_at:] for k, v in cand.items()})
    sample = cand["sample"][:split_at] if n_samples > 1 else None
    return compact(branches, capacity, scene_lo, scene_hi, sample, n_samples)


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
    as ``compact`` gives them."""
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
        return compact(branches, capacity, geo.scene_lo, geo.scene_hi,
                       state["sample"] if n_samples > 1 else None, n_samples)


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
