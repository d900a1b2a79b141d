"""Wavefront Whitted renderer — the feature set the reference *declares*
but never executes.

Counterpart of ``directx_raytracer_tpu/render/whitted.py``
(``MIN_THROUGHPUT``, ``PIXEL_SENTINEL``, ``_compact_sort``,
``_shade_chunk``, ``_shade_pass``, ``_shade_pass_bounce``, ``render_tile``,
``spp_offsets``, ``render_whitted``, ``render_whitted_checked``), as plain
functions on the scene tensors' device.

The reference parses materials, point lights and textures
(CRTSceneParser.cpp:152-405) yet uploads none of it to the GPU, caps
``MaxTraceRecursionDepth`` at 1 (DXRTRenderer.cpp:1169-1179) and never calls
``TraceRay`` from its closest-hit shader — so shadows/reflection/refraction
exist only as capability surface (SURVEY.md facts 1-2).  Here that surface is
made real as a wavefront rather than a recursive per-pixel shader:

* a ray wavefront is a queue of rows (origins, dirs, RGB throughput, pixel
  id, active flag); the primary wavefront is generated in tile-major order
  (coherent tiles feed the binned intersector) and the framebuffer lives in
  the same order;
* each pass: closest hit, one packed-record gather for the surface
  attributes, terminal shading into the framebuffer (a plain add on the
  primary pass, one scatter-add afterwards), then the surviving specular
  continuations are compacted (one key sort + one gather of the live rows)
  into the next wavefront;
* the live count is read once per compaction (one host sync), and a bounce
  pass shades only the live prefix of its queue;
* each pass is a ``dxrt.pass`` span holding ``dxrt.query``,
  ``dxrt.hit_record``, ``dxrt.shade``, ``dxrt.commit`` and ``dxrt.compact``
  (utils/trace.py);
* REFRACTIVE surfaces split the ray: the refraction branch (weight
  1 - Fresnel) goes in the first half of the candidate list, the reflection
  branch (weight Fresnel) in the second half, so under queue overflow the
  transmission branch survives first.  Overflow is counted and returned,
  never silent;
* shading model follows the Chaos RT course the `.crtscene` format comes
  from (see ops/shading.py).

Divergence from a recursive tracer, documented: rays still alive at
``max_depth`` shade their final hit as DIFFUSE (direct lighting) instead of
returning black, which avoids hard black speckles on deep specular chains.
"""

from __future__ import annotations

import torch

from ..models.material import MaterialType
from ..models.scene import DeviceScene
from ..ops.intersect import hit_record, intersect_bruteforce, occluded_bruteforce
from ..ops.rays import RGSS_OFFSETS, generate_rays, generate_rays_tiled, pick_schedule
from ..ops.shading import RAY_BIAS, direct_lighting, hit_attributes, reflect, refract_fresnel
from ..utils import checks, trace
from ..utils.trace import span
from .debug import isect_kwargs, untile

# Continuations whose peak throughput falls below this contribute < 1/256 of
# a pixel value — kill them instead of tracing.
MIN_THROUGHPUT = 1e-3

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


def _shade_chunk(dscene, state, intersect_fn, occluder_fn, last: bool,
                 tile_r=None, n_pix: int | None = None):
    """Intersect + shade one wavefront; returns (contrib, candidates).

    ``n_pix``: the framebuffer's pixel rows, for the debug build's range
    guard on live pixel ids (the primary pass gives it; a bounce pass
    guards its commit instead, see ``_shade_pass_bounce``).

    ``contrib`` is the (N, 3) terminal contribution of each row (zero for
    inactive rows).  Candidates come back as (A, B) dicts of N rows: A =
    the overflow-surviving branch (mirror bounce / refractive transmission),
    B = the droppable Fresnel-reflection branch.  ``None`` when ``last``.
    """
    geo = dscene.geometry
    with span("dxrt.query"):
        hit = intersect_fn(state["origins"], state["dirs"], geo,
                           **isect_kwargs(intersect_fn, tile_r))
    with span("dxrt.hit_record"):
        hit, _, _, _, rec = hit_record(state["origins"], state["dirs"],
                                       geo.packed, hit)
    with span("dxrt.shade"):
        return _shade_hits(dscene, state, hit, rec, occluder_fn, last,
                           n_pix)


def _shade_hits(dscene, state, hit, rec, occluder_fn, last: bool,
                n_pix: int | None):
    """``_shade_chunk``'s shading of the hits ``hit`` (with their records
    ``rec``): the same (contrib, candidates)."""
    geo = dscene.geometry
    active = state["active"]
    hit_mask = active & hit.mask
    miss_mask = active & ~hit.mask

    attrs = hit_attributes(dscene, state["origins"], state["dirs"], hit, rec)
    mtype = attrs["mtype"]
    is_diffuse = mtype == MaterialType.DIFFUSE
    is_constant = mtype == MaterialType.CONSTANT
    is_reflective = mtype == MaterialType.REFLECTIVE
    is_refractive = mtype == MaterialType.REFRACTIVE
    if last:  # depth exhausted: specular shades as diffuse (see module doc)
        is_diffuse = is_diffuse | is_reflective | is_refractive
        is_reflective = torch.zeros_like(is_reflective)
        is_refractive = torch.zeros_like(is_refractive)

    thpt = state["throughput"]
    pixel = state["pixel"]

    # --- terminal contributions --------------------------------------------
    contrib = torch.where(miss_mask[:, None],
                          thpt * dscene.background_color[None, :], 0.0)

    diffuse_mask = hit_mask & is_diffuse
    # Shadow work in Morton order: tiles of spatially tight surface points.
    sort_bounds = (geo.scene_lo, geo.scene_hi)
    if dscene.has_specular:
        light, spec_light = direct_lighting(
            attrs["point"], attrs["normal"], dscene.lights, occluder_fn,
            mask=diffuse_mask, view=state["dirs"],
            shininess=attrs["shininess"], sort_bounds=sort_bounds,
        )
        shaded = (attrs["albedo"] * light
                  + attrs["specular"][:, None] * spec_light)
    else:
        light = direct_lighting(attrs["point"], attrs["normal"],
                                dscene.lights, occluder_fn, mask=diffuse_mask,
                                sort_bounds=sort_bounds)
        shaded = attrs["albedo"] * light
    contrib = contrib + torch.where(diffuse_mask[:, None], thpt * shaded, 0.0)
    contrib = contrib + torch.where(
        (hit_mask & is_constant)[:, None], thpt * attrs["albedo"], 0.0)
    # DXRT_CHECK=1 debug build: the contribution is exactly what becomes
    # user-visible, so a NaN/inf here is a real shading bug (masked lanes
    # are already zeroed); a live ray's pixel id outside the framebuffer
    # would be silently sent to the sink row by the commit.
    checks.check(lambda: torch.isfinite(contrib).all(),
                 "non-finite framebuffer contribution in shade pass")
    if n_pix is not None:
        checks.check(
            lambda: (~active | ((pixel >= 0) & (pixel < n_pix))).all(),
            "wavefront pixel id out of framebuffer range")

    if last:
        return contrib, None

    # --- specular continuations --------------------------------------------
    d = state["dirs"]
    n = attrs["normal"]
    refr_dir, refl_dir_o, fres, tir = refract_fresnel(d, n, attrs["ior"])
    # Offset origins off the surface along the *geometric* normal, on the
    # side the continuation travels.
    ng = attrs["n_geom"]
    side = torch.sign((d * ng).sum(dim=-1, keepdim=True))  # +1 exiting face

    # Branch A (first half — survives overflow): reflective mirror bounce OR
    # refractive transmission.
    mirror_dir = reflect(d, n)
    a_refl = hit_mask & is_reflective
    a_refr = hit_mask & is_refractive & ~tir
    cand_a = {
        "origins": attrs["point"] + torch.where(
            a_refr[:, None], side * ng * RAY_BIAS, -side * ng * RAY_BIAS),
        "dirs": torch.where(a_refr[:, None], refr_dir, mirror_dir),
        "throughput": torch.where(a_refr[:, None], thpt * (1.0 - fres)[:, None],
                                  thpt * attrs["albedo"]),
        "pixel": pixel,
        "active": a_refl | a_refr,
    }

    # Branch B (second half — dropped first on overflow): the refractive
    # surface's Fresnel reflection (weight 1 on total internal reflection).
    b_mask = hit_mask & is_refractive
    cand_b = {
        "origins": attrs["point"] - side * ng * RAY_BIAS,
        "dirs": refl_dir_o,
        "throughput": thpt * fres[:, None],
        "pixel": pixel,
        "active": b_mask,
    }

    for c in (cand_a, cand_b):
        c["active"] = c["active"] & (c["throughput"].amax(dim=-1)
                                     > MIN_THROUGHPUT)
    return contrib, (cand_a, cand_b)


def _compact_candidates(cands, capacity: int, geo):
    """cat(A, B) with B from index len(A) on (``split_at``), compacted."""
    cand_a, cand_b = cands
    cand = {k: torch.cat([cand_a[k], cand_b[k]]) for k in cand_a}
    queue, n_alive, n_drop = _compact_sort(
        cand, capacity, geo.scene_lo, geo.scene_hi,
        split_at=cand_a["origins"].shape[0])
    return queue, n_alive, {"alive": n_alive, "dropped": n_drop}


def _shade_pass(dscene, state, framebuffer, intersect_fn, occluder_fn,
                last: bool, capacity: int, tile_r=None):
    """The primary pass: intersect, shade terminals into the framebuffer
    (rays are in framebuffer order, so a plain add), compact the specular
    continuations into a queue of ``capacity``.  Returns (queue or None,
    n_alive, stats)."""
    contrib, cands = _shade_chunk(dscene, state, intersect_fn, occluder_fn,
                                  last, tile_r=tile_r,
                                  n_pix=framebuffer.shape[0] - 1)
    with span("dxrt.commit"):
        framebuffer[:contrib.shape[0]] += contrib
    if cands is None:
        return None, 0, {"alive": 0, "dropped": 0}
    with span("dxrt.compact"):
        return _compact_candidates(cands, capacity, dscene.geometry)


def _shade_pass_bounce(dscene, state, framebuffer, n_alive: int,
                       intersect_fn, occluder_fn, last: bool):
    """A bounce pass over the live prefix ``state[:n_alive]`` of the
    previous compaction's queue: shade, scatter-add the contributions by
    pixel id (ids outside the frame go to the framebuffer's sink row, its
    last), and compact the continuations into a queue of the same capacity.
    Returns (queue or None, n_alive, stats)."""
    if n_alive == 0:  # an all-parked queue stays one
        return (None if last else state), 0, {"alive": 0, "dropped": 0}
    sub = {k: v[:n_alive] for k, v in state.items()}
    contrib, cands = _shade_chunk(dscene, sub, intersect_fn, occluder_fn,
                                  last)
    with span("dxrt.commit"):
        sink = framebuffer.shape[0] - 1
        ids = sub["pixel"]
        # Debug build: the queue invariant, on the ids as the queue holds
        # them (before they are redirected to the sink): live ids in range,
        # parked ids exactly the sentinel.
        checks.check(
            lambda: ((ids >= 0) & ((ids < sink) | (ids == PIXEL_SENTINEL))).all(),
            "bounce commit pixel id outside framebuffer/sentinel range")
        ids = torch.where((ids >= 0) & (ids < sink), ids, sink)
        framebuffer.index_add_(0, ids.long(), contrib)
    if cands is None:
        return None, 0, {"alive": 0, "dropped": 0}
    with span("dxrt.compact"):
        return _compact_candidates(cands, state["origins"].shape[0],
                                   dscene.geometry)


def render_tile(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    offsets,
    weight: float,
    row_start: int = 0,
    rows: int | None = None,
    max_depth: int = 5,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
    offset_weights=None,
):
    """Render the full-width row band [row_start, row_start + rows) of a
    (height x width) frustum (None: the whole frame), one wavefront per
    sub-pixel offset, accumulated into one framebuffer.  A band may reach
    below the frustum (``row_start + rows > height``): the multi-device
    path pads its stripes and crops.

    Args:
      offsets: sequence of (x, y) sub-pixel offsets.
      weight: per-sample framebuffer weight, normally 1 / total spp (the
        total across all shards, not just this call's offsets).
      offset_weights: optional per-offset multipliers on ``weight``.  The
        multi-device path pads the sample axis with them: a padding offset
        carries weight 0 and contributes nothing.

    Returns (rows, W, 3) image + stats {alive, dropped} per pass (int32 CPU
    tensors, ``len(offsets) * passes`` entries).
    """
    geo = dscene.geometry
    dev = geo.woop.device
    isect = intersect_fn or _default_intersect
    occluder = (occluder_factory or _default_occluder)(geo)
    if queue_factor is None:
        # Without refractive materials rays never split: a bounce wavefront
        # can't outgrow the previous one, so capacity n_pix suffices.
        queue_factor = 2 if dscene.has_refractive else 1

    rows = height if rows is None else rows
    n_pix = width * rows
    if n_pix >= PIXEL_SENTINEL:
        raise ValueError(f"{n_pix} pixels: ids must stay below {PIXEL_SENTINEL}")
    # The primary wavefront is generated in tile-major order and the
    # framebuffer lives in the same order; the primary pass's ray chunk
    # matches the pixel tile, bounce batches take the intersector's default.
    tile, tile_r = pick_schedule(rows, width)
    capacity = queue_capacity(n_pix, queue_factor)
    if offset_weights is None:
        offset_weights = [1.0] * len(offsets)

    # n_pix rows + one sink row for ids the scatter must drop.
    framebuffer = torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=dev)
    stats = []
    for offset, offset_weight in zip(offsets, offset_weights):
        with span("dxrt.raygen"):
            if tile is None:
                origins, dirs = generate_rays(cam_position, cam_rotation,
                                              width, height, offset,
                                              row_start, rows, device=dev)
            else:
                origins, dirs = generate_rays_tiled(
                    cam_position, cam_rotation, width, height, tile[0],
                    tile[1], offset, row_start, rows, device=dev)
            state = {
                "origins": origins,
                "dirs": dirs,
                "throughput": torch.full((n_pix, 3), weight,
                                         dtype=torch.float32, device=dev)
                * float(offset_weight),
                "pixel": torch.arange(n_pix, dtype=torch.int32, device=dev),
                "active": torch.ones((n_pix,), dtype=torch.bool, device=dev),
            }
        alive = n_pix
        for depth in range(max_depth):
            last = depth == max_depth - 1
            with span("dxrt.pass"):
                if depth == 0:
                    state, alive, s = _shade_pass(
                        dscene, state, framebuffer, isect, occluder, last,
                        capacity, tile_r=tile_r)
                else:
                    state, alive, s = _shade_pass_bounce(
                        dscene, state, framebuffer, alive, isect, occluder,
                        last)
            stats.append(s)
            if state is None:
                break

    with span("dxrt.commit"):
        image = untile(framebuffer[:n_pix], width, rows, tile)
    return image, {
        "alive": torch.tensor([s["alive"] for s in stats], dtype=torch.int32),
        "dropped": torch.tensor([s["dropped"] for s in stats],
                                dtype=torch.int32),
    }


def spp_offsets(spp: int):
    """Subpixel offsets for an arbitrary spp count.

    1 = the reference's pixel center (hlsl:35-36), 4 = rotated-grid AA, any
    other N = a deterministic Hammersley set (stratified (i+0.5)/N x
    van-der-Corput base 2) — no RNG, so Whitted AA stays reproducible.
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if spp == 1:
        return ((0.5, 0.5),)
    if spp == 4:
        return RGSS_OFFSETS

    def _vdc(i: int) -> float:  # van der Corput radical inverse, base 2
        v, f = 0.0, 0.5
        while i:
            if i & 1:
                v += f
            f *= 0.5
            i >>= 1
        return v

    half = 0.5 / spp
    return tuple(((i + 0.5) / spp, _vdc(i) + half) for i in range(spp))


def render_whitted(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
):
    """Render one Whitted frame on the scene tensors' device.

    Args:
      dscene: device scene tensors.
      cam_position, cam_rotation: camera snapshot ((3,), (3,3)).
      spp: samples per pixel (see ``spp_offsets``).
      intersect_fn: ``(origins, dirs, geometry, tile_r=None) -> Hit``
        (e.g. the BVH intersector); defaults to brute force.
      occluder_factory: ``geometry -> (origins, dirs, max_t) -> bool``
        (e.g. the BVH occluder); defaults to brute force.
      queue_factor: bounce-queue capacity as a multiple of H*W; None picks
        2 for scenes with refractive materials (keeps both branches of a
        full-screen refractive surface alive) and 1 otherwise.  Deeper
        splits can still overflow — the transmission branch survives first
        and overflow is reported in stats.

    Returns:
      image (H, W, 3) f32 linear, stats dict {alive, dropped per pass}.
    """
    offs = spp_offsets(spp)
    return render_tile(
        dscene, cam_position, cam_rotation, width, height, offsets=offs,
        weight=1.0 / len(offs), row_start=0, rows=height, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory,
        queue_factor=queue_factor,
    )


def render_whitted_checked(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor=None,
):
    """``render_whitted`` with the debug build's guards armed (see
    utils.checks): raises ``checks.CheckError`` on a non-finite framebuffer
    contribution or an out-of-range wavefront pixel id; same return value
    otherwise.  Each guard costs one host sync."""
    with checks.armed():
        return render_whitted(
            dscene, cam_position, cam_rotation, width, height,
            max_depth=max_depth, spp=spp, intersect_fn=intersect_fn,
            occluder_factory=occluder_factory, queue_factor=queue_factor)
