"""Wavefront Whitted renderer — the feature set the reference *declares*
but never executes.

Counterpart of ``directx_raytracer_tpu/render/whitted.py``
(``MIN_THROUGHPUT``, ``_shade_chunk``'s shading, ``render_tile``, ``spp_offsets``,
``render_whitted``, ``render_whitted_checked``), as plain functions on the
scene tensors' device; its queue and passes are ``render/wavefront.py``'s.

The reference parses materials, point lights and textures
(CRTSceneParser.cpp:152-405) yet uploads none of it to the GPU, caps
``MaxTraceRecursionDepth`` at 1 (DXRTRenderer.cpp:1169-1179) and never calls
``TraceRay`` from its closest-hit shader — so shadows/reflection/refraction
exist only as capability surface (SURVEY.md facts 1-2).  Here that surface is
made real as a wavefront rather than a recursive per-pixel shader:

* a ray wavefront is a queue of rows, and each pass shades the live rows
  of its queue into the framebuffer and compacts the surviving specular
  continuations into the next queue (``render/wavefront.py``);
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

import functools

import torch

from ..models.material import MaterialType
from ..models.scene import DeviceScene
from ..ops.rays import RGSS_OFFSETS, pick_schedule
from ..ops.shading import RAY_BIAS, direct_lighting, hit_attributes, reflect, refract_fresnel
from ..utils import checks, trace
from ..utils.trace import span
from .debug import untile
from .wavefront import (_default_intersect, _default_occluder, new_framebuffer,
                        primary_wavefront, queue_capacity, run_passes)

# Continuations whose peak throughput falls below this contribute < 1/256 of
# a pixel value — kill them instead of tracing.
MIN_THROUGHPUT = 1e-3


def _shade_hits(dscene, occluder_fn, state, hit, rec, depth: int, last: bool):
    """The Whitted shading step of a pass (``render/wavefront.py``): the
    rows' terminal contributions (misses, direct lighting of diffuse hits
    through ``occluder_fn``, constant hits) and, unless ``last``, their
    specular continuations as two branches: A (mirror bounce or refractive
    transmission), which survives overflow, and B (the refractive surface's
    Fresnel reflection), which an overflowing queue drops first.  Counts
    the rows that entered the pass under ``whitted.rays``; the
    continuations are made in a ``dxrt.shade.split`` span."""
    trace.count("whitted.rays", state["pixel"].shape[0])
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
    if last:
        return contrib, None

    # --- specular continuations --------------------------------------------
    with span("dxrt.shade.split"):
        d = state["dirs"]
        n = attrs["normal"]
        refr_dir, refl_dir_o, fres, tir = refract_fresnel(d, n, attrs["ior"])
        # Offset origins off the surface along the *geometric* normal, on
        # the side the continuation travels.
        ng = attrs["n_geom"]
        # +1 on an exiting face
        side = torch.sign((d * ng).sum(dim=-1, keepdim=True))

        # Branch A (first half — survives overflow): reflective mirror
        # bounce OR refractive transmission.
        mirror_dir = reflect(d, n)
        a_refl = hit_mask & is_reflective
        a_refr = hit_mask & is_refractive & ~tir
        cand_a = {
            "origins": attrs["point"] + torch.where(
                a_refr[:, None], side * ng * RAY_BIAS, -side * ng * RAY_BIAS),
            "dirs": torch.where(a_refr[:, None], refr_dir, mirror_dir),
            "throughput": torch.where(a_refr[:, None],
                                      thpt * (1.0 - fres)[:, None],
                                      thpt * attrs["albedo"]),
            "pixel": pixel,
            "active": a_refl | a_refr,
        }

        # Branch B (second half — dropped first on overflow): the
        # refractive surface's Fresnel reflection (weight 1 on total
        # internal reflection).
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
    (height x width) frustum (None: the whole frame), the sub-pixel
    offsets' rays in one wavefront (``render/wavefront.py``: each sample
    keeps a queue of its own), accumulated into one framebuffer.  A band may reach
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
    framebuffer = new_framebuffer(n_pix, dev)
    # The primary wavefront is generated in tile-major order and the
    # framebuffer lives in the same order; the primary pass's ray chunk
    # matches the pixel tile, bounce batches take the intersector's default.
    tile, tile_r = pick_schedule(rows, width)
    capacity = queue_capacity(n_pix, queue_factor)
    if offset_weights is None:
        offset_weights = [1.0] * len(offsets)

    shade = functools.partial(_shade_hits, dscene, occluder)
    n_samples = len(offsets)
    with span("dxrt.raygen"):
        samples = []
        for offset, offset_weight in zip(offsets, offset_weights):
            throughput = torch.full((n_pix, 3), weight, dtype=torch.float32,
                                    device=dev) * float(offset_weight)
            samples.append(primary_wavefront(
                cam_position, cam_rotation, width, height, offset, row_start,
                rows, tile, throughput))
        state = samples[0]
        if n_samples > 1:  # one wavefront of every sample's rows
            state = {k: torch.cat([s[k] for s in samples]) for k in state}
            state["sample"] = torch.arange(
                n_samples, dtype=torch.int32, device=dev).repeat_interleave(n_pix)
    passes = run_passes(dscene, state, framebuffer, shade, isect, tile_r,
                        max_depth, capacity, n_samples)
    if n_samples == 1:
        stats = passes
    else:  # sample-major, as one wavefront a sample would count them
        stats = [(alive[s], dropped[s]) for s in range(n_samples)
                 for alive, dropped in passes]

    with span("dxrt.commit"):
        image = untile(framebuffer[:n_pix], width, rows, tile)
    return image, {
        "alive": torch.tensor([a for a, _ in stats], dtype=torch.int32),
        "dropped": torch.tensor([d for _, d in stats], dtype=torch.int32),
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
