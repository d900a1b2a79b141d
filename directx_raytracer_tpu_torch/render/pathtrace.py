"""Progressive wavefront path tracer.

Counterpart of ``directx_raytracer_tpu/render/pathtrace.py``
(``MIN_THROUGHPUT``, ``RR_START``, ``_onb``, ``_cosine_sample``,
``_pt_shade_chunk``, ``_pt_pass``, ``_pt_pass_bounce``, ``pathtrace_tile``,
``pathtrace_sample``, ``PathTracer``), as plain functions on the scene
tensors' device.

Monte Carlo extension of the Whitted wavefront (render/whitted.py): the same
fixed-capacity compacted ray queue, but stochastic transport instead of
deterministic splitting:

* DIFFUSE: next-event estimation against ALL point lights through the
  Morton-sorted shadow batch of ``ops.shading.direct_lighting`` (the same
  ``intensity / (4 pi r^2) * cos`` model as the Whitted path, so a depth-1
  sample matches the Whitted direct term) + a cosine-weighted hemisphere
  continuation (throughput *= albedo: the cosine and the pdf cancel);
* REFLECTIVE: deterministic mirror, throughput *= albedo;
* REFRACTIVE: one stochastic branch chosen with the Fresnel probability
  (throughput unchanged: the probability cancels the weight; albedo is
  white by the parser's rule);
* CONSTANT: emissive-style flat terminal (albedo added, no lights);
* misses add throughput * background (the environment term);
* Russian roulette from bounce ``RR_START`` keeps the expected value while
  draining the queue.

Where the JAX package walks fixed-size chunks under ``while_loop`` and stages
contributions in a slot queue (static shapes), a bounce pass here shades the
live prefix of its queue in one go and commits with one ``index_add_``, as
the Whitted bounce does.

Random numbers: every draw comes from an explicit ``torch.Generator``, never
the global one.  ``_pt_shade_chunk`` takes the four per-row uniform streams
it consumes as an argument (``_draw`` makes them), and ``pathtrace_tile``
the sub-pixel jitter, so a test can hand both packages the same numbers.
``PathTracer`` owns a CPU generator seeded with ``seed``; each sample draws
one 63-bit integer from it and seeds a generator on the render device with
it.  The checkpoint (``save_state``/``load_state``, ``.npz``) holds the
accumulated radiance, the sample count and that CPU generator's state, so a
checkpoint written on one device loads on another, and on one device
resuming equals never having stopped.

A sample is a ``dxrt.frame.pathtrace`` span and each bounce a ``dxrt.pass``,
with the Whitted passes' spans inside (utils/trace.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.material import MaterialType
from ..models.scene import DeviceScene
from ..ops.intersect import hit_record
from ..ops.rays import generate_rays, generate_rays_tiled, pick_schedule
from ..ops.shading import RAY_BIAS, direct_lighting, hit_attributes, reflect, refract_fresnel
from ..utils import checks
from ..utils.trace import span
from .debug import isect_kwargs, untile
from .whitted import (PIXEL_SENTINEL, _compact_sort, _default_intersect,
                      _default_occluder, queue_capacity)

MIN_THROUGHPUT = 5e-3
RR_START = 3  # first bounce applying Russian roulette


def _onb(n):
    """Orthonormal basis around unit normal n (Duff et al. branchless)."""
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=1)
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=1)
    return t, bt


def _cosine_sample(u1, u2, n):
    """Cosine-weighted hemisphere directions about normals n (N, 3) from
    the uniforms u1, u2 (N,)."""
    r = torch.sqrt(u1)
    phi = 2.0 * np.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt((1.0 - u1).clamp(min=0.0))
    t, bt = _onb(n)
    return x[:, None] * t + y[:, None] * bt + z[:, None] * n


def _draw(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """The four uniform streams one pass over ``n`` rows consumes, (4, n)
    f32 in [0, 1): u1 and u2 of the cosine sample, the Fresnel branch pick
    and the roulette draw."""
    return torch.rand((4, n), generator=generator, device=device)


def _pt_shade_chunk(dscene, state, uniforms, depth, intersect_fn, occluder_fn,
                    tile_r=None, n_pix: int | None = None):
    """Intersect + shade one wavefront stochastically; returns (contrib,
    candidates): the (N, 3) terminal contribution of each row (zero for
    inactive rows) and the N candidate continuations, one per row.

    ``uniforms``: the four (N,) streams of ``_draw``.  Lanes are selected,
    never multiplied by a mask: a miss lane's attributes are arbitrary and
    may be non-finite.  ``n_pix``: the accumulator's pixel rows, for the
    debug build's range guard on live pixel ids (the primary pass gives it;
    a bounce pass guards its commit instead)."""
    geo = dscene.geometry
    with span("dxrt.query"):
        hit = intersect_fn(state["origins"], state["dirs"], geo,
                           **isect_kwargs(intersect_fn, tile_r))
    with span("dxrt.hit_record"):
        hit, _, _, _, rec = hit_record(state["origins"], state["dirs"],
                                       geo.packed, hit)
    with span("dxrt.shade"):
        return _pt_shade_hits(dscene, state, uniforms, depth, hit, rec,
                              occluder_fn, n_pix)


def _pt_shade_hits(dscene, state, uniforms, depth, hit, rec, occluder_fn,
                   n_pix: int | None):
    """``_pt_shade_chunk``'s shading of the hits ``hit`` (with their
    records ``rec``): the same (contrib, candidates)."""
    geo = dscene.geometry
    active = state["active"]
    hit_mask = active & hit.mask
    miss_mask = active & ~hit.mask
    attrs = hit_attributes(dscene, state["origins"], state["dirs"], hit, rec)
    mtype = attrs["mtype"]
    thpt = state["throughput"]
    pixel = state["pixel"]
    u1, u2, u_branch, u_rr = uniforms

    is_diffuse = hit_mask & (mtype == MaterialType.DIFFUSE)
    is_constant = hit_mask & (mtype == MaterialType.CONSTANT)
    is_mirror = hit_mask & (mtype == MaterialType.REFLECTIVE)
    is_glass = hit_mask & (mtype == MaterialType.REFRACTIVE)

    # Terminal / direct contributions.  Next-event estimation sums ALL
    # lights through the Morton-sorted shadow batch: picking one light per
    # ray leaves shadow tiles that mix lights and bin many more clusters.
    contrib = torch.where(miss_mask[:, None],
                          thpt * dscene.background_color[None, :], 0.0)
    direct = direct_lighting(
        attrs["point"], attrs["normal"], dscene.lights, occluder_fn,
        mask=is_diffuse, sort_bounds=(geo.scene_lo, geo.scene_hi))
    contrib = contrib + torch.where(is_diffuse[:, None],
                                    thpt * attrs["albedo"] * direct, 0.0)
    contrib = contrib + torch.where(is_constant[:, None],
                                    thpt * attrs["albedo"], 0.0)
    # DXRT_CHECK=1 debug build (see utils.checks): guard what reaches the
    # accumulator; masked lanes are already zeroed so this flags real bugs.
    checks.check(lambda: torch.isfinite(contrib).all(),
                 "non-finite radiance contribution in PT bounce")
    if n_pix is not None:
        checks.check(
            lambda: (~active | ((pixel >= 0) & (pixel < n_pix))).all(),
            "PT wavefront pixel id out of framebuffer range")

    # Continuations (single stochastic branch per ray).
    n = attrs["normal"]
    d = state["dirs"]
    ng = attrs["n_geom"]
    side = torch.sign((d * ng).sum(dim=-1, keepdim=True))

    diff_dir = _cosine_sample(u1, u2, n)
    mirror_dir = reflect(d, n)
    refr_dir, refl_dir, fres, tir = refract_fresnel(d, n, attrs["ior"])
    pick_refl = u_branch < fres
    glass_dir = torch.where(pick_refl[:, None], refl_dir, refr_dir)
    glass_out = torch.where(pick_refl[:, None], -side, side)

    new_dir = torch.where(is_diffuse[:, None], diff_dir, d)
    new_dir = torch.where(is_mirror[:, None], mirror_dir, new_dir)
    new_dir = torch.where(is_glass[:, None], glass_dir, new_dir)
    # Glass offsets to the transmission/reflection side of the geometric
    # normal; diffuse/mirror continue off the shading normal.
    offset = torch.where(is_glass[:, None], glass_out * ng * RAY_BIAS,
                         n * RAY_BIAS)

    new_thpt = torch.where((is_diffuse | is_mirror)[:, None],
                           thpt * attrs["albedo"], thpt)

    cont = is_diffuse | is_mirror | is_glass
    # Russian roulette: unbiased queue draining.
    if depth >= RR_START:
        p = new_thpt.amax(dim=-1).clamp(0.05, 1.0)
        cont = cont & (u_rr < p)
        new_thpt = new_thpt / p[:, None]
    cont = cont & (new_thpt.amax(dim=-1) > MIN_THROUGHPUT)

    cand = {
        "origins": attrs["point"] + offset,
        "dirs": new_dir,
        "throughput": new_thpt,
        "pixel": pixel,
        "active": cont,
    }
    return contrib, cand


def _pt_pass(dscene, state, framebuffer, uniforms, depth, intersect_fn,
             occluder_fn, capacity, tile_r=None, last: bool = False):
    """The primary pass (rays in framebuffer order, so a plain add), then
    the continuations compacted into a queue of ``capacity`` rows (see
    whitted._compact_sort).  Returns (queue or None, n_alive)."""
    geo = dscene.geometry
    contrib, cand = _pt_shade_chunk(dscene, state, uniforms, depth,
                                    intersect_fn, occluder_fn, tile_r=tile_r,
                                    n_pix=framebuffer.shape[0] - 1)
    with span("dxrt.commit"):
        framebuffer[:contrib.shape[0]] += contrib
    if last:  # the continuations are never consumed: skip the compaction
        return None, 0
    with span("dxrt.compact"):
        queue, n_alive, _ = _compact_sort(cand, capacity, geo.scene_lo,
                                          geo.scene_hi)
    return queue, n_alive


def _pt_pass_bounce(dscene, state, framebuffer, generator, depth, intersect_fn,
                    occluder_fn, n_alive: int, last: bool = False):
    """A bounce pass over the live prefix ``state[:n_alive]`` of the
    previous compaction's queue: shade, scatter-add the contributions by
    pixel id (ids outside the frame go to the framebuffer's sink row, its
    last), and compact the continuations into a queue of the same capacity.
    Per-bounce cost follows the surviving wavefront, not the queue.  Returns
    (queue or None, n_alive)."""
    if n_alive == 0:  # an all-parked queue stays one
        return (None if last else state), 0
    geo = dscene.geometry
    sub = {k: v[:n_alive] for k, v in state.items()}
    uniforms = _draw(generator, n_alive, geo.woop.device)
    contrib, cand = _pt_shade_chunk(dscene, sub, uniforms, depth,
                                    intersect_fn, occluder_fn)
    with span("dxrt.commit"):
        sink = framebuffer.shape[0] - 1
        ids = sub["pixel"]
        # Debug build: the queue invariant, on the ids as the queue holds
        # them (before they are redirected to the sink): a live slot's id
        # is in range, a parked slot's is exactly the sentinel.
        checks.check(
            lambda: ((ids >= 0) & ((ids < sink) | (ids == PIXEL_SENTINEL))).all(),
            "PT bounce commit pixel id outside framebuffer/sentinel range")
        ids = torch.where((ids >= 0) & (ids < sink), ids, sink)
        framebuffer.index_add_(0, ids.long(), contrib)
    if last:
        return None, 0
    with span("dxrt.compact"):
        queue, n_alive2, _ = _compact_sort(cand, state["origins"].shape[0],
                                           geo.scene_lo, geo.scene_hi)
    return queue, n_alive2


def pathtrace_tile(dscene: DeviceScene, cam_position, cam_rotation,
                   generator: torch.Generator, width: int, height: int,
                   row_start=0, rows: int | None = None, max_depth: int = 6,
                   intersect_fn=None, occluder_factory=None, off=None):
    """One sample of the full-width row band [row_start, row_start+rows):
    (rows*W, 3) tile-major linear radiance.

    ``generator`` lives on the scene's device and feeds every draw;
    ``off`` is the sample's sub-pixel jitter (2,), drawn from the generator
    when None."""
    geo = dscene.geometry
    dev = geo.woop.device
    isect = intersect_fn or _default_intersect
    occluder = (occluder_factory or _default_occluder)(geo)
    rows = height if rows is None else rows
    n_pix = width * rows
    # The queue carries pixel ids as f32 values below the sentinel.
    if n_pix >= PIXEL_SENTINEL:
        raise ValueError(f"{n_pix} pixels: ids must stay below {PIXEL_SENTINEL}")
    tile, tile_r = pick_schedule(rows, width)

    with span("dxrt.raygen"):
        if off is None:
            off = torch.rand((2,), generator=generator, device=dev)
        if tile is None:
            origins, dirs = generate_rays(cam_position, cam_rotation, width,
                                          height, off, row_start, rows,
                                          device=dev)
        else:
            origins, dirs = generate_rays_tiled(
                cam_position, cam_rotation, width, height, tile[0], tile[1],
                off, row_start, rows, device=dev)

        state = {
            "origins": origins,
            "dirs": dirs,
            "throughput": torch.ones((n_pix, 3), dtype=torch.float32,
                                     device=dev),
            "pixel": torch.arange(n_pix, dtype=torch.int32, device=dev),
            "active": torch.ones((n_pix,), dtype=torch.bool, device=dev),
        }
    # n_pix rows + one sink row for ids the scatter must drop.
    framebuffer = torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=dev)
    # PT rays never split, so a queue of n_pix rows (in whole chunks, the
    # JAX package's sizing) cannot overflow.
    capacity = queue_capacity(n_pix, 1)
    alive = n_pix
    for depth in range(max_depth):
        last = depth == max_depth - 1
        with span("dxrt.pass"):
            if depth == 0:
                state, alive = _pt_pass(
                    dscene, state, framebuffer, _draw(generator, n_pix, dev),
                    depth, isect, occluder, capacity, tile_r=tile_r,
                    last=last)
            else:
                state, alive = _pt_pass_bounce(
                    dscene, state, framebuffer, generator, depth, isect,
                    occluder, alive, last=last)
        if state is None:
            break
    return framebuffer[:n_pix]


def pathtrace_sample(dscene: DeviceScene, cam_position, cam_rotation,
                     generator: torch.Generator, width: int, height: int,
                     max_depth: int = 6, intersect_fn=None,
                     occluder_factory=None):
    """One full-image sample: (H*W, 3) tile-major linear radiance."""
    return pathtrace_tile(
        dscene, cam_position, cam_rotation, generator, width, height,
        row_start=0, rows=height, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory)


class PathTracer:
    """Progressive accumulator with checkpoint/resume."""

    def __init__(self, dscene, width: int, height: int, max_depth: int = 6,
                 intersect_fn=None, occluder_factory=None, seed: int = 0):
        self.dscene = dscene
        self.width = width
        self.height = height
        self.max_depth = max_depth
        self.intersect_fn = intersect_fn
        self.occluder_factory = occluder_factory
        self.device = dscene.geometry.woop.device
        self.accum = torch.zeros((width * height, 3), dtype=torch.float32,
                                 device=self.device)
        self.n_samples = 0
        self.key = torch.Generator().manual_seed(seed)  # CPU: see module doc

    def step(self, cam_position, cam_rotation, n: int = 1):
        """Accumulate ``n`` samples.  With DXRT_CHECK=1 every pass runs its
        guards (utils.checks) and a failing one raises ``CheckError``."""
        for _ in range(n):
            with span("dxrt.frame.pathtrace"):
                # The seed is read from a CPU generator: no host sync.
                seed = int(torch.randint(0, 2**63 - 1, (1,),
                                         generator=self.key,
                                         dtype=torch.int64))
                gen = torch.Generator(device=self.device).manual_seed(seed)
                sample = pathtrace_sample(
                    self.dscene, cam_position, cam_rotation, gen, self.width,
                    self.height, self.max_depth, self.intersect_fn,
                    self.occluder_factory)
                with span("dxrt.commit"):
                    self.accum += sample
                self.n_samples += 1
        return self

    def image(self):
        """(H, W, 3) mean radiance in raster order."""
        tile, _ = pick_schedule(self.height, self.width)
        mean = self.accum / max(self.n_samples, 1)
        return untile(mean, self.width, self.height, tile)

    def reset(self):
        self.accum.zero_()
        self.n_samples = 0

    # -- checkpoint / resume ------------------------------------------------
    def save_state(self, path: str) -> None:
        np.savez(path, accum=self.accum.cpu().numpy(), n_samples=self.n_samples,
                 key=self.key.get_state().numpy(), width=self.width,
                 height=self.height)

    def load_state(self, path: str) -> None:
        with np.load(path) as z:
            if int(z["width"]) != self.width or int(z["height"]) != self.height:
                raise ValueError("checkpoint resolution mismatch")
            self.accum = torch.from_numpy(z["accum"]).to(self.device)
            self.n_samples = int(z["n_samples"])
            self.key.set_state(torch.from_numpy(z["key"]))
