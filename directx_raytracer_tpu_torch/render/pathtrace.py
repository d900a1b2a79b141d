"""Progressive wavefront path tracer.

Counterpart of ``directx_raytracer_tpu/render/pathtrace.py``
(``MIN_THROUGHPUT``, ``RR_START``, ``_onb``, ``_cosine_sample``,
``_pt_shade_chunk``'s shading, ``pathtrace_tile``, ``pathtrace_sample``,
``PathTracer``), as plain functions on the scene tensors' device; its queue
and passes are ``render/wavefront.py``'s.

Monte Carlo extension of the Whitted wavefront: the same passes over the
same fixed-capacity compacted ray queue, but stochastic transport instead
of deterministic splitting:

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
live prefix of its queue in one go and commits with one ``index_add_``.

Random numbers: keyed draws (``ops/draws.py``).  Every uniform a pass
consumes is a pure function of (sample key, the pixel's raster index
``py * W + px`` in the full frame, bounce, stream): Philox4x32-10 of the
counter (raster id, bounce, 0, 0) under the sample key, one output word a
stream, mapped to f32 as ``(x >> 8) * 2^-24``.  The sample's sub-pixel
jitter is the same function of the sample key alone.  So a pixel's draws
do not depend on where the Morton sort put it in the queue, on the pixel
tiling or on the row band a process renders, and a plain reference can
follow one path a pixel, drawing the same numbers.  A pass's draws are one
launch of ``csrc/pt_draws.cu`` on the card (its pure-torch twin on the
CPU), a ``dxrt.shade.draw`` span inside the pass's shading step
(``_pt_shade``).  ``_pt_shade_hits`` takes the four (N,) streams as an
argument, so a test can hand both packages the same numbers; the JAX
package draws with ``jax.random`` over its queue, so the two packages'
samples agree only in distribution.

``PathTracer(seed)``: sample k after construction or ``reset()`` has the
key ``sample_key(seed, k)``, an integer function (no generator).  The
checkpoint (``save_state``/``load_state``, ``.npz``) holds the accumulated
radiance, the sample count and the seed, so a checkpoint written on one
device loads on another, and resuming equals never having stopped.

Each pass's shading step counts the rows that entered the pass under
``pt.rays`` (utils/trace.py): the pixel count, then the live count the
compaction has already read, so the counter adds no host sync.

A sample is a ``dxrt.frame.pathtrace`` span and each bounce a ``dxrt.pass``
(utils/trace.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.material import MaterialType
from ..models.scene import DeviceScene
from ..ops.draws import Layout, jitter, pt_draws, sample_key
from ..ops.rays import pick_schedule
from ..ops.shading import RAY_BIAS, direct_lighting, hit_attributes, reflect, refract_fresnel
from ..utils import trace
from ..utils.trace import span
from .debug import untile
from .wavefront import (_default_intersect, _default_occluder, new_framebuffer,
                        primary_wavefront, queue_capacity, run_passes)

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


def _draw(key: int, layout: Layout, ids, depth: int) -> torch.Tensor:
    """The four uniform streams one pass consumes for the rows whose pixel
    ids are ``ids``, (4, n) f32 in [0, 1): u1 and u2 of the cosine sample,
    the Fresnel branch pick and the roulette draw (ops/draws.py)."""
    with span("dxrt.shade.draw"):
        return pt_draws(ids, key, depth, layout)


def _pt_shade(dscene, occluder_fn, key: int, layout: Layout, state, hit,
              rec, depth: int, last: bool):
    """The path tracer's shading step of a pass (``render/wavefront.py``):
    counts the rows that entered the pass under ``pt.rays``, draws their
    streams keyed by ``key`` and their pixels (``layout``), and shades them
    (``_pt_shade_hits``).  The continuations of the last pass are made and
    never consumed."""
    trace.count("pt.rays", state["pixel"].shape[0])
    uniforms = _draw(key, layout, state["pixel"], depth)
    return _pt_shade_hits(dscene, occluder_fn, state, hit, rec, uniforms,
                          depth)


def _pt_shade_hits(dscene, occluder_fn, state, hit, rec, uniforms, depth):
    """Shade the hits ``hit`` (with their records ``rec``) stochastically:
    the (N, 3) terminal contribution of each row (zero for inactive rows)
    and its one candidate continuation, as a one-branch tuple.

    ``uniforms``: the four (N,) streams of ``_draw``.  Lanes are selected,
    never multiplied by a mask: a miss lane's attributes are arbitrary and
    may be non-finite."""
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
    return contrib, (cand,)


def pathtrace_tile(dscene: DeviceScene, cam_position, cam_rotation,
                   key: int, width: int, height: int,
                   row_start=0, rows: int | None = None, max_depth: int = 6,
                   intersect_fn=None, occluder_factory=None, off=None):
    """One sample of the full-width row band [row_start, row_start+rows):
    (rows*W, 3) tile-major linear radiance.

    ``key``: the sample key (an integer, see ``ops/draws.py``) that feeds
    every draw, keyed by each pixel's raster index in the full frame, so a
    band draws what the whole frame draws for its pixels; ``off`` is the
    sample's sub-pixel jitter (2,), the key's own when None."""
    geo = dscene.geometry
    dev = geo.woop.device
    isect = intersect_fn or _default_intersect
    occluder = (occluder_factory or _default_occluder)(geo)
    rows = height if rows is None else rows
    n_pix = width * rows
    framebuffer = new_framebuffer(n_pix, dev)
    tile, tile_r = pick_schedule(rows, width)
    with span("dxrt.raygen"):
        state = primary_wavefront(
            cam_position, cam_rotation, width, height,
            jitter(key, dev) if off is None else off, row_start, rows, tile,
            torch.ones((n_pix, 3), dtype=torch.float32, device=dev))
    # PT rays never split, so a queue of n_pix rows (in whole chunks, the
    # JAX package's sizing) cannot overflow.
    shade = functools.partial(_pt_shade, dscene, occluder, key,
                              Layout.of(tile, width, row_start))
    run_passes(dscene, state, framebuffer, shade, isect, tile_r, max_depth,
               queue_capacity(n_pix, 1))
    return framebuffer[:n_pix]


def pathtrace_sample(dscene: DeviceScene, cam_position, cam_rotation,
                     key: int, width: int, height: int,
                     max_depth: int = 6, intersect_fn=None,
                     occluder_factory=None):
    """One full-image sample keyed by ``key``: (H*W, 3) tile-major linear
    radiance."""
    return pathtrace_tile(
        dscene, cam_position, cam_rotation, key, width, height,
        row_start=0, rows=height, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory)


class PathTracer:
    """Progressive accumulator with checkpoint/resume.  Sample k after
    construction or ``reset()`` is keyed by ``sample_key(seed, k)``."""

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
        self.seed = int(seed)

    def step(self, cam_position, cam_rotation, n: int = 1):
        """Accumulate ``n`` samples.  With DXRT_CHECK=1 every pass runs its
        guards (utils.checks) and a failing one raises ``CheckError``."""
        for _ in range(n):
            with span("dxrt.frame.pathtrace"):
                sample = pathtrace_sample(
                    self.dscene, cam_position, cam_rotation,
                    sample_key(self.seed, self.n_samples), self.width,
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
        """Drop the accumulation; the next sample is keyed as sample 0."""
        self.accum.zero_()
        self.n_samples = 0

    # -- checkpoint / resume ------------------------------------------------
    def save_state(self, path: str) -> None:
        np.savez(path, accum=self.accum.cpu().numpy(), n_samples=self.n_samples,
                 seed=np.uint64(self.seed & (2**64 - 1)), width=self.width,
                 height=self.height)

    def load_state(self, path: str) -> None:
        """Resume a checkpoint: its radiance, sample count and seed."""
        with np.load(path) as z:
            if int(z["width"]) != self.width or int(z["height"]) != self.height:
                raise ValueError("checkpoint resolution mismatch")
            self.accum = torch.from_numpy(z["accum"]).to(self.device)
            self.n_samples = int(z["n_samples"])
            self.seed = int(z["seed"])
