"""Multi-device rendering: ray/tile + sample sharding over a (tiles,
samples) grid of processes.

Counterpart of ``directx_raytracer_tpu/parallel/sharding.py``
(``make_mesh``, ``render_whitted_multichip``, ``pathtrace_multichip``,
``untile_multichip``).

The reference is single-GPU — its only "parallelism" is the hardware's
per-pixel thread fan-out (``DispatchRays`` 1920x1080, DXRTRenderer.cpp:1348).
Rays are mutually independent, so scaling (SURVEY.md §2e) is pure data
parallelism with two meaningful axes:

* ``tiles`` — the pixel-row axis: each device renders a horizontal stripe
  of the frame.  Scene buffers are replicated (a 100k-tri scene is ~20 MB),
  framebuffer stripes stay device-local, and one all-gather over the tiles
  group reassembles the frame.
* ``samples`` — the subpixel/AA axis: devices render the *same* stripe with
  different sample offsets and all-reduce (sum) their framebuffers — the
  progressive-accumulation pattern, and the only cross-device reduction a
  ray tracer needs.

Both axes compose in one 2-D grid: the process at (t, s) renders stripe t
with sample subset s.  Where the JAX package is one program over a device
mesh (``shard_map``), ``torch.distributed`` is one process per device, so
the port is in two layers:

* the shard functions ``whitted_shard`` and ``pathtrace_shard`` compute
  what the process at (t, s) computes, with no communication: one process
  can call them for every (t, s) and sum the results itself;
* the collective entry points ``render_whitted_multichip`` and
  ``pathtrace_multichip``, which every process of the group calls with the
  same arguments: its own shard, a sum over its samples group, a gather
  over its tiles group.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models.scene import DeviceScene
from ..ops.rays import pick_schedule
from ..render.debug import untile
from ..render.whitted import render_tile, spp_offsets


@dataclass(frozen=True)
class Mesh:
    """A (tiles, samples) grid of processes and this process's place in it.
    Rank r sits at (r // n_samples, r % n_samples)."""

    shape: dict  # {"tiles": n_tiles, "samples": n_samples}
    coords: tuple  # this process's (t, s)
    tiles_group: object = None  # the ranks sharing this s (None: one process)
    samples_group: object = None  # the ranks sharing this t

    axis_names = ("tiles", "samples")

    def _moved(self, x: torch.Tensor, device):
        """``x`` where the backend can reach it: on the host for gloo (a
        CUDA tensor is staged through the host explicitly; the render
        itself ran on the card), on the card for nccl (a host tensor goes
        to ``device``, or to this process's current card)."""
        if dist.get_backend() == "gloo":
            return x.cpu() if x.is_cuda else x.clone()
        if x.is_cuda:
            return x.clone()
        if device is None or torch.device(device).type != "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return x.to(device)

    def sum(self, x: torch.Tensor, group, device=None) -> torch.Tensor:
        """Sum of ``x`` over ``group`` (None: over every process), on every
        process of it, on ``x``'s device."""
        if self.tiles_group is None:
            return x
        buf = self._moved(x, device)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(x.device)

    def gather_tiles(self, x: torch.Tensor) -> list:
        """``x`` of every process of this process's tiles group, in stripe
        order, on ``x``'s device."""
        if self.tiles_group is None:
            return [x]
        buf = self._moved(x, x.device)
        out = [torch.empty_like(buf) for _ in range(self.shape["tiles"])]
        dist.all_gather(out, buf, group=self.tiles_group)
        return [o.to(x.device) for o in out]


def make_mesh(n_tiles: int | None = None, n_samples: int = 1) -> Mesh:
    """Build the (tiles, samples) grid over the processes of the group
    (``init_distributed`` first; without a process group, the grid of this
    one process); defaults to every process on the tile axis.  Every
    process must call this, with the same arguments: it creates every
    tiles group and every samples group, in one order."""
    if not dist.is_initialized():
        if (n_tiles or 1) * n_samples != 1:
            raise ValueError(f"a {n_tiles} x {n_samples} mesh needs a process "
                             "group: call init_distributed first")
        return Mesh({"tiles": 1, "samples": 1}, (0, 0))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_tiles is None:
        n_tiles = world // n_samples
    if n_tiles * n_samples != world:
        raise ValueError(f"a {n_tiles} x {n_samples} mesh over {world} processes")
    t, s = divmod(rank, n_samples)
    tiles_groups = [dist.new_group([tt * n_samples + ss for tt in range(n_tiles)])
                    for ss in range(n_samples)]
    samples_groups = [dist.new_group([tt * n_samples + ss
                                      for ss in range(n_samples)])
                      for tt in range(n_tiles)]
    return Mesh({"tiles": n_tiles, "samples": n_samples}, (t, s),
                tiles_groups[s], samples_groups[t])


def whitted_shard(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    n_tiles: int,
    n_samples: int,
    t: int,
    s: int,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
):
    """What the process at (t, s) of an (n_tiles, n_samples) grid renders
    of a Whitted frame, with no communication: the stripe of
    ceil(height / n_tiles) rows from row t * rows on, under the s-th
    contiguous slice of the sample offset table.

    Neither axis needs to divide evenly: the last stripe may reach below
    the frustum (its surplus rows are cropped by the caller), and the
    offset table is padded to n_samples equal slices with (0.5, 0.5)
    offsets of weight 0, which contribute nothing.

    Returns ((rows, W, 3) partial image, stats).  The stripes' sum over s,
    concatenated over t and cropped to ``height`` rows, is the frame; the
    stats' sum over every (t, s) is the frame's.
    """
    rows = -(-height // n_tiles)  # ceil: last stripe may render cropped rows
    offs = np.asarray(spp_offsets(spp), np.float32)
    weight = 1.0 / len(offs)
    per_shard = -(-len(offs) // n_samples)
    o_pad = per_shard * n_samples - len(offs)
    offw = np.concatenate([np.ones(len(offs), np.float32),
                           np.zeros(o_pad, np.float32)])
    if o_pad:
        offs = np.concatenate(
            [offs, np.full((o_pad, 2), 0.5, np.float32)], axis=0)
    mine = slice(s * per_shard, (s + 1) * per_shard)
    return render_tile(
        dscene, cam_position, cam_rotation, width, height,
        offsets=[tuple(o) for o in offs[mine].tolist()], weight=weight,
        row_start=t * rows, rows=rows, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory,
        queue_factor=queue_factor, offset_weights=offw[mine].tolist(),
    )


def render_whitted_multichip(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    mesh: Mesh,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
):
    """Whitted frame sharded over a (tiles, samples) mesh; every process of
    the mesh calls it with the same arguments and its own ``dscene`` (on
    the device it renders on).

    Neither axis needs to divide evenly (see ``whitted_shard``): 1080 rows
    on a 16-process tile axis just works.

    Returns ((H, W, 3) image on the scene's device, stats) on every
    process: the sample-axis sum is one all-reduce over the samples group,
    the frame one all-gather over the tiles group, the stats an all-reduce
    over every process.
    """
    t, s = mesh.coords
    img, stats = whitted_shard(
        dscene, cam_position, cam_rotation, width, height,
        mesh.shape["tiles"], mesh.shape["samples"], t, s,
        max_depth=max_depth, spp=spp, intersect_fn=intersect_fn,
        occluder_factory=occluder_factory, queue_factor=queue_factor)
    img = mesh.sum(img, mesh.samples_group)
    stats = {k: mesh.sum(v, None, device=img.device) for k, v in stats.items()}
    return torch.cat(mesh.gather_tiles(img), dim=0)[:height], stats


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit generator seed from ``seed`` and a tuple of integers (the
    counterpart of ``jax.random.fold_in``): the same inputs always give the
    same seed, and distinct inputs distinct streams."""
    text = ",".join(str(int(x)) for x in (seed, *data)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def pathtrace_shard(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    seed: int,
    width: int,
    height: int,
    n_tiles: int,
    n_samples: int,
    t: int,
    s: int,
    spp: int = 1,
    max_depth: int = 6,
    intersect_fn=None,
    occluder_factory=None,
):
    """What the process at (t, s) accumulates of ``spp`` path-traced
    samples, with no communication: ceil(spp / n_samples) samples of stripe
    t, sample i drawn from a generator seeded by ``fold_in(seed, t, s,
    i)``.  Returns the (rows*W, 3) tile-major sum.  The sum over s times
    spp / (ceil(spp / n_samples) * n_samples) is the stripe's sum over
    ``spp`` samples in expectation."""
    from ..render.pathtrace import pathtrace_tile

    rows = -(-height // n_tiles)
    local_spp = -(-spp // n_samples)
    dev = dscene.geometry.woop.device
    acc = torch.zeros((rows * width, 3), dtype=torch.float32, device=dev)
    for i in range(local_spp):
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed, t, s, i))
        acc += pathtrace_tile(
            dscene, cam_position, cam_rotation, gen, width, height,
            row_start=t * rows, rows=rows, max_depth=max_depth,
            intersect_fn=intersect_fn, occluder_factory=occluder_factory)
    return acc


def pathtrace_multichip(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    seed: int,
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 1,
    max_depth: int = 6,
    intersect_fn=None,
    occluder_factory=None,
):
    """``spp`` path-traced samples sharded over a (tiles, samples) mesh;
    every process calls it with the same arguments.

    Each process renders its row stripe with an independent random stream
    per (stripe, sample shard, iteration); the progressive sum is one
    all-reduce over the samples group.  Neither axis needs to divide: rows
    pad to a ceil-stripe (cropped by ``untile_multichip``), and spp rounds
    UP to a multiple of n_samples — the returned sum is rescaled by
    spp/effective so callers dividing by ``spp`` still get the unbiased
    mean over all samples actually traced.

    Returns (H'*W, 3) accumulated radiance (divide by ``spp``), H' =
    n_tiles * ceil(H / n_tiles), laid out as per-stripe tile-major blocks —
    reassemble with ``untile_multichip``.
    """
    n_samples = mesh.shape["samples"]
    t, s = mesh.coords
    acc = pathtrace_shard(
        dscene, cam_position, cam_rotation, seed, width, height,
        mesh.shape["tiles"], n_samples, t, s, spp=spp, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory)
    effective_spp = -(-spp // n_samples) * n_samples
    acc = mesh.sum(acc, mesh.samples_group) * (spp / effective_spp)
    return torch.cat(mesh.gather_tiles(acc), dim=0)


def untile_multichip(flat, width: int, height: int, n_tiles: int):
    """Per-stripe tile-major (H'*W, 3) -> raster (H, W, 3).

    Stripes are ceil(height / n_tiles) rows each (matching the padded
    row-stripe sharding); surplus rows below the frustum are cropped.
    """
    rows = -(-height // n_tiles)
    tile, _ = pick_schedule(rows, width)  # must match render_tile's choice
    stripes = flat.reshape(n_tiles, rows * width, 3)
    return torch.cat(
        [untile(s, width, rows, tile) for s in stripes], dim=0
    )[:height]
