"""The any-hit walk's cull on the CPU: the cluster cull boxes (``cull_rows``)
and ``any_hit_plain``, which culls as the kernel does.

At each visit a 32-ray group runs a cluster's triangle tests only if one of
its open rays (live, armed and not yet blocked) meets the cluster's box over
[t_min, its t_max].  A pair that blocks has t_min <= t < t_max, so the box
must keep every pair the Woop test accepts there: on the adversarial rays of
tests/test_torch_closest_cull.py, by kind, with t_max just past and just
short of an accepted t; and the walk with the boxes must block exactly the
rays the walk without them blocks (``unbounded_rows``), on those rays and on
the bench scene's shadow batches as the Whitted frame and the path tracer
hand them to the occluder, at two tile sizes.  Blocked, disarmed and parked
rays never make a group run, and the counts of open and tested groups stay
within the visits' groups.  This file imports no JAX
(tests/test_torch_cuda.py reuses its batches on the card)."""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import _woop_transforms
from directx_raytracer_tpu_torch.ops.rays import T_MIN
from directx_raytracer_tpu_torch.render.pathtrace import pathtrace_sample
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.render.whitted import render_whitted
from test_torch_closest_cull import (
    ADVERSARIAL_KINDS,
    accepted_ts,
    adversarial_clusters,
    adversarial_kind,
    adversarial_rays,
)

torch.set_num_threads(2)

SHADOW_BATCHES = ["whitted_primary", "whitted_bounce", "pt_bounce"]


def t_max_at(t, end):
    """A t_max just past (the next float up) or just short of (t itself,
    which t < t_max refuses) an accepted t; 10.0 where t is +inf."""
    finite = torch.isfinite(t)
    safe = torch.where(finite, t, 10.0)
    if end == "past":
        safe = torch.nextafter(safe, torch.tensor(float("inf")))
    return torch.where(finite, safe, 10.0)


@pytest.fixture(scope="module")
def adversarial():
    wrows, verts = adversarial_clusters()
    return wrows, *adversarial_rays(verts)


@pytest.mark.parametrize("end", ["past", "short"])
@pytest.mark.parametrize("case", ADVERSARIAL_KINDS)
def test_cull_keeps_every_blocking_pair_adversarial(adversarial, case, end):
    """Each (ray, cluster) pair with t_max just past or just short of the
    pair's least accepted t: the box keeps the pair wherever one of the
    cluster's triangles is accepted at t_min <= t < t_max."""
    wrows, o, d = adversarial
    o, d = adversarial_kind(o, d, case)
    crows = ci.cull_rows(wrows)
    ts = accepted_ts(wrows, o, d)  # (R, C, K)
    t_max = t_max_at(ts.amin(dim=2), end)  # (R, C)
    needed = ((ts >= T_MIN) & (ts < t_max[..., None])).any(dim=2)
    keep = ci.cull_keep(o[:, None], d[:, None], t_max, crows[None])
    assert bool(keep[needed].all()), f"{int((needed & ~keep).sum())} dropped"
    if end == "past":
        assert int(needed.sum()) > 100
    else:  # the least accepted t itself never blocks
        assert int(needed.sum()) == 0


def adversarial_walk(wrows, o, d, t_max, tile_r):
    """any_hit_plain's operands for rays (o, d, t_max) in tiles of
    ``tile_r``, each tile listing every cluster at entry 0 (the gate stops
    a tile only once its armed rays are all blocked)."""
    n = o.shape[0] // tile_r * tile_r
    tiles, c = n // tile_r, wrows.shape[0]
    visit = torch.arange(c, dtype=torch.int32).expand(tiles, c).contiguous()
    return (o[:n].contiguous(), d[:n].contiguous(), t_max[:n].contiguous(),
            wrows, ci.cull_rows(wrows), visit, torch.zeros((tiles, c)),
            torch.full((tiles,), c, dtype=torch.int32), tile_r)


@pytest.mark.parametrize("end", ["past", "short"])
def test_walk_blocks_as_without_the_cull_adversarial(adversarial, end):
    """Every adversarial ray with t_max just past or just short of its
    least accepted t over all clusters (10.0 where none accepts): the walk
    with the cull boxes blocks exactly the rays the walk without them
    blocks, which are the rays with a hit for "past" and none for
    "short"."""
    wrows, o, d = adversarial
    t = accepted_ts(wrows, o, d).flatten(1).amin(dim=1)
    args = adversarial_walk(wrows, o, d, t_max_at(t, end), 256)
    got, open_c, tested = ci.any_hit_plain(*args, count_exec=True)
    want, open_u, tested_u = ci.any_hit_plain(
        *args[:4], ci.unbounded_rows(args[4]), *args[5:], count_exec=True)
    assert torch.equal(got, want)
    hit = torch.isfinite(t[:got.shape[0]])
    assert torch.equal(got, hit if end == "past" else torch.zeros_like(hit))
    assert int(hit.sum()) > 1000
    assert torch.equal(open_c, open_u) and torch.equal(tested_u, open_u)
    assert bool((tested <= open_c).all()) and tested.sum() < open_c.sum()


def shadow_batches(device, n_tris: int = 30_000, width: int = 192,
                   height: int = 96):
    """The shadow batches ``bench_scene(n_tris)`` at width x height hands
    its occluder, as (o, d, t_max) each, Morton-sorted over 4 lights: the
    Whitted frame's primary and bounce batches (depth 3) and a depth-4
    path-traced sample's first bounce batch; and the Renderer's BVH.  Few
    rays are armed (most primary hits are on the mirror ground, which
    takes no direct light), as at 1080p."""
    w, h = width, height
    r = Renderer(testscenes.bench_scene(n_tris, w, h), w, h, device=device)
    pos, rot = r.camera.snapshot()
    held = []

    def factory(geo):
        occluded = r.occluder_factory(geo)

        def occ(o, d, t_max):
            held.append((o.clone(), d.clone(), t_max.clone()))
            return occluded(o, d, t_max)
        return occ

    render_whitted(r.dscene, pos, rot, w, h, max_depth=3,
                   intersect_fn=r.intersect_fn, occluder_factory=factory)
    whitted = held[:2]
    held.clear()
    pathtrace_sample(r.dscene, pos, rot, 5, w, h, max_depth=4,
                     intersect_fn=r.intersect_fn, occluder_factory=factory)
    assert len(whitted) == 2 and len(held) >= 2
    return dict(zip(SHADOW_BATCHES, whitted + held[1:2])), r.bvh


@pytest.fixture(scope="module")
def batches():
    return shadow_batches("cpu")


@pytest.mark.parametrize("tile_r", [256, 100])
@pytest.mark.parametrize("name", SHADOW_BATCHES)
def test_cull_changes_no_blocked_flag(batches, name, tile_r):
    """A bench-scene shadow batch: any_hit_plain with the BVH's cull boxes
    blocks exactly the rays it blocks with boxes that drop nothing, with
    the same open groups at every tile; the cull skips groups; per tile
    0 <= tested <= open_groups; ``stats`` sums them, within the visits'
    groups; the CPU route of any_hit is the plain walk's, counts
    included."""
    (o, d, t_max), bvh = batches[0][name], batches[1]
    args = ci.anyhit_schedule(o, d, t_max, bvh.clusters, bvh.wrows, bvh.crows,
                              tile_r, srows=bvh.srows)
    stats = {}
    got, open_c, tested = ci.any_hit_plain(*args, stats=stats, count_exec=True)
    want, open_u, tested_u = ci.any_hit_plain(
        *args[:4], ci.unbounded_rows(args[4]), *args[5:], count_exec=True)
    assert torch.equal(got, want) and int(got.sum()) > 20
    assert torch.equal(open_c, open_u) and torch.equal(tested_u, open_u)
    assert bool((tested >= 0).all()) and bool((tested <= open_c).all())
    assert int(tested.sum()) < int(open_c.sum())
    groups = -(-tile_r // ci.CULL_GROUP)
    assert stats["tested"] == int(tested.sum())
    assert stats["open_groups"] == int(open_c.sum())
    assert 0 < stats["tested"] <= stats["open_groups"] <= stats["visits"] * groups
    assert torch.equal(ci.any_hit_plain(*args), got)
    route = ci.any_hit(*args, count_exec=True)
    for a, b in zip(route, (got, open_c, tested)):
        assert torch.equal(a, b)


def lane_tile():
    """Two clusters of one triangle each, z = 0 and z = -1 over [-1, 1]^2
    (sentinels after them), and one 96-ray tile listing both at entry 0:
    rays 0-31 down onto both (blocked at the first, their rays still
    reaching the second's box), rays 32-63 disarmed (t_max 0) down onto
    both, rays 64-95 armed along +x at z = 50, which reach neither box and
    keep the tile's gate open."""
    k = 32
    woop = np.zeros((2, k, 3, 4), np.float32)
    woop[..., 3] = -1e30
    for c, z in enumerate((0.0, -1.0)):
        woop[c, :1] = _woop_transforms(
            np.array([[-1.0, -1.0, z]], np.float32),
            np.array([[4.0, 0.0, 0.0]], np.float32),
            np.array([[0.0, 4.0, 0.0]], np.float32))
    wrows = torch.from_numpy(woop).reshape(2, k, 12)
    g = torch.Generator().manual_seed(4)
    xy = torch.rand((64, 2), generator=g) * 0.8 - 0.4
    o = torch.cat([torch.cat([xy, torch.ones((64, 1))], dim=1),
                   torch.tensor([[0.0, 0.0, 50.0]]).expand(32, 3)])
    d = torch.cat([torch.tensor([[0.0, 0.0, -1.0]]).expand(64, 3),
                   torch.tensor([[1.0, 0.0, 0.0]]).expand(32, 3)])
    t_max = torch.cat([torch.full((32,), 5.0), torch.zeros(32),
                       torch.full((32,), 5.0)])
    return (o.contiguous(), d.contiguous(), t_max, wrows, ci.cull_rows(wrows),
            torch.tensor([[0, 1]], dtype=torch.int32), torch.zeros((1, 2)),
            torch.tensor([2], dtype=torch.int32), 96)


@pytest.mark.parametrize("lanes", ["blocked_disarmed", "parked"])
def test_blocked_disarmed_and_parked_lanes_never_run_a_group(lanes):
    """``lane_tile``: at the first cluster only the first group runs; at
    the second, no group: its blocked and its disarmed rays reach the box
    but do not vote, and the armed group misses it.  With the first group
    parked (origin 1e30, dir 1, t_max 0, as ``pad_and_cap`` pads), no group
    runs at all."""
    args = list(lane_tile())
    o, d, t_max, crows = args[0], args[1], args[2], args[4]
    if lanes == "parked":
        o[:32], d[:32], t_max[:32] = 1e30, 1.0, 0.0
    else:  # the first group's rays reach the second cluster's box
        assert bool(ci.cull_keep(o[:32], d[:32], t_max[:32], crows[1]).all())
    assert bool(ci.cull_keep(o[32:64], d[32:64], torch.tensor(5.0),
                             crows[1]).all())
    assert not bool(ci.cull_keep(o[64:], d[64:], t_max[64:], crows[0]).any())
    stats = {}
    blocked, open_groups, tested = ci.any_hit_plain(*args, stats=stats,
                                                    count_exec=True)
    first = lanes != "parked"
    assert torch.equal(blocked, torch.arange(96) < (32 if first else 0))
    assert stats["visits"] == 2
    # Visit 1: the first group (if armed) and the third are open, the first
    # runs; visit 2: the third alone is open, and it misses the box.
    assert int(open_groups) == (3 if first else 2)
    assert int(tested) == (1 if first else 0)
