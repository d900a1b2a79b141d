"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: every test skips where there is no CUDA device.  This file
imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the binning kernel (dense and superblock modes) evaluates the
plain version's ops in the same order with IEEE divides and orders its
lists by one total order (entry, then cluster id), so its lists must equal
``bin_lists_plain``'s exactly.  ``closest_hit`` contracts a*b+c into FMAs where the plain version
rounds twice, so t may differ by ulps and a hit exactly on an edge may
flip: hit/miss agreement >= 99.9%, same winner >= 99%, t within 1e-5
relative on >= 99.9% of common hits.  ``any_hit`` contracts the same way:
blocked flags agree on >= 99.9% of rays (the reference's occlusion gate).
Whitted frames: within 2 u8 levels on >= 99% of pixels, alive per pass
within 0.1% of the pixel count.  ``precision_fold``: identical sentinel
sets and each ray's min t within 1e-3 relative (the repository's t gate,
bench.py:156-164) on >= 99.5% of rays: kernel and plain version sum the
depth-8 products in different orders, and the tail's cancellation
amplifies that to ~1e-4 relative on the winning t.  A path-traced sample
through the kernels against the same sample (same generator seed) through
their plain versions: the Whitted frame gate.
"""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import TILE_R, build_bvh, intersect_fused
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import (
    _woop_transforms,
    build_device_scene,
)
from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.ops.intersect import occluded_bruteforce
from directx_raytracer_tpu_torch.render.debug import render_debug
from directx_raytracer_tpu_torch.render.pathtrace import pathtrace_sample
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.render.whitted import render_whitted
from directx_raytracer_tpu_torch.tools import precision_micro as pm
from directx_raytracer_tpu_torch.utils.image import to_u8
from directx_raytracer_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

W, H = 96, 48


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def x(cuda):
    scene = testscenes.bench_scene(3_000, W, H)
    geo = build_device_scene(scene, cuda).geometry
    bvh = build_bvh(geo)
    tile, tile_r = pick_schedule(H, W)
    pos, rot = scene.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, W, H, *tile, device=cuda)
    o, d, t_init = ci.pad_and_seed(o, d, bvh.clusters, tile_r)
    tp = ci.tile_params(o, d, tile_r)
    cb = ci.cluster_rows(bvh.clusters)
    entry, overlap = ci.bin_clusters_plain(tp, cb)
    lists = ci.visit_lists(entry, overlap)
    return dict(o=o, d=d, t_init=t_init, tp=tp, cb=cb, bvh=bvh,
                tile_r=tile_r, lists=lists, entry=entry, overlap=overlap)


def assert_lists_equal(got, want):
    """The kernel's stride-C lists against the plain version's compact
    ones: widths, counts, and each row's first counts[t] positions (ids,
    and entries as bits)."""
    visit, ventry, counts, width = got
    w_visit, w_ventry, w_counts, w_width = want
    torch.cuda.synchronize()
    assert width == w_width and torch.equal(counts, w_counts)
    mine = torch.arange(width, device=counts.device) < counts[:, None]
    assert torch.equal(visit[:, :width][mine], w_visit[mine])
    assert torch.equal(ventry[:, :width][mine].view(torch.int32),
                       w_ventry[mine].view(torch.int32))


def test_bin_kernel_matches_plain(x):
    got = ci.bin_lists(x["tp"], x["cb"])
    assert got[0].shape == (x["tp"].shape[0], x["cb"].shape[1])
    assert_lists_equal(got, ci.bin_lists_plain(x["tp"], x["cb"]))
    assert_lists_equal(got, (*x["lists"], x["lists"][0].shape[1]))


def scene_box(x):
    cs = x["bvh"].clusters
    lo = torch.where(cs.valid[:, None], cs.aabb_min, float("inf")).amin(0)
    hi = torch.where(cs.valid[:, None], cs.aabb_max, -float("inf")).amax(0)
    return lo, hi


def bin_case(x, name):
    """Tile params and cluster rows of one binning case on the card."""
    cb = x["cb"]
    o, d, _ = ci.pad_and_seed(x["o"], x["d"], x["bvh"].clusters, 256)
    tp = ci.tile_params(o, d, 256)
    if name == "ties":  # origins inside the scene: entries clamp to t_min
        lo, hi = scene_box(x)
        mid, half = (lo + hi) / 2, (hi - lo) / 8
        tp[::2, 0:3], tp[::2, 3:6] = mid - half, mid + half
    elif name == "parked":  # odd tiles all parked rays: they bin nothing
        o, d = o.reshape(-1, 256, 3).clone(), d.reshape(-1, 256, 3).clone()
        o[1::2], d[1::2] = 1e30, 1.0
        tp = ci.tile_params(o.reshape(-1, 3), d.reshape(-1, 3), 256)
    elif name == "t_cap":  # a cap exactly at a listed entry
        _, ventry, counts, _ = ci.bin_lists_plain(tp, cb)
        tp[:, 14] = ventry[:, 0]
        t = int(torch.argmax(counts))
        tp[t, 14] = ventry[t, int(counts[t]) // 2]
    elif name == "super_min_c":  # SUPER_MIN_C random boxes over the scene
        g = torch.Generator().manual_seed(1)
        lo, hi = scene_box(x)
        ext = (hi - lo).cpu()
        c = ci.SUPER_MIN_C
        box_lo = lo.cpu()[:, None] + torch.rand((3, c), generator=g) * ext[:, None]
        cb = torch.zeros((8, c))
        cb[0:3] = box_lo
        cb[3:6] = box_lo + (0.2 + 0.8 * torch.rand((3, c), generator=g)) * 0.05 * ext[:, None]
        cb[6] = (torch.rand(c, generator=g) > 0.05).float()
        cb = cb.to(tp.device)
    return tp, cb


@pytest.mark.parametrize("mode", ["dense", "super"])
@pytest.mark.parametrize("name", ["primary", "ties", "parked", "t_cap",
                                  "super_min_c"])
def test_bin_kernel_cases_match_plain(x, name, mode):
    """Both modes: the plain lists exactly."""
    tp, cb = bin_case(x, name)
    want = ci.bin_lists_plain(tp, cb)
    assert want[3] > 0
    assert_lists_equal(ci.bin_lists(tp, cb, mode=mode, block=8), want)
    if name == "parked":
        assert (want[2][1::2] == 0).all()


def overflow_case(device, c=40_000):
    """Random (8, c) rows of small boxes in [-500, 500]^3 (5% invalid, box
    floors on a unit grid in z, so entries tie) and three tiles: one whose
    origin slab spans every box in x and y below them all (it lists every
    valid cluster, far more than the kernel's shared buffer), one parked,
    one narrow."""
    g = torch.Generator().manual_seed(0)
    lo = torch.rand((3, c), generator=g) * 1000 - 500
    lo[2] = torch.floor(lo[2])
    cb = torch.zeros((8, c))
    cb[0:3] = lo
    cb[3:6] = lo + torch.rand((3, c), generator=g) * 5 + 0.1
    cb[6] = (torch.rand(c, generator=g) > 0.05).float()
    tp = torch.zeros((3, 16))
    tp[0, 0:6] = torch.tensor([-1e3, -1e3, -600.0, 1e3, 1e3, -600.0])
    tp[0, 6:12] = torch.tensor([-0.5, -0.5, 0.5, 0.5, 0.5, 1.0])
    tp[1, 0:6], tp[1, 6:12] = 1e30, 1.0
    tp[2, 0:6] = torch.tensor([0.0, 0.0, -600.0, 10.0, 10.0, -600.0])
    tp[2, 6:12] = torch.tensor([0.1, 0.1, 0.9, 0.2, 0.2, 1.0])
    tp[:, 12], tp[:, 13], tp[:, 14] = 1.0, 1e-3, 1e30
    return tp.to(device), cb.to(device)


def test_bin_kernel_overflow_tile(cuda):
    """A tile listing ~38,000 clusters sorts over its output rows: no
    cluster dropped, the plain lists exactly, in both modes."""
    tp, cb = overflow_case(cuda)
    want = ci.bin_lists_plain(tp, cb, ci.super_rows(cb))
    assert int(want[2][0]) == int((cb[6] > 0.5).sum()) > 2048
    assert int(want[2][1]) == 0 and 0 < int(want[2][2]) < int(want[2][0])
    assert_lists_equal(ci.bin_lists(tp, cb), want)
    assert_lists_equal(ci.bin_lists(tp, cb, mode="dense"), want)


def test_walk_kernels_on_stride_lists(x):
    """closest_hit and any_hit on the binning kernel's stride-C lists give
    what they give on the plain version's compact lists."""
    tile_r = x["tile_r"]
    visit, ventry, counts, width = ci.bin_lists(x["tp"], x["cb"])
    args = (x["o"], x["d"], x["t_init"], x["bvh"].wrows, x["bvh"].crows)
    got = ci.closest_hit(*args, visit, ventry, counts, tile_r, width=width)
    want = ci.closest_hit(*args, *x["lists"], tile_r)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    batch = shadow_batch(x)
    o, d, t_max, *lists = ci.anyhit_schedule(*batch, x["bvh"].clusters)
    assert lists[0].shape[1] == x["cb"].shape[1]  # the kernel's stride
    compact = ci.anyhit_schedule(*batch, x["bvh"].clusters, plain=True)[3:]
    got = ci.any_hit(o, d, t_max, x["bvh"].wrows, *lists, TILE_R)
    want = ci.any_hit(o, d, t_max, x["bvh"].wrows, *compact, TILE_R)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def closest_vs_plain(x, tile_r, chunk=ci.CLOSEST_CHUNK):
    n = x["o"].shape[0] // tile_r * tile_r
    o, d, t_init = x["o"][:n], x["d"][:n], x["t_init"][:n]
    tp = ci.tile_params(o, d, tile_r)
    lists = ci.visit_lists(*ci.bin_clusters_plain(tp, x["cb"]))
    args = (o, d, t_init, x["bvh"].wrows, x["bvh"].crows, *lists, tile_r)
    bt_k, bs_k = ci.closest_hit(*args, chunk=chunk)
    bt_p, bs_p = ci.closest_hit_plain(*args)
    torch.cuda.synchronize()
    hk, hp = bs_k >= 0, bs_p >= 0
    assert (hk == hp).float().mean() >= 0.999
    both = hk & hp
    assert both.sum() > 100
    assert (bs_k[both] == bs_p[both]).float().mean() >= 0.99
    rel = (bt_k[both] - bt_p[both]).abs() / bt_p[both]
    assert (rel <= 1e-5).float().mean() >= 0.999


@pytest.mark.parametrize("tile_r", [768, 640, 256, 100])
def test_closest_kernel_matches_plain(x, tile_r):
    """768: the 1080p frame's tiles; 640: those of a 540-row stripe of the
    multi-device path; 256: a bounce queue's; 100: no multiple of a warp."""
    closest_vs_plain(x, tile_r)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("tile_r", [768, 640, 256, 100])
def test_closest_kernel_split_lists_match_plain(x, tile_r, chunk):
    """Lists cut into work items of 1 or 3 positions, merged by the
    packed-key atomicMin: the same gates against the plain walk."""
    closest_vs_plain(x, tile_r, chunk)


@pytest.mark.parametrize("chunk", [ci.CLOSEST_CHUNK, 1, None])
@pytest.mark.parametrize("tile_r", [768, 256])
def test_closest_count_exec_build(x, tile_r, chunk):
    """The counting build: best t and slot bit-equal to the production
    build's, per tile plain visits <= executed <= counts, and with one work
    item a tile (chunk None: the longest list) executed equal to the plain
    walk's visits on >= 99.9% of tiles (FMA contraction may flip a gate on
    a knife-edge entry); the 32-ray groups tested within [0, executed x
    ceil(tile_r / 32)] per tile, fewer in all; launches counted as
    closest_hit_exec."""
    n = x["o"].shape[0] // tile_r * tile_r
    o, d, t_init = x["o"][:n], x["d"][:n], x["t_init"][:n]
    visit, ventry, counts, width = ci.bin_lists(ci.tile_params(o, d, tile_r),
                                                x["cb"])
    args = (o, d, t_init, x["bvh"].wrows, x["bvh"].crows, visit, ventry,
            counts, tile_r)
    chunk = max(width, 1) if chunk is None else chunk
    before = trace.launches()
    bt, bs = ci.closest_hit(*args, chunk=chunk, width=width)
    bt_c, bs_c, executed, tested = ci.closest_hit(*args, chunk=chunk,
                                                  width=width, count_exec=True)
    _, _, plain, _ = ci.closest_hit_plain(*args, count_exec=True)
    torch.cuda.synchronize()
    assert trace.launches()["closest_hit"] == before["closest_hit"] + 1
    assert trace.launches()["closest_hit_exec"] == before["closest_hit_exec"] + 1
    assert torch.equal(bt.view(torch.int32), bt_c.view(torch.int32))
    assert torch.equal(bs, bs_c)
    assert executed.dtype == torch.int32 and executed.shape == counts.shape
    assert bool((plain <= executed).all()) and bool((executed <= counts).all())
    assert int(plain.sum()) > 0
    if chunk >= width:
        assert (executed == plain).float().mean() >= 0.999
    groups = -(-tile_r // ci.CULL_GROUP)
    assert tested.dtype == torch.int32 and tested.shape == counts.shape
    assert bool((tested >= 0).all()) and bool((tested <= executed * groups).all())
    assert 0 < int(tested.sum()) < int(executed.sum()) * groups


def adversarial_batch(device, tile_r):
    """The CPU tests' adversarial rays (tests/test_torch_closest_cull.py:
    hits on vertices and edges, zero direction components, origins on a
    face's plane or inside a box, slender triangles, a cluster at 1e3) in
    tiles of ``tile_r``, each tile listing every cluster (entries 0, so
    the gate never stops a walk), seeded at 1e4."""
    from test_torch_closest_cull import adversarial_clusters, adversarial_rays

    wrows, verts = adversarial_clusters()
    o, d = adversarial_rays(verts)
    n = o.shape[0] // tile_r * tile_r
    tiles, c = n // tile_r, wrows.shape[0]
    visit = torch.arange(c, dtype=torch.int32).expand(tiles, c).contiguous()
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in (
        o[:n].contiguous(), d[:n].contiguous(), torch.full((n,), 1e4), wrows,
        ci.cull_rows(wrows), visit, torch.zeros((tiles, c)),
        torch.full((tiles,), c, dtype=torch.int32), tile_r))


def batch_args(x, name, tile_r):
    """closest_hit's operands of one batch on the card."""
    if name == "adversarial":
        return adversarial_batch(x["o"].device, tile_r)
    n = x["o"].shape[0] // tile_r * tile_r
    o, d, t_init = x["o"][:n], x["d"][:n], x["t_init"][:n]
    if name == "bounce":  # from the primary hits, in random directions
        hit = intersect_fused(o, d, x["bvh"].clusters, x["bvh"].wrows, tile_r,
                              plain=True, crows=x["bvh"].crows)
        p = o + d * torch.where(hit.mask, hit.t, 0.0)[:, None]
        g = torch.Generator().manual_seed(2)
        d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                          dim=1).to(o.device)
        o, d, t_init = ci.pad_and_seed(p + d * 1e-3, d, x["bvh"].clusters,
                                       tile_r)
    lists = ci.bin_lists(ci.tile_params(o, d, tile_r), x["cb"])[:3]
    return (o, d, t_init, x["bvh"].wrows, x["bvh"].crows, *lists, tile_r)


@pytest.mark.parametrize("chunk", [ci.CLOSEST_CHUNK, 1])
@pytest.mark.parametrize("tile_r", [768, 640, 256, 100])
@pytest.mark.parametrize("name", ["primary", "bounce", "adversarial"])
def test_closest_cull_changes_no_result(x, name, tile_r, chunk):
    """The kernel with the clusters' cull boxes against the same kernel with
    boxes that drop nothing: best t and slot bit-equal, on the primary
    batch, a mirror bounce batch and the adversarial batch; and the cull
    skips groups on the primary batch (its counting build)."""
    args = batch_args(x, name, tile_r)
    bt, bs = ci.closest_hit(*args, chunk=chunk)
    want_t, want_s = ci.closest_hit(*args[:4], ci.unbounded_rows(args[4]),
                                    *args[5:], chunk=chunk)
    _, _, executed, tested = ci.closest_hit(*args, chunk=chunk,
                                            count_exec=True)
    torch.cuda.synchronize()
    assert int((want_s >= 0).sum()) > 100
    assert torch.equal(bt.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(bs, want_s)
    groups = -(-tile_r // ci.CULL_GROUP)
    assert bool((tested <= executed * groups).all())
    if name == "primary":
        assert int(tested.sum()) < int(executed.sum()) * groups


def tie_tile(order, device, init_t=100.0):
    """One 32-ray tile over two clusters that hold the same triangle, at
    slots 5 (cluster 0) and K + 3 (cluster 1), visited in ``order``."""
    k, tile_r = 128, 32
    woop = np.zeros((2, k, 3, 4), np.float32)
    woop[..., 3] = -1e30  # guaranteed-miss sentinels
    tri = _woop_transforms(np.array([[-1.0, -1.0, 0.0]], np.float32),
                           np.array([[2.0, 0.0, 0.0]], np.float32),
                           np.array([[1.0, 2.0, 0.0]], np.float32))[0]
    woop[0, 5], woop[1, 3] = tri, tri
    rng = np.random.default_rng(3)
    o = np.zeros((tile_r, 3), np.float32)
    o[:, :2] = rng.uniform(-0.3, 0.3, (tile_r, 2))
    o[:, 2] = 2.0
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (tile_r, 1))
    t = torch.as_tensor(init_t, dtype=torch.float32).expand(tile_r)
    wrows = torch.from_numpy(woop).reshape(2, k, 12)
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in (
        torch.from_numpy(o), torch.from_numpy(d), t.contiguous(), wrows,
        ci.cull_rows(wrows), torch.tensor([order], dtype=torch.int32),
        torch.zeros((1, 2)),
        torch.tensor([2], dtype=torch.int32), tile_r))


@pytest.mark.parametrize("order", [[1, 0], [0, 1]])
def test_closest_kernel_tie_across_items(cuda, order):
    """The two clusters fall in different work items (chunk 1): the lower
    slot wins whatever order the items merge in, as in the plain walk."""
    args = tie_tile(order, cuda)
    bt_k, bs_k = ci.closest_hit(*args, chunk=1)
    bt_p, bs_p = ci.closest_hit_plain(*args)
    torch.cuda.synchronize()
    assert (bs_p == 5).all() and torch.equal(bs_k, bs_p)
    assert torch.equal(bt_k, bt_p)


@pytest.mark.parametrize("chunk", [1, 8])
def test_closest_kernel_refuses_a_hit_at_the_seed(cuda, chunk):
    """A hit at exactly t = init_t is refused (the seed's low word is 0);
    one ulp further, the seed lets it through."""
    t_hit, _ = ci.closest_hit_plain(*tie_tile([0, 1], cuda))
    t_hit = float(t_hit[0])
    bt, bs = ci.closest_hit(*tie_tile([0, 1], cuda, t_hit), chunk=chunk)
    torch.cuda.synchronize()
    assert (bs == -1).all() and (bt == t_hit).all()
    above = float(np.nextafter(np.float32(t_hit), np.float32(np.inf)))
    bt, bs = ci.closest_hit(*tie_tile([0, 1], cuda, above), chunk=chunk)
    torch.cuda.synchronize()
    assert (bs == 5).all() and (bt == t_hit).all()


def test_wrappers_count_launches(x):
    before = trace.launches()
    ci.bin_lists(x["tp"], x["cb"])
    ci.closest_hit(x["o"], x["d"], x["t_init"], x["bvh"].wrows, x["bvh"].crows,
                   *x["lists"], x["tile_r"])
    ci.bin_lists_plain(x["tp"], x["cb"])
    ci.bin_lists(x["tp"], x["cb"], plain=True)
    assert trace.launches()["bin_clusters"] == before["bin_clusters"] + 1
    assert trace.launches()["closest_hit"] == before["closest_hit"] + 1
    ci.bin_lists(x["tp"], x["cb"], mode="super", block=8)
    assert trace.launches()["bin_clusters_super"] == before["bin_clusters_super"] + 1


def test_wrappers_reject_bad_operands(x):
    with pytest.raises(ValueError):
        ci.bin_lists(x["tp"].double(), x["cb"])
    with pytest.raises(ValueError):
        ci.bin_lists(x["tp"], x["cb"].T.contiguous().T)  # not contiguous
    with pytest.raises(ValueError):
        ci.bin_lists(x["tp"], x["cb"].cpu())
    with pytest.raises(ValueError):  # hull rows of another block size
        ci.bin_lists(x["tp"], x["cb"], ci.super_rows(x["cb"], 8), mode="super",
                     block=4)
    args = [x["o"], x["d"], x["t_init"], x["bvh"].wrows, x["bvh"].crows,
            *x["lists"]]
    with pytest.raises(ValueError):
        ci.closest_hit(*args, 1024)  # more rays per tile than the CTA holds
    with pytest.raises(ValueError):
        ci.closest_hit(*args[:5], args[5].long(), *args[6:], x["tile_r"])
    with pytest.raises(ValueError):  # cull boxes of another shape
        ci.closest_hit(*args[:4], args[4][:, :7].contiguous(), *args[5:],
                       x["tile_r"])


def test_frame_matches_plain(cuda):
    """Mode 5 through the Renderer (kernels) vs render_debug through the
    plain versions: within 2 u8 levels on >= 99% of pixels."""
    r = Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=cuda)
    before = trace.launches()
    img = r.render_frame(5)
    assert all(trace.launches()[k] > before[k] for k in ("bin_clusters",
                                                    "closest_hit"))

    def plain_fn(o, d, geo, tile_r=None):
        return intersect_fused(o, d, r.bvh.clusters, r.bvh.wrows,
                               tile_r or TILE_R, plain=True,
                               crows=r.bvh.crows)

    pos, rot = r.camera.snapshot()
    ref = render_debug(r.dscene, pos, rot, 5, W, H, intersect_fn=plain_fn,
                       fetch_record=False)
    diff = (to_u8(img).astype(int) - to_u8(ref).astype(int))
    assert ((abs(diff) <= 2).all(axis=-1)).mean() >= 0.99


def shadow_batch(x, light=(9.0, 7.0, 0.0)):
    """Shadow rays from the primary hit points toward one light: t_max is
    the distance less twice the bias, 0 (disarmed) for misses."""
    n = x["o"].shape[0]
    hit = intersect_fused(x["o"], x["d"], x["bvh"].clusters, x["bvh"].wrows,
                          x["tile_r"], plain=True, crows=x["bvh"].crows)
    p = x["o"] + x["d"] * torch.where(hit.mask, hit.t, 0.0)[:, None]
    to_l = torch.tensor(light, device=p.device) - p
    dist = to_l.norm(dim=1)
    d = to_l / dist[:, None]
    o = p + d * 1e-3
    t_max = torch.where(hit.mask, dist - 2e-3, 0.0)
    assert n == t_max.shape[0] and hit.mask.sum() > 100
    return o.contiguous(), d.contiguous(), t_max


def test_any_hit_kernel_matches_plain(x):
    o, d, t_max, *lists = ci.anyhit_schedule(*shadow_batch(x),
                                             x["bvh"].clusters)
    args = (o, d, t_max, x["bvh"].wrows, *lists, TILE_R)
    before = trace.launches()["any_hit"]
    got = ci.any_hit(*args)
    assert trace.launches()["any_hit"] == before + 1
    want = ci.any_hit_plain(*args)
    torch.cuda.synchronize()
    assert (got == want).float().mean() >= 0.999
    assert want.any() and (~want).any()
    brute = occluded_bruteforce(o, d, x["bvh"].clusters.woop.reshape(-1, 3, 4),
                                t_max)
    assert (got == brute).float().mean() >= 0.999


@pytest.mark.parametrize("tile_r", [256, 100])
def test_any_hit_kernel_tile_r_matches_plain(x, tile_r):
    """One ray per thread in 256-thread CTAs: full and partial tiles."""
    o, d, t_max, *lists = ci.anyhit_schedule(*shadow_batch(x),
                                             x["bvh"].clusters, tile_r)
    args = (o, d, t_max, x["bvh"].wrows, *lists, tile_r)
    got = ci.any_hit(*args)
    want = ci.any_hit_plain(*args)
    torch.cuda.synchronize()
    assert (got == want).float().mean() >= 0.999
    assert want.any() and (~want).any()


def test_occluded_fused_kernels_match_plain(x):
    o, d, t_max = shadow_batch(x)
    args = (o, d, x["bvh"].clusters, x["bvh"].wrows, t_max)
    got = ci.occluded_fused(*args)
    want = ci.occluded_fused(*args, plain=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape == t_max.shape
    assert (got == want).float().mean() >= 0.999


@pytest.mark.parametrize("block", [32, 8])
def test_super_kernel_matches_dense_and_plain(x, block):
    sb = ci.super_rows(x["cb"], block)
    before = trace.launches()["bin_clusters_super"]
    got = ci.bin_lists(x["tp"], x["cb"], sb, mode="super", block=block)
    assert trace.launches()["bin_clusters_super"] == before + 1
    assert_lists_equal(got, ci.bin_lists_plain(x["tp"], x["cb"], sb, block))
    assert_lists_equal(got, ci.bin_lists_plain(x["tp"], x["cb"]))
    visit, ventry, counts, width = ci.bin_lists(x["tp"], x["cb"], mode="dense")
    assert_lists_equal(got, (visit[:, :width], ventry[:, :width], counts,
                             width))


def test_whitted_frame_matches_plain(cuda):
    """A depth-3 Whitted frame through the Renderer (kernels) vs the same
    frame through the plain versions on the card."""
    r = Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=cuda)
    before = trace.launches()
    img, stats = r.render_whitted_frame(max_depth=3)
    for name in ("bin_clusters", "closest_hit", "any_hit"):
        assert trace.launches()[name] > before[name], name

    def plain_isect(o, d, geo, tile_r=None):
        return intersect_fused(o, d, r.bvh.clusters, r.bvh.wrows,
                               tile_r or TILE_R, plain=True,
                               crows=r.bvh.crows)

    def plain_occ(geo):
        def occluded(o, d, t_max):
            return ci.occluded_fused(o, d, r.bvh.clusters, r.bvh.wrows, t_max,
                                     plain=True)
        return occluded

    pos, rot = r.camera.snapshot()
    ref, ref_stats = render_whitted(r.dscene, pos, rot, W, H, max_depth=3,
                                    intersect_fn=plain_isect,
                                    occluder_factory=plain_occ)
    assert torch.isfinite(img).all()
    diff = (to_u8(img).astype(int) - to_u8(ref).astype(int))
    assert ((abs(diff) <= 2).all(axis=-1)).mean() >= 0.99
    assert (stats["alive"] - ref_stats["alive"]).abs().max() <= 0.001 * W * H
    assert stats["alive"][0] > 0


@pytest.fixture(scope="module")
def fold_inputs(cuda):
    """Seeded standard normal w (64, 8, 6K) and rays (1, 8, R) on the card."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 8, 6 * pm.K)).astype(np.float32)
    rays = rng.standard_normal((1, 8, pm.R)).astype(np.float32)
    return torch.from_numpy(w).to(cuda), torch.from_numpy(rays).to(cuda)


@pytest.mark.parametrize("variant", pm.VARIANTS)
def test_precision_fold_kernel_matches_plain(fold_inputs, variant):
    w, rays = fold_inputs
    before = trace.launches()[f"precision_micro.{variant}"]
    got = pm.min_t(pm.precision_fold(variant, w, rays))
    assert trace.launches()[f"precision_micro.{variant}"] == before + 1
    want = pm.min_t(pm.precision_fold_plain(variant, w, rays))
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isfinite(want).sum() > pm.R // 2
    assert pm.agreement(got, want, 1e-3) >= 0.995


@pytest.mark.parametrize("variant", pm.VARIANTS)
def test_precision_fold_zero_denominator_is_no_hit(cuda, variant):
    """mm[5K+k] = 0 makes tt = +inf, u = NaN, v = +inf: a min that drops
    NaN would accept it; the kernel must not."""
    w = torch.zeros((1, 8, 6 * pm.K), device=cuda)
    w[0, 0, 0:2 * pm.K] = 0.25
    w[0, 0, 2 * pm.K:3 * pm.K] = -1.0
    w[0, 0, 4 * pm.K:5 * pm.K] = 1.0
    rays = torch.randn((1, 8, pm.R), device=cuda)
    rays[0, 0] = 1.0
    out = pm.precision_fold(variant, w, rays)
    torch.cuda.synchronize()
    assert (out == pm.SENTINEL).all()


def test_precision_fold_rejects_bad_operands(fold_inputs):
    w, rays = fold_inputs
    with pytest.raises(ValueError):
        pm.precision_fold("highest", w[:, :, :512].contiguous(), rays)
    with pytest.raises(ValueError):
        pm.precision_fold("highest", w.double(), rays)
    with pytest.raises(ValueError):
        pm.precision_fold("highest", w, rays[:, :, :128].contiguous())
    with pytest.raises(ValueError):
        pm.precision_fold("fast", w, rays)


@pytest.mark.parametrize("steps", [8, 2048])
def test_precision_fold_highest_matches_plain(cuda, steps):
    """The highest variant (4 rays a thread, two triangle shares a CTA) at
    fewer steps than CTAs and at the tool's own size."""
    w, rays = pm.make_inputs(steps, cuda)
    got = pm.min_t(pm.precision_fold("highest", w, rays))
    want = pm.min_t(pm.precision_fold_plain("highest", w, rays))
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isfinite(want).sum() > pm.R // 2
    assert pm.agreement(got, want, 1e-3) >= 0.995


def test_pathtrace_sample_matches_plain(cuda):
    """One depth-4 sample of bench_scene(3_000): every frame kernel
    launches, and the sample agrees with the one the plain versions give
    from the same generator seed."""
    r = Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=cuda)
    pos, rot = r.camera.snapshot()
    bvh = r.bvh

    def plain_isect(o, d, geo, tile_r=None):
        return intersect_fused(o, d, bvh.clusters, bvh.wrows, tile_r or TILE_R,
                               plain=True, srows=bvh.srows, crows=bvh.crows)

    def plain_occ(geo):
        return lambda o, d, t_max: ci.occluded_fused(
            o, d, bvh.clusters, bvh.wrows, t_max, plain=True, srows=bvh.srows)

    def sample(isect, occf):
        gen = torch.Generator(device=cuda).manual_seed(5)
        return pathtrace_sample(r.dscene, pos, rot, gen, W, H, max_depth=4,
                                intersect_fn=isect, occluder_factory=occf)

    trace.reset()
    got = sample(r.intersect_fn, r.occluder_factory)
    torch.cuda.synchronize()
    for name in ("bin_clusters", "closest_hit", "any_hit"):
        assert trace.launches()[name] > 0, name
    before = trace.launches()
    want = sample(plain_isect, plain_occ)
    assert trace.launches() == before  # the plain versions launch nothing
    assert torch.isfinite(got).all() and (got >= 0).all()
    diff = np.abs(to_u8(got).astype(int) - to_u8(want).astype(int))
    assert ((diff <= 2).all(axis=-1)).mean() >= 0.99


# ---------------------------------------------------------------------------
# The oracles on the card against the kernels, the checks, the routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small(cuda, x):
    """bench_scene(3_000)'s geometry, its brute-force hits for the fixture's
    rays and the LBVH over it."""
    from directx_raytracer_tpu_torch.bvh import build_lbvh
    from directx_raytracer_tpu_torch.ops.intersect import intersect_bruteforce

    geo = build_device_scene(testscenes.bench_scene(3_000, W, H), cuda).geometry
    return dict(geo=geo, lbvh=build_lbvh(geo),
                ref=intersect_bruteforce(x["o"], x["d"], geo.woop))


def assert_hits_agree(got, ref, t_rtol=1e-3):
    """The intersection gates against brute force: hit/miss >= 99.9%, same
    winner >= 99%, t within 1e-3 relative on >= 99.9% of common hits."""
    torch.cuda.synchronize()
    assert (got.mask == ref.mask).float().mean() >= 0.999
    both = got.mask & ref.mask
    assert both.sum() > 500
    assert (got.tri[both] == ref.tri[both]).float().mean() >= 0.99
    rel = (got.t[both] - ref.t[both]).abs() / ref.t[both].abs()
    assert (rel <= t_rtol).float().mean() >= 0.999


@pytest.mark.parametrize("route", ["traverse_closest", "intersect_clustered",
                                   "intersect_fused"])
def test_intersectors_agree_with_bruteforce_on_the_card(x, small, route):
    from directx_raytracer_tpu_torch.bvh import (intersect_clustered,
                                                 traverse_closest)

    o, d, bvh = x["o"], x["d"], x["bvh"]
    before = trace.launches()
    if route == "traverse_closest":
        got = traverse_closest(o, d, small["lbvh"], block=2000)
    elif route == "intersect_clustered":
        got = intersect_clustered(o, d, bvh.clusters, block=1536)
    else:
        got = intersect_fused(o, d, bvh.clusters, bvh.wrows, x["tile_r"],
                              crows=bvh.crows)
    assert_hits_agree(got, small["ref"])
    # Only the fused route launches kernels: the oracles are plain torch.
    launched = trace.launches()["closest_hit"] - before["closest_hit"]
    assert launched == (1 if route == "intersect_fused" else 0)


def test_occlusion_oracles_agree_with_any_hit(x, small):
    from directx_raytracer_tpu_torch.bvh import (occluded_clustered,
                                                 traverse_occluded)

    o, d, t_max = shadow_batch(x)
    bvh = x["bvh"]
    blocked = ci.occluded_fused(o, d, bvh.clusters, bvh.wrows, t_max)
    assert blocked.any() and not blocked.all()
    for got in (traverse_occluded(o, d, small["lbvh"], t_max),
                occluded_clustered(o, d, bvh.clusters, t_max)):
        assert (got == blocked).float().mean() >= 0.999


def test_binning_oracle_lists_the_kernels_sets(x):
    from directx_raytracer_tpu_torch.bvh.binning_oracle import bin_clusters

    tile_r = x["tile_r"]
    tiles = x["o"].shape[0] // tile_r
    cs = x["bvh"].clusters
    ids, _, counts = bin_clusters(x["o"].reshape(tiles, tile_r, 3),
                                  x["d"].reshape(tiles, tile_r, 3), cs)
    visit, _, k_counts, _ = ci.bin_lists(x["tp"], x["cb"])
    torch.cuda.synchronize()
    assert torch.equal(counts, k_counts) and counts.sum() > 0
    for tile in range(tiles):
        n = int(counts[tile])
        assert set(ids[tile, :n].tolist()) == set(visit[tile, :n].tolist())


def test_lbvh_on_the_card_equals_the_cpu_build(cuda, small):
    from directx_raytracer_tpu_torch.bvh import build_lbvh

    cpu = build_lbvh(small["geo"].to("cpu"))
    for name in ("order", "left", "skip", "aabb_min", "aabb_max"):
        assert torch.equal(getattr(small["lbvh"], name).cpu(),
                           getattr(cpu, name)), name


def test_checked_frame_on_the_card(cuda, monkeypatch):
    import dataclasses

    from directx_raytracer_tpu_torch.utils import checks

    r = Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=cuda)
    monkeypatch.setenv("DXRT_CHECK", "0")
    unarmed, _ = r.render_whitted_frame(max_depth=3)
    monkeypatch.setenv("DXRT_CHECK", "1")
    armed, _ = r.render_whitted_frame(max_depth=3)
    assert (armed - unarmed).abs().max() <= 1e-6
    intensity = r.dscene.lights.intensity.clone()
    intensity[0] = float("nan")
    r.dscene = dataclasses.replace(r.dscene, lights=dataclasses.replace(
        r.dscene.lights, intensity=intensity))
    with pytest.raises(checks.CheckError, match="non-finite"):
        r.render_whitted_frame(max_depth=3)


def test_cuda_renderer_takes_the_kernels_unless_asked(cuda):
    """use_kernels=None on a CUDA device is the kernels; the walker only
    when asked, and it launches nothing."""
    scene = testscenes.bench_scene(3_000, W, H)
    trace.reset()
    kernels = Renderer(scene, W, H, device=cuda).render_frame(5)
    assert trace.launches()["closest_hit"] == 1
    walker = Renderer(scene, W, H, device=cuda,
                      use_kernels=False).render_frame(5)
    brute = Renderer(scene, W, H, device=cuda, use_bvh=False).render_frame(5)
    torch.cuda.synchronize()
    assert trace.launches()["closest_hit"] == 1
    for other in (walker, brute):
        diff = np.abs(to_u8(kernels).astype(int) - to_u8(other).astype(int))
        assert ((diff <= 2).all(axis=-1)).mean() >= 0.99
