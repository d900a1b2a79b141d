"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: every test skips where there is no CUDA device.  This file
imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the binning kernels (dense and superblock) evaluate the plain
version's ops in the same order with IEEE divides, so they must agree
exactly.  ``closest_hit`` contracts a*b+c into FMAs where the plain version
rounds twice, so t may differ by ulps and a hit exactly on an edge may
flip: hit/miss agreement >= 99.9%, same winner >= 99%, t within 1e-5
relative on >= 99.9% of common hits.  ``any_hit`` contracts the same way:
blocked flags agree on >= 99.9% of rays (the reference's occlusion gate).
Whitted frames: within 2 u8 levels on >= 99% of pixels, alive per pass
within 0.1% of the pixel count.  ``precision_fold``: identical sentinel
sets and each ray's min t within 1e-3 relative (the repository's t gate,
bench.py:156-164) on >= 99.5% of rays: kernel and plain version sum the
depth-8 products in different orders, and the tail's cancellation
amplifies that to ~1e-4 relative on the winning t.
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
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.render.whitted import render_whitted
from directx_raytracer_tpu_torch.tools import precision_micro as pm
from directx_raytracer_tpu_torch.utils.image import to_u8

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


def test_bin_kernel_matches_plain(x):
    entry, overlap = ci.bin_clusters(x["tp"], x["cb"])
    torch.cuda.synchronize()
    assert torch.equal(overlap, x["overlap"])
    assert torch.equal(entry[overlap], x["entry"][overlap])


def closest_vs_plain(x, tile_r, chunk=ci.CLOSEST_CHUNK):
    n = x["o"].shape[0] // tile_r * tile_r
    o, d, t_init = x["o"][:n], x["d"][:n], x["t_init"][:n]
    tp = ci.tile_params(o, d, tile_r)
    lists = ci.visit_lists(*ci.bin_clusters_plain(tp, x["cb"]))
    args = (o, d, t_init, x["bvh"].wrows, *lists, tile_r)
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


@pytest.mark.parametrize("tile_r", [768, 256, 100])
def test_closest_kernel_matches_plain(x, tile_r):
    closest_vs_plain(x, tile_r)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("tile_r", [768, 256, 100])
def test_closest_kernel_split_lists_match_plain(x, tile_r, chunk):
    """Lists cut into work items of 1 or 3 positions, merged by the
    packed-key atomicMin: the same gates against the plain walk."""
    closest_vs_plain(x, tile_r, chunk)


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
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in (
        torch.from_numpy(o), torch.from_numpy(d), t.contiguous(),
        torch.from_numpy(woop).reshape(2, k, 12),
        torch.tensor([order], dtype=torch.int32), torch.zeros((1, 2)),
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
    before = dict(ci.LAUNCHES)
    ci.bin_clusters(x["tp"], x["cb"])
    ci.closest_hit(x["o"], x["d"], x["t_init"], x["bvh"].wrows, *x["lists"],
                   x["tile_r"])
    ci.bin_clusters_plain(x["tp"], x["cb"])
    assert ci.LAUNCHES["bin_clusters"] == before["bin_clusters"] + 1
    assert ci.LAUNCHES["closest_hit"] == before["closest_hit"] + 1


def test_wrappers_reject_bad_operands(x):
    with pytest.raises(ValueError):
        ci.bin_clusters(x["tp"].double(), x["cb"])
    with pytest.raises(ValueError):
        ci.bin_clusters(x["tp"], x["cb"].T.contiguous().T)  # not contiguous
    with pytest.raises(ValueError):
        ci.bin_clusters(x["tp"], x["cb"].cpu())
    args = [x["o"], x["d"], x["t_init"], x["bvh"].wrows, *x["lists"]]
    with pytest.raises(ValueError):
        ci.closest_hit(*args, 1024)  # more rays per tile than the CTA holds
    with pytest.raises(ValueError):
        ci.closest_hit(*args[:4], args[4].long(), *args[5:], x["tile_r"])


def test_frame_matches_plain(cuda):
    """Mode 5 through the Renderer (kernels) vs render_debug through the
    plain versions: within 2 u8 levels on >= 99% of pixels."""
    r = Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=cuda)
    before = dict(ci.LAUNCHES)
    img = r.render_frame(5)
    assert all(ci.LAUNCHES[k] > before[k] for k in ("bin_clusters",
                                                    "closest_hit"))

    def plain_fn(o, d, geo, tile_r=None):
        return intersect_fused(o, d, r.bvh.clusters, r.bvh.wrows,
                               tile_r or TILE_R, plain=True)

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
                          x["tile_r"], plain=True)
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
    before = ci.LAUNCHES["any_hit"]
    got = ci.any_hit(*args)
    assert ci.LAUNCHES["any_hit"] == before + 1
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
    before = ci.LAUNCHES["bin_clusters_super"]
    entry, overlap = ci.bin_clusters_super(x["tp"], x["cb"], sb, block)
    assert ci.LAUNCHES["bin_clusters_super"] == before + 1
    e_p, o_p = ci.bin_clusters_super_plain(x["tp"], x["cb"], sb, block)
    e_d, o_d = ci.bin_clusters_dense(x["tp"], x["cb"])
    torch.cuda.synchronize()
    assert torch.equal(overlap, o_p) and torch.equal(entry, e_p)
    assert torch.equal(overlap, o_d)
    assert torch.equal(entry[o_d], e_d[o_d])


def test_whitted_frame_matches_plain(cuda):
    """A depth-3 Whitted frame through the Renderer (kernels) vs the same
    frame through the plain versions on the card."""
    r = Renderer(testscenes.bench_scene(3_000, W, H), W, H, device=cuda)
    before = dict(ci.LAUNCHES)
    img, stats = r.render_whitted_frame(max_depth=3)
    for name in ("bin_clusters", "closest_hit", "any_hit"):
        assert ci.LAUNCHES[name] > before[name], name

    def plain_isect(o, d, geo, tile_r=None):
        return intersect_fused(o, d, r.bvh.clusters, r.bvh.wrows,
                               tile_r or TILE_R, plain=True)

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
    before = pm.LAUNCHES[variant]
    got = pm.min_t(pm.precision_fold(variant, w, rays))
    assert pm.LAUNCHES[variant] == before + 1
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
