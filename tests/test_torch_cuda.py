"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: every test skips where there is no CUDA device.  This file
imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: ``bin_clusters`` evaluates the plain version's ops in the same
order with IEEE divides, so it must agree exactly.  ``closest_hit``
contracts a*b+c into FMAs where the plain version rounds twice, so t may
differ by ulps and a hit exactly on an edge may flip: hit/miss agreement
>= 99.9%, same winner >= 99%, t within 1e-5 relative on >= 99.9% of
common hits.
"""

import pytest
import torch

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import TILE_R, build_bvh, intersect_fused
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.debug import render_debug
from directx_raytracer_tpu_torch.render.renderer import Renderer
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


@pytest.mark.parametrize("tile_r", [768, 256, 100])
def test_closest_kernel_matches_plain(x, tile_r):
    n = x["o"].shape[0] // tile_r * tile_r
    o, d, t_init = x["o"][:n], x["d"][:n], x["t_init"][:n]
    tp = ci.tile_params(o, d, tile_r)
    lists = ci.visit_lists(*ci.bin_clusters_plain(tp, x["cb"]))
    args = (o, d, t_init, x["bvh"].wrows, *lists, tile_r)
    bt_k, bs_k = ci.closest_hit(*args)
    bt_p, bs_p = ci.closest_hit_plain(*args)
    torch.cuda.synchronize()
    hk, hp = bs_k >= 0, bs_p >= 0
    assert (hk == hp).float().mean() >= 0.999
    both = hk & hp
    assert both.sum() > 100
    assert (bs_k[both] == bs_p[both]).float().mean() >= 0.99
    rel = (bt_k[both] - bt_p[both]).abs() / bt_p[both]
    assert (rel <= 1e-5).float().mean() >= 0.999


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
    assert all(ci.LAUNCHES[k] > before[k] for k in before)

    def plain_fn(o, d, geo, tile_r=None):
        return intersect_fused(o, d, r.bvh.clusters, r.bvh.wrows,
                               tile_r or TILE_R, plain=True)

    pos, rot = r.camera.snapshot()
    ref = render_debug(r.dscene, pos, rot, 5, W, H, intersect_fn=plain_fn,
                       fetch_record=False)
    diff = (to_u8(img).astype(int) - to_u8(ref).astype(int))
    assert ((abs(diff) <= 2).all(axis=-1)).mean() >= 0.99
