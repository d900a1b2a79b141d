"""Intersection in the torch port vs the JAX package: the brute-force and
hit-record oracles, the binning kernel's plain version, and the fused
binning + cluster walk (plain versions: this suite runs on the CPU).

The JAX side runs as its own CPU tests run it: XLA oracles, and the Pallas
kernels in interpret mode.  Both packages get the same buffers: the JAX
scene, clusters and rays handed over as numpy (``scene_from_numpy``,
``clusters_from_numpy``).  Interpret-mode calls live in module-scoped
fixtures so each runs once."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.bvh import build_bvh as j_build_bvh
from directx_raytracer_tpu.bvh.pallas_intersect import (
    bin_clusters_bits,
    intersect_pallas,
)
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.ops import intersect as jx
from directx_raytracer_tpu.ops.rays import generate_rays_tiled as j_rays_tiled
from directx_raytracer_tpu_torch.bvh import (
    TILE_R,
    build_bvh,
    clusters_from_numpy,
    make_bvh_intersect_fn,
)
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import (
    _woop_transforms,
    scene_from_numpy,
)
from directx_raytracer_tpu_torch.ops import intersect as px
from directx_raytracer_tpu_torch.utils import trace

torch.set_num_threads(2)

W, H, TILE = 96, 48, (24, 32)  # the JAX interpret-mode fixture's frame

# Reference gates of the JAX package's own kernel tests
# (tests/test_pallas_interpret.py:57-68): hit/miss agreement >= 0.999 and
# t within rtol 1e-3 on >= 99.9% of common hits.
HIT_AGREE = 0.999
T_RTOL = 1e-3
T_SHARE = 0.999


def numpy_leaves(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        out[f.name] = x if isinstance(x, (bool, int)) else np.asarray(x)
    return out


def device_scene_leaves(d) -> dict:
    out = {}
    for f in dataclasses.fields(d):
        x = getattr(d, f.name)
        if dataclasses.is_dataclass(x):
            out.update({f"{f.name}.{k}": v for k, v in numpy_leaves(x).items()
                        if k != "accel"})
        else:
            out[f.name] = x if isinstance(x, (bool, int)) else np.asarray(x)
    return out


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def fx():
    scene = jts.bench_scene(3_000, W, H)
    jd = j_build(scene)
    jbvh = j_build_bvh(jd.geometry)
    pos, rot = scene.camera.snapshot()
    jo, jdirs = j_rays_tiled(pos, rot, W, H, *TILE)
    cs = clusters_from_numpy(numpy_leaves(jbvh.clusters), "cpu")
    return SimpleNamespace(
        jd=jd, jbvh=jbvh, jo=jo, jdirs=jdirs, o=to_t(jo), d=to_t(jdirs),
        geo=scene_from_numpy(device_scene_leaves(jd), "cpu").geometry,
        cs=cs, wrows=ci.woop_rows(cs))


@pytest.fixture(scope="module")
def j_brute(fx):
    return jx.intersect_bruteforce(fx.jo, fx.jdirs, fx.jd.geometry.woop)


@pytest.fixture(scope="module")
def j_pallas(fx):
    """The TPU closest-hit kernel in interpret mode (coarse t)."""
    return intersect_pallas(fx.jo, fx.jdirs, fx.jbvh.clusters,
                            fx.jbvh.wplanar, budget=128)


def assert_hits_agree(got: px.Hit, ref, t_rtol=T_RTOL):
    gm, rm = got.tri.numpy() >= 0, np.asarray(ref.tri) >= 0
    assert (gm == rm).mean() >= HIT_AGREE
    both = gm & rm
    assert both.sum() > 100
    close = np.isclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                       rtol=t_rtol)
    assert close.mean() >= T_SHARE


def test_bruteforce_matches_jax(fx, j_brute):
    """Same Woop matmul oracle: winners equal on >= 99.9% of rays, t/u/v
    within 1e-5 (f32 summation order may differ)."""
    got = px.intersect_bruteforce(fx.o, fx.d, fx.geo.woop)
    assert_hits_agree(got, j_brute, t_rtol=1e-5)
    both = (got.tri.numpy() >= 0) & (np.asarray(j_brute.tri) >= 0)
    assert (got.tri.numpy()[both] == np.asarray(j_brute.tri)[both]).mean() >= 0.999
    same = both & (got.tri.numpy() == np.asarray(j_brute.tri))
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(j_brute.u)[same],
                               atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(j_brute.v)[same],
                               atol=1e-5)


def test_hit_record_matches_jax(fx, j_brute):
    """Fed the same hit: ids exactly equal, exact-MT t/u/v within 1e-5."""
    hit = px.Hit(t=to_t(j_brute.t), tri=to_t(j_brute.tri), u=to_t(j_brute.u),
                 v=to_t(j_brute.v))
    refined, loc, mesh, mat, rec = px.hit_record(fx.o, fx.d, fx.geo.packed, hit)
    jref, jloc, jmesh, jmat, jrec = jx.hit_record(
        fx.jo, fx.jdirs, fx.jd.geometry.packed, j_brute)
    for got, want in ((loc, jloc), (mesh, jmesh), (mat, jmat)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rec.numpy().tobytes() == np.asarray(jrec).tobytes()
    m = hit.mask.numpy()
    for got, want in ((refined.t, jref.t), (refined.u, jref.u),
                      (refined.v, jref.v)):
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=1e-5, atol=1e-5)


def test_refine_hit_matches_jax(fx, j_brute):
    hit = px.Hit(t=to_t(j_brute.t), tri=to_t(j_brute.tri), u=to_t(j_brute.u),
                 v=to_t(j_brute.v))
    g, jg = fx.geo, fx.jd.geometry
    got = px.refine_hit(fx.o, fx.d, g.v0, g.e1, g.e2, hit)
    want = jx.refine_hit(fx.jo, fx.jdirs, jg.v0, jg.e1, jg.e2, j_brute)
    m = hit.mask.numpy()
    for a, b in ((got.t, want.t), (got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m],
                                   rtol=1e-5, atol=1e-5)


def unpack_words(words, c):
    words = np.asarray(words).astype(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :c].astype(bool)


def port_bins(fx, tile_r):
    tp = ci.tile_params(fx.o, fx.d, tile_r)
    return ci.bin_clusters_plain(tp, ci.cluster_rows(fx.cs))


@pytest.mark.parametrize("tile_r", [768, 256])
def test_bin_plain_matches_xla_binner(fx, tile_r):
    """Tolerance: none — the same slab ops on the same f32 inputs."""
    tiles = fx.o.shape[0] // tile_r
    words, _, entry, counts = bin_clusters_bits(
        fx.jo.reshape(tiles, tile_r, 3), fx.jdirs.reshape(tiles, tile_r, 3),
        fx.jbvh.clusters, impl="xla")
    got_e, got_o = port_bins(fx, tile_r)
    c = got_o.shape[1]
    want_o = unpack_words(words, c)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_array_equal(got_o.sum(1).numpy(), np.asarray(counts))
    np.testing.assert_array_equal(got_e.numpy()[want_o],
                                  np.asarray(entry)[want_o])


def test_bin_plain_matches_pallas_binner(fx):
    """vs the TPU binning kernel in interpret mode.  Overlap flags equal;
    entries within 1e-6 relative (the kernel's min tree may order NaN-free
    f32 ops differently, which cannot change a min but keeps the gate
    honest)."""
    tiles = fx.o.shape[0] // 768
    words, _, entry, counts = bin_clusters_bits(
        fx.jo.reshape(tiles, 768, 3), fx.jdirs.reshape(tiles, 768, 3),
        fx.jbvh.clusters)
    got_e, got_o = port_bins(fx, 768)
    c = got_o.shape[1]
    want_o = unpack_words(words, c)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_allclose(got_e.numpy()[want_o],
                               np.asarray(entry)[:, :c][want_o], rtol=1e-6)


def test_bin_wrapper_takes_plain_on_cpu(fx):
    tp = ci.tile_params(fx.o, fx.d, 768)
    cb = ci.cluster_rows(fx.cs)
    before = trace.launches()
    for got, want in zip(ci.bin_clusters(tp, cb), ci.bin_clusters_plain(tp, cb)):
        assert torch.equal(got, want)
    assert trace.launches() == before  # plain versions never count


@pytest.mark.parametrize("tile_r", [768, 256])
def test_fused_matches_bruteforce(fx, j_brute, tile_r):
    got = ci.intersect_fused(fx.o, fx.d, fx.cs, fx.wrows, tile_r)
    assert_hits_agree(got, j_brute)
    assert (got.u == 0).all() and (got.v == 0).all()


def test_fused_matches_pallas_kernel(fx, j_pallas):
    got = ci.intersect_fused(fx.o, fx.d, fx.cs, fx.wrows, 768)
    assert_hits_agree(got, j_pallas)


def test_fused_partial_tiles(fx):
    """Ray counts that are not whole tiles are padded with rays that never
    hit; results for the real rays match the JAX brute force."""
    n = fx.o.shape[0] - 100
    got = ci.intersect_fused(fx.o[:n], fx.d[:n], fx.cs, fx.wrows, 256)
    assert got.t.shape == (n,)
    ref = jx.intersect_bruteforce(fx.jo[:n], fx.jdirs[:n],
                                  fx.jd.geometry.woop)
    assert_hits_agree(got, ref)


def test_fused_tiles_with_empty_lists(fx):
    """Tiles whose rays point straight up, out of the scene (the camera is
    above every triangle), bin no cluster; they keep their seeds and miss,
    while the other tiles still hit."""
    tile_r = 256
    d = fx.d.clone().reshape(-1, tile_r, 3)
    d[1::2] = torch.tensor([0.0, 1.0, 0.0])
    d = d.reshape(-1, 3)
    o, dd, _ = ci.pad_and_seed(fx.o, d, fx.cs, tile_r)
    _, _, counts = ci.visit_lists(*port_bins(SimpleNamespace(o=o, d=dd, cs=fx.cs),
                                             tile_r))
    assert (counts[1::2] == 0).all() and (counts[0::2] > 0).any()
    got = ci.intersect_fused(fx.o, d, fx.cs, fx.wrows, tile_r)
    ref = jx.intersect_bruteforce(fx.jo, jnp.asarray(d.numpy()),
                                  fx.jd.geometry.woop)
    assert_hits_agree(got, ref)
    assert (got.tri.reshape(-1, tile_r)[1::2] == -1).all()


def test_visit_lists_sorted_near_to_far(fx):
    entry, overlap = port_bins(fx, 256)
    visit, ventry, counts = ci.visit_lists(entry, overlap)
    assert visit.dtype == torch.int32 and counts.dtype == torch.int32
    assert visit.shape[1] == int(counts.max())
    for t in range(visit.shape[0]):
        n = int(counts[t])
        ids = visit[t, :n].long()
        assert overlap[t, ids].all()
        assert torch.equal(ventry[t, :n], entry[t, ids])
        assert (ventry[t, :n].diff() >= 0).all()
        assert torch.isinf(ventry[t, n:]).all()


@pytest.mark.parametrize("order", [[1, 0], [0, 1]])
def test_closest_tie_goes_to_lower_slot(order):
    """The same triangle in two clusters: the lower slot wins whatever the
    visit order, so the walk's result does not depend on it."""
    k, tile_r = 128, 32
    v0 = np.array([[-1.0, -1.0, 0.0]], np.float32)
    e1 = np.array([[2.0, 0.0, 0.0]], np.float32)
    e2 = np.array([[1.0, 2.0, 0.0]], np.float32)
    woop = np.zeros((2, k, 3, 4), np.float32)
    woop[..., 3] = -1e30  # guaranteed-miss sentinels
    tri = _woop_transforms(v0, e1, e2)[0]
    woop[0, 5], woop[1, 3] = tri, tri
    wrows = torch.from_numpy(woop).reshape(2, k, 12)
    rng = np.random.default_rng(3)
    o = np.zeros((tile_r, 3), np.float32)
    o[:, :2] = rng.uniform(-0.3, 0.3, (tile_r, 2))
    o[:, 2] = 2.0
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (tile_r, 1))
    best_t, best_slot = ci.closest_hit_plain(
        torch.from_numpy(o), torch.from_numpy(d),
        torch.full((tile_r,), 100.0), wrows,
        torch.tensor([order], dtype=torch.int32), torch.zeros((1, 2)),
        torch.tensor([2], dtype=torch.int32), tile_r)
    assert (best_slot == 5).all()
    torch.testing.assert_close(best_t, torch.full((tile_r,), 2.0))


def test_bvh_intersect_fn(fx, j_brute):
    """The renderer-facing closure: (origins, dirs, geometry, tile_r=None)."""
    bvh = build_bvh(fx.geo)
    fn = make_bvh_intersect_fn(bvh)
    assert_hits_agree(fn(fx.o, fx.d, fx.geo), j_brute)
    assert_hits_agree(fn(fx.o, fx.d, fx.geo, tile_r=768), j_brute)
    assert TILE_R == 256
