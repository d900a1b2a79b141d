"""Occlusion and superblock binning in the torch port vs the JAX package:
the any-hit oracles (``occluded_bruteforce``, ``moller_trumbore``), the
any-hit walk's plain version through ``occluded_fused``, and the
superblock binner's plain version (this suite runs on the CPU).

The JAX side runs as its own CPU tests run it: XLA oracles, and the Pallas
kernels in interpret mode (module-scoped fixtures, so each runs once).  Both
packages get the same buffers: the JAX clusters and rays handed over as
numpy.

Tolerances: occlusion verdicts agree on >= 99.9% of rays, the reference's
own occlusion gate (tests/test_pallas_interpret.py:77); binning overlaps
are equal on every pair and entries within 1e-6 relative where both
overlap (the JAX superblock test's gate); Möller-Trumbore t/u/v within
1e-5 (f32 evaluation order)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.bvh import build_bvh as j_build_bvh
from directx_raytracer_tpu.bvh import pallas_intersect as jpi
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.ops import intersect as jx
from directx_raytracer_tpu.ops.rays import generate_rays_tiled as j_rays_tiled
from directx_raytracer_tpu_torch.bvh import (
    build_bvh,
    clusters_from_numpy,
    make_bvh_occluder_factory,
)
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.ops import intersect as px
from directx_raytracer_tpu_torch.utils import trace
from test_torch_intersect import numpy_leaves

torch.set_num_threads(2)

W, H, TILE = 96, 48, (24, 32)  # the JAX interpret-mode fixture's frame
AGREE = 0.999
N_PARTIAL = W * H - 100  # not a multiple of 256


def t_max_cases(n: int) -> dict:
    i = np.arange(n)
    return {
        "t25": np.full(n, 25.0, np.float32),
        "t2": np.full(n, 2.0, np.float32),
        "t8": np.full(n, 8.0, np.float32),
        "mixed": np.where(i % 2 == 0, 3.0, 30.0).astype(np.float32),
        "disarmed": np.zeros(n, np.float32),
    }


@pytest.fixture(scope="module")
def fx():
    scene = jts.bench_scene(3_000, W, H)
    jd = j_build(scene)
    jbvh = j_build_bvh(jd.geometry)
    pos, rot = scene.camera.snapshot()
    jo, jdirs = j_rays_tiled(pos, rot, W, H, *TILE)
    cs = clusters_from_numpy(numpy_leaves(jbvh.clusters), "cpu")
    return SimpleNamespace(
        jd=jd, jbvh=jbvh, jo=jo, jdirs=jdirs,
        o=torch.from_numpy(np.array(jo)), d=torch.from_numpy(np.array(jdirs)),
        cs=cs, wrows=ci.woop_rows(cs), crows=ci.cull_rows(ci.woop_rows(cs)),
        cb=ci.cluster_rows(cs))


@pytest.fixture(scope="module")
def j_occ(fx):
    """JAX brute force and interpret-mode occluded_pallas(budget=128) per
    t_max case, plus the partial batch (t_max 25 on the first N_PARTIAL
    rays)."""
    out = {}
    woop = fx.jd.geometry.woop
    for name, tm in t_max_cases(fx.o.shape[0]).items():
        tm = jnp.asarray(tm)
        out[name] = (
            np.asarray(jx.occluded_bruteforce(fx.jo, fx.jdirs, woop, tm)),
            np.asarray(jpi.occluded_pallas(fx.jo, fx.jdirs, fx.jbvh.clusters,
                                           fx.jbvh.wplanar, tm, budget=128)))
    o, d = fx.jo[:N_PARTIAL], fx.jdirs[:N_PARTIAL]
    tm = jnp.full((N_PARTIAL,), 25.0)
    out["partial"] = (
        np.asarray(jx.occluded_bruteforce(o, d, woop, tm)),
        np.asarray(jpi.occluded_pallas(o, d, fx.jbvh.clusters,
                                       fx.jbvh.wplanar, tm, budget=128)))
    return out


def case_inputs(fx, name):
    if name == "partial":
        return (fx.o[:N_PARTIAL], fx.d[:N_PARTIAL],
                torch.full((N_PARTIAL,), 25.0))
    return fx.o, fx.d, torch.from_numpy(t_max_cases(fx.o.shape[0])[name])


CASES = ["t25", "t2", "t8", "mixed", "disarmed", "partial"]


@pytest.mark.parametrize("name", CASES)
def test_occluded_fused_matches_jax(fx, j_occ, name):
    """The any-hit schedule + plain walk against JAX brute force and the
    TPU any-hit kernel in interpret mode."""
    o, d, tm = case_inputs(fx, name)
    got = ci.occluded_fused(o, d, fx.cs, fx.wrows, fx.crows, tm,
                            plain=True).numpy()
    brute, pallas = j_occ[name]
    assert got.shape == brute.shape == (o.shape[0],)
    assert (got == brute).mean() >= AGREE
    assert (got == pallas).mean() >= AGREE
    if name == "t25":
        assert brute.sum() > 100  # the case really blocks rays
    if name == "disarmed":
        assert not got.any()


def test_occluded_wrapper_takes_plain_on_cpu(fx):
    tm = torch.full((fx.o.shape[0],), 25.0)
    before = trace.launches()
    got = ci.occluded_fused(fx.o, fx.d, fx.cs, fx.wrows, fx.crows, tm)
    want = ci.occluded_fused(fx.o, fx.d, fx.cs, fx.wrows, fx.crows, tm,
                             plain=True)
    assert torch.equal(got, want)
    assert trace.launches() == before  # plain versions never count


def test_disarmed_tiles_bin_nothing(fx):
    """t_max = 0 everywhere: every tile's cap lies below t_min, so no tile
    bins a cluster and the walk visits none."""
    o, d, tm, t_cap = ci.pad_and_cap(fx.o, fx.d, torch.zeros(fx.o.shape[0]),
                                     ci.TILE_R)
    entry, overlap = ci.bin_clusters_plain(
        ci.tile_params(o, d, ci.TILE_R, t_cap=t_cap), fx.cb)
    visit, _, counts = ci.visit_lists(entry, overlap)
    assert (counts == 0).all() and visit.shape[1] == 0


def test_tiles_bound_armed_lanes_only(fx):
    """A tile mixing armed rays with parked ones (origin 1e30, t_max 0)
    bins only what its armed rays can reach; the verdicts stay those of
    the JAX brute force."""
    n = fx.o.shape[0]
    armed = torch.arange(n) % ci.TILE_R < 100  # 100 armed lanes per tile
    o = torch.where(armed[:, None], fx.o, 1e30)
    d = torch.where(armed[:, None], fx.d, 1.0)
    tm = torch.where(armed, 25.0, 0.0)
    _, _, _, t_cap = ci.pad_and_cap(o, d, tm, ci.TILE_R)
    tight = ci.bin_clusters_plain(
        ci.tile_params(o, d, ci.TILE_R, t_cap=t_cap, live=tm > 1e-3), fx.cb)[1]
    wide = ci.bin_clusters_plain(
        ci.tile_params(o, d, ci.TILE_R, t_cap=t_cap), fx.cb)[1]
    assert (tight <= wide).all() and tight.sum() < wide.sum()
    got = ci.occluded_fused(o, d, fx.cs, fx.wrows, fx.crows, tm,
                            plain=True).numpy()
    want = np.asarray(jx.occluded_bruteforce(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), fx.jd.geometry.woop,
        jnp.asarray(tm.numpy())))
    assert (got == want).mean() >= AGREE and want.sum() > 50


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_anyhit_work_items_cover_each_list_once(chunk):
    counts = torch.tensor([0, 5, 16, 17, 0, 1, 40], dtype=torch.int32)
    tile, start = ci.anyhit_work_items(counts, chunk)
    assert tile.dtype == start.dtype == torch.int32
    covered = {(int(t), p) for t, s in zip(tile, start)
               for p in range(int(s), min(int(s) + chunk, int(counts[t])))}
    want = {(t, p) for t in range(len(counts)) for p in range(int(counts[t]))}
    assert covered == want
    assert len(tile) == sum(-(-int(c) // chunk) for c in counts)


def test_pad_and_cap_parks_the_tail(fx):
    o, d, tm, t_cap = ci.pad_and_cap(fx.o[:N_PARTIAL], fx.d[:N_PARTIAL],
                                     torch.full((N_PARTIAL,), 25.0), ci.TILE_R)
    assert o.shape[0] == W * H and o.shape[0] % ci.TILE_R == 0
    assert (o[N_PARTIAL:] == 1e30).all() and (d[N_PARTIAL:] == 1.0).all()
    assert (tm[N_PARTIAL:] == 0.0).all()
    torch.testing.assert_close(
        t_cap, torch.full_like(t_cap, 25.0 * (1.0 + 2.0 ** -11) + 1e-7))


def test_disarmed_lanes_stay_unblocked(fx):
    """Lanes with t_max <= t_min are never blocked, even in tiles whose
    other lanes are armed and blocked."""
    tm = torch.where(torch.arange(fx.o.shape[0]) % 2 == 0, 25.0, 0.0)
    got = ci.occluded_fused(fx.o, fx.d, fx.cs, fx.wrows, fx.crows, tm,
                            plain=True)
    assert not got[1::2].any() and got[0::2].sum() > 50


def test_plain_walks_count_their_work(fx):
    """``stats`` of the plain walks: the (tile, cluster) pairs the
    early-out leaves and the (ray, triangle) tests they need (for the
    closest-hit walk also those of the 32-ray groups its cull keeps, one
    group of 32 rays for each of its count's tested groups), without
    changing the result."""
    k = fx.wrows.shape[1]
    o, d, t_init = ci.pad_and_seed(fx.o, fx.d, fx.cs, ci.TILE_R)
    visit, ventry, counts = ci.visit_lists(*ci.bin_clusters_plain(
        ci.tile_params(o, d, ci.TILE_R), fx.cb))
    args = (o, d, t_init, fx.wrows, ci.cull_rows(fx.wrows), visit, ventry,
            counts, ci.TILE_R)
    stats = {}
    got = ci.closest_hit_plain(*args, stats=stats)
    for a, b in zip(got, ci.closest_hit_plain(*args)):
        assert torch.equal(a, b)
    assert 0 < stats["visits"] < int(counts.sum())  # the early-out bites
    assert stats["tests"] == stats["visits"] * ci.TILE_R * k
    assert 0 < stats["kept_tests"] < stats["tests"]  # the cull bites
    tested = ci.closest_hit_plain(*args, count_exec=True)[3]
    assert stats["kept_tests"] == int(tested.sum()) * ci.CULL_GROUP * k

    tm = torch.where(torch.arange(fx.o.shape[0]) % 2 == 0, 25.0, 0.0)
    args = ci.anyhit_schedule(fx.o, fx.d, tm, fx.cs, fx.wrows, fx.crows)
    stats = {}
    got = ci.any_hit_plain(*args, stats=stats)
    assert torch.equal(got, ci.any_hit_plain(*args))
    assert 0 < stats["visits"] <= int(args[7].sum())
    # at most half the lanes are armed
    assert 0 < stats["tests"] <= stats["visits"] * ci.TILE_R // 2 * k


def test_occluder_factory(fx):
    """The renderer-facing closure: factory(geometry) -> (o, d, max_t)."""
    geo = build_device_scene(pts.bench_scene(3_000, W, H), "cpu").geometry
    occluded = make_bvh_occluder_factory(build_bvh(geo))(geo)
    tm = torch.full((fx.o.shape[0],), 25.0)
    want = px.occluded_bruteforce(fx.o, fx.d, geo.woop, tm)
    assert (occluded(fx.o, fx.d, tm) == want).float().mean() >= AGREE


def test_bruteforce_occlusion_matches_jax(fx, j_occ):
    for name in ("t25", "mixed"):
        got = px.occluded_bruteforce(
            fx.o, fx.d, torch.from_numpy(np.array(fx.jd.geometry.woop)),
            torch.from_numpy(t_max_cases(fx.o.shape[0])[name])).numpy()
        assert (got == j_occ[name][0]).mean() >= AGREE


def test_moller_trumbore_matches_jax():
    rng = np.random.default_rng(11)
    n = 2000
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    target = v0 + 0.4 * e1 + 0.3 * e2 + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    jt, ju, jv, jhit = jax.vmap(jx.moller_trumbore)(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(e1),
        jnp.asarray(e2))
    t, u, v, hit = px.moller_trumbore(*(torch.from_numpy(x)
                                        for x in (o, d, v0, e1, e2)))
    assert 0.2 < hit.float().mean() < 0.9
    assert (hit.numpy() == np.asarray(jhit)).mean() >= AGREE
    for got, want in ((t, jt), (u, ju), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Superblock binning
# ---------------------------------------------------------------------------


def test_super_rows_must_match_block(fx):
    tp = ci.tile_params(fx.o, fx.d, ci.TILE_R)
    with pytest.raises(ValueError):
        ci.bin_clusters_super_plain(tp, fx.cb, ci.super_rows(fx.cb, 8),
                                    block=32)
    with pytest.raises(ValueError):
        ci.bin_lists(tp, fx.cb, ci.super_rows(fx.cb, 8), mode="super", block=32)


def test_super_rows_match_jax(fx, monkeypatch):
    """Hull rows equal the JAX ``planar_super_rows`` on the real lanes
    (JAX pads lanes to 128; the port does not)."""
    monkeypatch.setattr(jpi, "SUPER_BLOCK", 8)
    want = np.asarray(jpi.planar_super_rows(
        jpi.planar_cluster_rows(fx.jbvh.clusters)))
    got = ci.super_rows(fx.cb, block=8).numpy()
    s = got.shape[1]
    assert s == -(-fx.cb.shape[1] // 8) and s > 1
    np.testing.assert_array_equal(got, want[:, :s])


@pytest.mark.parametrize("block", [32, 8])
@pytest.mark.parametrize("tile_r", [768, 256])
def test_super_plain_matches_dense_plain(fx, block, tile_r):
    """Same overlaps as the dense binner; equal entries where they
    overlap, BIG in skipped superblocks."""
    tp = ci.tile_params(fx.o, fx.d, tile_r)
    e_d, o_d = ci.bin_clusters_plain(tp, fx.cb)
    e_s, o_s = ci.bin_clusters_super_plain(
        tp, fx.cb, ci.super_rows(fx.cb, block), block)
    assert torch.equal(o_s, o_d)
    assert torch.equal(e_s[o_d], e_d[o_d])
    assert ((e_s == ci.BIG) | o_d | (e_s == e_d)).all()
    if block == 8:
        assert (e_s == ci.BIG).any()  # some tile really skips a superblock


def test_super_plain_matches_jax_super_binner(fx, monkeypatch):
    """vs JAX ``bin_clusters_bits`` through its superblock kernel (interpret
    mode, SUPER_MIN_C / SUPER_BLOCK patched as the JAX test patches them):
    overlaps equal on every pair, entries within 1e-6 where overlapping."""
    monkeypatch.setattr(jpi, "SUPER_MIN_C", 1)
    monkeypatch.setattr(jpi, "SUPER_BLOCK", 32)
    tiles = fx.o.shape[0] // ci.TILE_R
    words, _, entry, counts = jpi.bin_clusters_bits(
        fx.jo.reshape(tiles, ci.TILE_R, 3),
        fx.jdirs.reshape(tiles, ci.TILE_R, 3), fx.jbvh.clusters)
    tp = ci.tile_params(fx.o, fx.d, ci.TILE_R)
    got_e, got_o = ci.bin_clusters_super_plain(
        tp, fx.cb, ci.super_rows(fx.cb, 32), 32)
    c = got_o.shape[1]
    bits = (np.asarray(words).astype(np.uint32)[:, :, None]
            >> np.arange(32, dtype=np.uint32)) & 1
    want_o = bits.reshape(tiles, -1)[:, :c].astype(bool)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_array_equal(got_o.sum(1).numpy(), np.asarray(counts))
    np.testing.assert_allclose(got_e.numpy()[want_o],
                               np.asarray(entry)[:, :c][want_o], rtol=1e-6)


def test_bin_dispatch_by_cluster_count(fx, monkeypatch):
    """``bin_clusters`` runs the dense binner below SUPER_MIN_C clusters and
    the superblock binner from there on; the fused queries give the same
    answers either way."""
    tp = ci.tile_params(fx.o, fx.d, ci.TILE_R)
    dense = ci.bin_clusters(tp, fx.cb)
    hit_dense = ci.intersect_fused(fx.o, fx.d, fx.cs, fx.wrows)
    tm = torch.full((fx.o.shape[0],), 25.0)
    occ_dense = ci.occluded_fused(fx.o, fx.d, fx.cs, fx.wrows, fx.crows, tm)
    monkeypatch.setattr(ci, "SUPER_MIN_C", 1)
    e_s, o_s = ci.bin_clusters(tp, fx.cb, ci.super_rows(fx.cb))
    assert torch.equal(o_s, dense[1])
    assert torch.equal(e_s[o_s], dense[0][o_s])
    assert torch.equal(ci.bin_clusters(tp, fx.cb)[1], dense[1])
    hit = ci.intersect_fused(fx.o, fx.d, fx.cs, fx.wrows)
    assert torch.equal(hit.tri, hit_dense.tri) and torch.equal(hit.t, hit_dense.t)
    assert torch.equal(
        ci.occluded_fused(fx.o, fx.d, fx.cs, fx.wrows, fx.crows, tm), occ_dense)
