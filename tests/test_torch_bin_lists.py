"""The fused binning layer (``bin_lists``) on the CPU: its plain version
against the (T, C) reference it replaces (``visit_lists`` of
``bin_clusters``), against the JAX package's ``bin_clusters_bits(impl=
"xla")`` overlap words, the walks on the kernel's stride-C lists, and the
kernel's sorting networks emulated index for index.

The cases: the 3k interpret-mode fixture's primary tiles (768 and 256
rays), tiles whose entries tie at t_min (origins inside the scene), a
t_cap edge, parked tiles (origin 1e30: they bin nothing), a superblock
case at exactly ``SUPER_MIN_C`` clusters, and a tile listing thousands of
clusters.  Tolerance: none anywhere — the same slab ops on the same f32
inputs, and one total order (entry, then cluster id)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu.bvh.pallas_intersect import bin_clusters_bits
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.ops.rays import T_MIN
from directx_raytracer_tpu_torch.utils import trace
from test_torch_intersect import fx, unpack_words  # noqa: F401  (fixture)

torch.set_num_threads(2)


def lists_equal(got, want):
    """``bin_lists_plain``'s result against ``visit_lists``': every
    position of every row, entries compared as bits."""
    visit, ventry, counts, width = got
    w_visit, w_ventry, w_counts = want
    assert visit.dtype == torch.int32 and ventry.dtype == torch.float32
    assert width == visit.shape[1] == w_visit.shape[1]
    assert torch.equal(counts, w_counts)
    assert torch.equal(visit, w_visit)
    assert torch.equal(ventry.view(torch.int32), w_ventry.view(torch.int32))


def primary_params(fx, tile_r):
    o, d, _ = ci.pad_and_seed(fx.o, fx.d, fx.cs, tile_r)
    return ci.tile_params(o, d, tile_r)


def tie_params(fx):
    """768-ray tiles, every other one with its origin box moved into the
    middle of the scene: the clusters around it are entered at once, so
    their entries clamp to t_min and tie."""
    tp = primary_params(fx, 768)
    valid = fx.cs.valid[:, None]
    lo = torch.where(valid, fx.cs.aabb_min, float("inf")).amin(0)
    hi = torch.where(valid, fx.cs.aabb_max, -float("inf")).amax(0)
    mid, half = (lo + hi) / 2, (hi - lo) / 8
    tp[::2, 0:3] = mid - half
    tp[::2, 3:6] = mid + half
    return tp


def parked_params(fx):
    """256-ray tiles, the odd ones all parked rays (origin 1e30, dir 1)."""
    o, d, _ = ci.pad_and_seed(fx.o, fx.d, fx.cs, 256)
    o, d = o.reshape(-1, 256, 3).clone(), d.reshape(-1, 256, 3).clone()
    o[1::2], d[1::2] = 1e30, 1.0
    return ci.tile_params(o.reshape(-1, 3), d.reshape(-1, 3), 256)


def random_rows(fx, c, seed, size=0.05):
    """(8, c) cluster rows of random boxes spread over the fixture scene's
    box (about 5% invalid), so the fixture's rays overlap some of them."""
    rng = np.random.default_rng(seed)
    valid = fx.cs.valid[:, None]
    lo = torch.where(valid, fx.cs.aabb_min, float("inf")).amin(0).numpy()
    hi = torch.where(valid, fx.cs.aabb_max, -float("inf")).amax(0).numpy()
    ext = hi - lo
    box_lo = lo[:, None] + rng.uniform(0, 1, (3, c)) * ext[:, None]
    box_hi = box_lo + rng.uniform(0.2, 1, (3, c)) * size * ext[:, None]
    cb = np.zeros((8, c), np.float32)
    cb[0:3], cb[3:6] = box_lo, box_hi
    cb[6] = rng.uniform(0, 1, c) > 0.05
    return torch.from_numpy(cb)


CASES = ["primary768", "primary256", "ties", "parked"]


def case_params(fx, name):
    return {"primary768": lambda: primary_params(fx, 768),
            "primary256": lambda: primary_params(fx, 256),
            "ties": lambda: tie_params(fx),
            "parked": lambda: parked_params(fx)}[name]()


@pytest.mark.parametrize("name", CASES)
def test_plain_lists_equal_visit_lists(fx, name):
    tp = case_params(fx, name)
    cb = ci.cluster_rows(fx.cs)
    got = ci.bin_lists_plain(tp, cb)
    lists_equal(got, ci.visit_lists(*ci.bin_clusters(tp, cb)))
    visit, ventry, counts, width = got
    assert width > 0
    if name == "ties":
        at_min = (ventry == tp[:, 13:14]) & (torch.arange(width) < counts[:, None])
        assert at_min.sum(dim=1).max() >= 2  # a tile's entries really tie
        for t in range(tp.shape[0]):  # ties go to the lower cluster id
            n = int(counts[t])
            same = ventry[t, 1:n] == ventry[t, :n - 1]
            assert (visit[t, 1:n][same] > visit[t, :n - 1][same]).all()
    if name == "parked":
        assert (counts[1::2] == 0).all() and (counts[0::2] > 0).any()
    # The wrapper takes the plain version on the CPU, in either mode.
    lists_equal(ci.bin_lists(tp, cb), got[:3])
    lists_equal(ci.bin_lists(tp, cb, mode="super", block=4), got[:3])


def test_t_cap_edge(fx):
    """A cluster entered exactly at t_cap is listed; one ulp lower, it is
    not — in the plain lists as in the (T, C) reference."""
    tp = primary_params(fx, 256)
    cb = ci.cluster_rows(fx.cs)
    visit, ventry, counts, _ = ci.bin_lists_plain(tp, cb)
    t = int(torch.argmax(counts))
    n = int(counts[t])
    e = ventry[t, n // 2]
    assert e > T_MIN
    tp[t, 14] = e
    at = ci.bin_lists_plain(tp, cb)
    lists_equal(at, ci.visit_lists(*ci.bin_clusters(tp, cb)))
    listed = int((ventry[t, :n] <= e).sum())
    assert int(at[2][t]) == listed
    assert visit[t, n // 2] in at[0][t, :listed]
    tp[t, 14] = float(np.nextafter(np.float32(e), np.float32(-np.inf)))
    below = ci.bin_lists_plain(tp, cb)
    lists_equal(below, ci.visit_lists(*ci.bin_clusters(tp, cb)))
    assert int(below[2][t]) == int((ventry[t, :n] < e).sum()) < listed


def test_superblock_case_at_super_min_c(fx):
    """Exactly ``SUPER_MIN_C`` clusters: ``bin_lists`` takes the superblock
    mode, and its lists equal the dense mode's and the reference's."""
    cb = random_rows(fx, ci.SUPER_MIN_C, seed=1)
    tp = primary_params(fx, 256)
    got = ci.bin_lists(tp, cb)
    want = ci.visit_lists(*ci.bin_clusters(tp, cb))
    lists_equal(got, want)
    lists_equal(ci.bin_lists(tp, cb, mode="dense"), want)
    lists_equal(ci.bin_lists_plain(tp, cb), want)
    assert got[3] > 0
    entry, _ = ci.bin_clusters(tp, cb)
    assert (entry == ci.BIG).any()  # some tile really skips a superblock


def test_a_tile_listing_thousands(fx):
    """One tile whose origin box spans the scene lists nearly every one of
    5,000 clusters (more than the kernel's shared buffer holds), most of
    them tied at t_min: still one total order."""
    cb = random_rows(fx, 5_000, seed=2)
    tp = primary_params(fx, 256)
    tp[0, 0:3] = cb[0:3].amin(1) - 1.0
    tp[0, 3:6] = cb[3:6].amax(1) + 1.0
    got = ci.bin_lists(tp, cb)
    lists_equal(got, ci.visit_lists(*ci.bin_clusters(tp, cb)))
    assert int(got[2][0]) == int((cb[6] > 0.5).sum()) > 2048


@pytest.mark.parametrize("tile_r,capped", [(768, False), (256, False),
                                           (256, True)])
def test_lists_match_jax_overlap_words(fx, tile_r, capped):
    """Counts and each tile's set of clusters equal the JAX binner's
    overlap words on the same numpy inputs; entries equal its entries."""
    tiles = fx.o.shape[0] // tile_r
    t_cap = None
    if capped:
        t_cap = np.random.default_rng(4).uniform(5, 25, tiles).astype(np.float32)
    words, _, entry, counts = bin_clusters_bits(
        fx.jo.reshape(tiles, tile_r, 3), fx.jdirs.reshape(tiles, tile_r, 3),
        fx.jbvh.clusters, impl="xla",
        t_cap=None if t_cap is None else jnp.asarray(t_cap))
    tp = ci.tile_params(fx.o, fx.d, tile_r,
                        t_cap=None if t_cap is None else torch.from_numpy(t_cap))
    visit, ventry, got_counts, _ = ci.bin_lists_plain(tp, ci.cluster_rows(fx.cs))
    c = fx.cs.aabb_min.shape[0]
    want = unpack_words(words, c)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(counts))
    entry = np.asarray(entry)
    for t in range(tiles):
        n = int(got_counts[t])
        ids = visit[t, :n].numpy()
        assert set(ids.tolist()) == set(np.flatnonzero(want[t]).tolist())
        np.testing.assert_array_equal(ventry[t, :n].numpy(), entry[t, ids])
    if capped:
        assert (got_counts < ci.bin_lists_plain(
            ci.tile_params(fx.o, fx.d, tile_r), ci.cluster_rows(fx.cs))[2]).any()


def poisoned(visit, ventry, counts, stride):
    """The lists at row stride ``stride`` with every position past a
    tile's count poisoned (NaN entry, cluster id -1), where the kernel
    leaves its rows unwritten."""
    tiles, width = visit.shape
    v = torch.full((tiles, stride), -1, dtype=torch.int32)
    e = torch.full((tiles, stride), float("nan"))
    mine = torch.arange(width) < counts[:, None]
    v[:, :width] = torch.where(mine, visit, -1)
    e[:, :width] = torch.where(mine, ventry, float("nan"))
    return v, e


def test_walks_read_nothing_past_counts(fx):
    """closest_hit_plain and any_hit_plain give identical results on the
    compact lists and on stride-C lists whose tails are poisoned."""
    tile_r = 256
    cb = ci.cluster_rows(fx.cs)
    c = cb.shape[1]
    o, d, t_init = ci.pad_and_seed(fx.o, fx.d, fx.cs, tile_r)
    visit, ventry, counts, width = ci.bin_lists(ci.tile_params(o, d, tile_r), cb)
    # The 3k scene has 19 clusters and a tile may list all of them: a
    # stride past C gives every row a poisoned tail.
    stride = poisoned(visit, ventry, counts, c + 5)
    crows = ci.cull_rows(fx.wrows)
    want = ci.closest_hit_plain(o, d, t_init, fx.wrows, crows, visit, ventry,
                                counts, tile_r)
    got = ci.closest_hit(o, d, t_init, fx.wrows, crows, *stride, counts,
                         tile_r, width=width)
    assert (want[1] >= 0).sum() > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    tm = torch.where(torch.arange(fx.o.shape[0]) % 3 == 0, 0.0, 25.0)
    o, d, tm, visit, ventry, counts = ci.anyhit_schedule(fx.o, fx.d, tm, fx.cs)
    want = ci.any_hit_plain(o, d, tm, fx.wrows, visit, ventry, counts, tile_r)
    got = ci.any_hit(o, d, tm, fx.wrows,
                     *poisoned(visit, ventry, counts, c + 5), counts, tile_r)
    assert want.any() and torch.equal(got, want)


def test_bin_lists_modes(fx):
    tp = primary_params(fx, 768)
    cb = ci.cluster_rows(fx.cs)
    with pytest.raises(ValueError):
        ci.bin_lists(tp, cb, mode="sparse")
    with pytest.raises(ValueError):  # hull rows of another block size
        ci.bin_lists(tp, cb, ci.super_rows(cb, 8), mode="super", block=4)
    before = trace.launches()
    ci.bin_lists(tp, cb, mode="super", block=8)
    assert trace.launches() == before  # plain versions never count


# ---------------------------------------------------------------------------
# The kernel's sorting networks, emulated index for index (csrc/bin_clusters.cu)
# ---------------------------------------------------------------------------


def bitonic_sort(keys, n):
    """``bitonic_sort``: the ascending "flip" network over n keys, n
    rounded up to a power of two, pairs reaching a position >= n skipped.
    Each step's pairs are disjoint, so a step runs as one vector op."""
    size = 1
    while size < n:
        size <<= 1
    k = 2
    while k <= size:
        j = k >> 1
        while j > 0:
            q = np.arange(size >> 1)
            lo = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            hi = lo ^ (k - 1) if j == k >> 1 else lo | j
            lo, hi = lo[hi < n], hi[hi < n]
            a, b = keys[lo], keys[hi]
            swap = b < a
            keys[lo[swap]], keys[hi[swap]] = b[swap], a[swap]
            j >>= 1
        k <<= 1
    return keys


def warp_sort(keys):
    """``warp_sort``: the same network over 32 lanes by shuffles, each lane
    keeping the min or the max of itself and its partner."""
    lane = np.arange(32)
    k = 2
    while k <= 32:
        j = k >> 1
        while j > 0:
            partner = lane ^ (k - 1) if j == k >> 1 else lane ^ j
            other = keys[partner]
            keys = np.where(lane < partner, np.minimum(keys, other),
                            np.maximum(keys, other))
            j >>= 1
        k <<= 1
    return keys


def packed_keys(n, seed):
    """n distinct keys (bits(entry) << 32) | id over positive entries with
    many ties, in a random order."""
    rng = np.random.default_rng(seed)
    entry = rng.choice(np.float32([1e-3, 0.5, 2.0, 7.25, 1e30]), n)
    entry = np.where(rng.uniform(size=n) < 0.5, entry,
                     rng.uniform(1e-3, 100, n).astype(np.float32))
    ids = rng.permutation(max(n, 1) * 3)[:n].astype(np.uint64)
    return (entry.view(np.uint32).astype(np.uint64) << np.uint64(32)) | ids


@pytest.mark.parametrize("n", [2, 3, 31, 33, 64, 65, 100, 693, 1000, 2048,
                               2049, 5000])
def test_bitonic_network_sorts_any_count(n):
    keys = packed_keys(n, seed=n)
    got = bitonic_sort(keys.copy(), n)
    assert np.array_equal(got, np.sort(keys))
    entry = (got >> np.uint64(32)).astype(np.uint32).view(np.float32)
    assert (np.diff(entry) >= 0).all()  # key order is near to far


@pytest.mark.parametrize("n", [2, 5, 17, 32])
def test_warp_network_sorts_up_to_32(n):
    keys = packed_keys(n, seed=100 + n)
    lanes = np.full(32, np.iinfo(np.uint64).max, np.uint64)  # ~0 past n
    lanes[:n] = keys
    assert np.array_equal(warp_sort(lanes)[:n], np.sort(keys))
