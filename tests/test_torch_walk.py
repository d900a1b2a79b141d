"""The redesigned closest-hit walk on the CPU: the packed (t, slot) keys,
a plain emulation of the kernel's split walk (work items that walk
independently, each with its own early-out gate and the cull of 32-ray
groups by the clusters' boxes, merged by the packed min), and the
triangle-major Woop operand.

The emulation walks the items one after another, in the kernel's depth
order and in reverse (far items first, with only the seeds to gate them),
and must equal ``closest_hit_plain`` bit for bit: the split and the cull
change which clusters are visited and which rays test them, never the
min.  Against the JAX package it meets
the reference's gates (tests/test_pallas_interpret.py:57-68), as the fused
query does in test_torch_intersect.py."""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import _woop_transforms
from directx_raytracer_tpu_torch.ops.rays import T_MIN
from test_torch_intersect import (  # noqa: F401  (module-scoped fixtures)
    assert_hits_agree,
    fx,
    j_pallas,
)

torch.set_num_threads(2)

K = 128


# ---------------------------------------------------------------------------
# Packed keys
# ---------------------------------------------------------------------------


def test_keys_order_as_t_then_slot():
    rng = np.random.default_rng(0)
    t = np.concatenate([rng.uniform(0, 1e4, 500), [0.0, 1e-3, 2.0, 2.0, 2.0],
                        np.full(5, 7.5)]).astype(np.float32)
    slot = np.concatenate([rng.integers(0, 1 << 20, 500), [0, 3, 9, 1, 5],
                           [6, 2, 8, 0, 4]]).astype(np.int32)
    keys = ci.pack_keys(torch.from_numpy(t), torch.from_numpy(slot))
    want = np.lexsort((slot, t))  # by t, then slot
    assert np.array_equal(np.argsort(keys.numpy(), kind="stable"), want)
    got_t, got_slot = ci.unpack_keys(keys)
    assert got_t.numpy().tobytes() == t.tobytes()
    assert np.array_equal(got_slot.numpy(), slot)


def test_seed_refuses_a_hit_at_exactly_init_t():
    """The seed's low word is 0, so a hit at exactly init_t (slot + 1 >= 1)
    never beats it; a hit just below does, and decoding gives slot -1."""
    init_t = torch.tensor([2.0, 2.0, 5.0])
    seed = ci.pack_keys(init_t)
    hit = ci.pack_keys(torch.tensor([2.0, np.nextafter(np.float32(2.0), 0),
                                     5.0]), torch.tensor([0, 7, 3]))
    assert torch.equal(torch.minimum(seed, hit) == seed,
                       torch.tensor([True, False, True]))
    t, slot = ci.unpack_keys(seed)
    assert torch.equal(t, init_t) and (slot == -1).all()


def test_padding_seed_is_zero():
    """Padding rays are seeded with t = 0: key 0, below every hit key."""
    keys = ci.pack_keys(torch.zeros(4))
    assert (keys == 0).all()
    t, slot = ci.unpack_keys(keys)
    assert (t == 0).all() and (slot == -1).all()
    assert (ci.pack_keys(torch.tensor([T_MIN]), torch.tensor([0])) > 0).all()


# ---------------------------------------------------------------------------
# Work items and the split walk
# ---------------------------------------------------------------------------


def item_list(counts, width, chunk):
    """The closest_hit kernel's work items in the order it takes them, as
    (tile, first position) pairs: depth j of a tile covers list positions
    [j * chunk, (j + 1) * chunk); every tile's depth j comes before any
    tile's depth j + 1, tiles with the most items first (the kernel's
    counting sort; among equal counts its order is arbitrary, here tile
    order)."""
    items = [-(-int(c) // chunk) for c in counts]
    order = sorted(range(len(items)), key=lambda t: -items[t])
    return [(t, j * chunk) for j in range(-(-width // chunk))
            for t in order if items[t] > j]


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_work_items_cover_each_list_once_in_depth_order(chunk):
    counts = torch.tensor([0, 5, 16, 17, 0, 1, 40], dtype=torch.int32)
    items = item_list(counts, int(counts.max()), chunk)
    covered = [(t, p) for t, s in items
               for p in range(s, min(s + chunk, int(counts[t])))]
    want = {(t, p) for t in range(len(counts)) for p in range(int(counts[t]))}
    assert len(covered) == len(want) and set(covered) == want
    starts = [s for _, s in items]
    assert starts == sorted(starts)  # every tile's depth j before depth j + 1


def split_walk(args, chunk, reverse=False):
    """Plain emulation of the closest_hit kernel: each work item starts
    from its rays' merged keys, gates each visit on the largest of its
    rays' best t (its own or the merged key, whichever is lower), tests
    the cluster as ``closest_hit_plain`` does but only in the 32-ray
    groups where a ray passes the cull (``cull_keep`` at that best t), and
    merges the rays it improved with a packed-key min.  Items run one after
    another, in the kernel's depth order or reversed.  Returns best_t,
    best_slot, the visits made and the 32-ray groups whose tests ran."""
    o, d, init_t, wrows, crows, visit, ventry, counts, tile_r = args
    tiles, width = visit.shape
    groups = torch.arange(tile_r) // ci.CULL_GROUP
    n_groups = -(-tile_r // ci.CULL_GROUP)
    k = wrows.shape[1]
    o3 = o.reshape(tiles, tile_r, 3)
    d3 = d.reshape(tiles, tile_r, 3)
    keys = ci.pack_keys(init_t).reshape(tiles, tile_r)
    items = item_list(counts, width, chunk)
    visits = tested = 0
    for tile, start in (reversed(items) if reverse else items):
        bt, bs = ci.unpack_keys(keys[tile])
        improved = torch.zeros(tile_r, dtype=torch.bool)
        for i in range(start, min(start + chunk, int(counts[tile]))):
            kt, _ = ci.unpack_keys(keys[tile])
            if ventry[tile, i] > torch.minimum(bt, kt).amax():
                break
            visits += 1
            cl = visit[tile, i]
            keep = ci.cull_keep(o3[tile], d3[tile], torch.minimum(bt, kt),
                                crows[cl.long()])
            run = torch.zeros(n_groups, dtype=torch.bool)
            run[groups[keep]] = True
            tested += int(run.sum())
            run = run[groups]
            t, u, v = ci._woop_tests(wrows[cl.long()][None], o3, d3,
                                     torch.tensor([tile]))
            ok = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= T_MIN)
            tk, ik = torch.where(ok, t, float("inf")).min(dim=2)
            tk, slot = tk[0], cl * k + ik[0].to(torch.int32)
            closer = run & ((tk < bt) | ((tk == bt) & (slot < bs)))
            bt = torch.where(closer, tk, bt)
            bs = torch.where(closer, slot, bs)
            improved |= closer
        mine = ci.pack_keys(bt, bs)
        keys[tile] = torch.where(improved, torch.minimum(keys[tile], mine),
                                 keys[tile])
    best_t, best_slot = ci.unpack_keys(keys.reshape(-1))
    return best_t, best_slot, visits, tested


def walk_args(fx, tile_r):
    o, d, t_init = ci.pad_and_seed(fx.o, fx.d, fx.cs, tile_r)
    visit, ventry, counts = ci.visit_lists(*ci.bin_clusters_plain(
        ci.tile_params(o, d, tile_r), ci.cluster_rows(fx.cs)))
    return (o, d, t_init, fx.wrows, ci.cull_rows(fx.wrows), visit, ventry,
            counts, tile_r)


@pytest.mark.parametrize("tile_r,chunk", [(768, 1), (768, 8), (256, 1),
                                          (256, 3)])
@pytest.mark.parametrize("reverse", [False, True])
def test_split_walk_equals_serial_walk(fx, tile_r, chunk, reverse):
    """bench_scene(3000) at 96x48: bit for bit the serial walk's result."""
    args = walk_args(fx, tile_r)
    stats = {}
    want_t, want_slot, _, want_tested = ci.closest_hit_plain(
        *args, stats=stats, count_exec=True)
    got_t, got_slot, visits, tested = split_walk(args, chunk, reverse)
    assert torch.equal(got_slot, want_slot)
    assert got_t.numpy().tobytes() == want_t.numpy().tobytes()
    assert (want_slot >= 0).sum() > 100
    # Walked one after another in depth order, each item starts from its
    # near items' keys, so it visits what the serial walk visits, at the
    # same best t, and culls the same groups; reversed, far items start
    # from the seeds alone and visit more.
    if reverse:
        assert visits >= stats["visits"]
    else:
        assert visits == stats["visits"]
        assert tested == int(want_tested.sum())
    k = args[3].shape[1]
    assert stats["kept_tests"] == int(want_tested.sum()) * ci.CULL_GROUP * k


def test_split_walk_meets_pallas_gates(fx, j_pallas):
    """The emulated split walk against the TPU closest-hit kernel in
    interpret mode, under the reference's gates."""
    n = fx.o.shape[0]
    t, slot, _, _ = split_walk(walk_args(fx, 768), 1)
    t, slot = t[:n], slot[:n]
    hit = ci.Hit(t=torch.where(slot >= 0, t, float("inf")), tri=slot,
                 u=torch.zeros_like(t), v=torch.zeros_like(t))
    assert_hits_agree(hit, j_pallas)


def long_list_tile(order, tie: bool):
    """One 32-ray tile looking down -z from z = 20 over a list of 12
    clusters, each holding one triangle under every ray: cluster c's at
    z = -(c + 1), at slot cK + 7 (cluster 9's at slot 9K + 1), so cluster
    0 is nearest (t = 21).  With ``tie`` cluster 9's triangle moves to
    z = -1 too: equal t, and the lower slot (cluster 0's, 7) must still
    win whatever the visit order."""
    c_n, tile_r = 12, 32
    woop = np.zeros((c_n, K, 3, 4), np.float32)
    woop[..., 3] = -1e30  # guaranteed-miss sentinels
    e1 = np.array([[16.0, 0.0, 0.0]], np.float32)  # covers x + y <= 8
    e2 = np.array([[0.0, 16.0, 0.0]], np.float32)
    for c in range(c_n):
        z = -1.0 if (tie and c == 9) else -float(c + 1)
        woop[c, 1 if c == 9 else 7] = _woop_transforms(
            np.array([[-4.0, -4.0, z]], np.float32), e1, e2)[0]
    rng = np.random.default_rng(5)
    o = np.zeros((tile_r, 3), np.float32)
    o[:, :2] = rng.uniform(-1, 1, (tile_r, 2))
    o[:, 2] = 20.0
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (tile_r, 1))
    visit = torch.tensor([order], dtype=torch.int32)
    entry = np.sort(rng.uniform(0, 19, len(order))).astype(np.float32)
    wrows = torch.from_numpy(woop).reshape(c_n, K, 12)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.full((tile_r,), 100.0), wrows, ci.cull_rows(wrows), visit,
            torch.from_numpy(entry)[None],
            torch.tensor([len(order)], dtype=torch.int32), tile_r)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("order", [list(range(12)), list(range(11, -1, -1)),
                                   [9, 5, 11, 2, 0, 7, 1, 3, 10, 4, 8, 6]])
@pytest.mark.parametrize("reverse", [False, True])
def test_split_walk_long_list(order, tie, reverse):
    """A 12-cluster list cut into 12 one-position items: equal to the
    serial walk bit for bit, the nearest triangle winning, and on a tie
    across items the lower slot."""
    args = long_list_tile(order, tie)
    want_t, want_slot = ci.closest_hit_plain(*args)
    got_t, got_slot, _, _ = split_walk(args, 1, reverse)
    assert torch.equal(got_slot, want_slot)
    assert got_t.numpy().tobytes() == want_t.numpy().tobytes()
    assert (got_slot == 7).all()
    assert (got_t == 21.0).all()


# ---------------------------------------------------------------------------
# The triangle-major operand
# ---------------------------------------------------------------------------


def test_woop_rows_are_the_cluster_blocks(fx):
    """(C, K, 12): entry [c, kk, 4a + j] is W[a][j] of triangle kk, bit for
    bit the port's and the JAX package's cluster Woop blocks."""
    w = ci.woop_rows(fx.cs)
    c, k = fx.cs.woop.shape[:2]
    assert w.shape == (c, k, 12) and w.is_contiguous()
    assert torch.equal(w.reshape(c, k, 3, 4), fx.cs.woop)
    jw = np.asarray(fx.jbvh.clusters.woop).reshape(c, k, 12)
    assert w.numpy().tobytes() == jw.tobytes()


def test_pair_tests_equal_the_transposed_layout(fx):
    """The plain walks' pair tests on the triangle-major operand equal the
    earlier (C, 12, K) formulation bit for bit."""
    tile_r = 256
    o, d, _ = ci.pad_and_seed(fx.o, fx.d, fx.cs, tile_r)
    tiles = o.shape[0] // tile_r
    o3, d3 = o.reshape(tiles, tile_r, 3), d.reshape(tiles, tile_r, 3)
    sel = torch.arange(tiles)
    cl = torch.arange(tiles) % fx.wrows.shape[0]
    t, u, v = ci._woop_tests(fx.wrows[cl], o3, d3, sel)
    w = fx.wrows.transpose(1, 2).contiguous()[cl][:, :, None, :]
    ox, oy, oz = (o3[sel, :, a, None] for a in range(3))
    dx, dy, dz = (d3[sel, :, a, None] for a in range(3))
    ozp = w[:, 8] * ox + w[:, 9] * oy + w[:, 10] * oz + w[:, 11]
    dzp = w[:, 8] * dx + w[:, 9] * dy + w[:, 10] * dz
    want_t = -ozp / dzp
    want_u = ((w[:, 0] * ox + w[:, 1] * oy + w[:, 2] * oz + w[:, 3])
              + want_t * (w[:, 0] * dx + w[:, 1] * dy + w[:, 2] * dz))
    want_v = ((w[:, 4] * ox + w[:, 5] * oy + w[:, 6] * oz + w[:, 7])
              + want_t * (w[:, 4] * dx + w[:, 5] * dy + w[:, 6] * dz))
    for got, want in ((t, want_t), (u, want_u), (v, want_v)):
        assert got.numpy().tobytes() == want.numpy().tobytes()
