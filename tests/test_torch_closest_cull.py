"""The closest-hit walk's cull on the CPU: the cluster cull boxes
(``cull_rows``) and the plain twin of the kernel's predicate
(``cull_keep``).

The cull may drop a (ray, cluster) pair only if no triangle of the cluster
can be accepted at t <= the ray's best t, so the predicate must keep every
pair the Woop test accepts there: on the bench scene's clusters, and on
adversarial rays (hits on a triangle's vertices and edges, where the box's
faces lie; directions with zero components, along a face or grazing it;
origins on a face's plane and inside the box; slender triangles; a scene
far from the origin), each with its best t at exactly the accepted t.  The
plain walk's count of the 32-ray groups the cull lets through stays within
its visits' groups and below them on a primary batch, and counting changes
no result.  This file imports no JAX (tests/test_torch_cuda.py reuses its
adversarial batch on the card)."""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import testscenes
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.models.scene import _woop_transforms
from directx_raytracer_tpu_torch.ops.rays import T_MIN, generate_rays_tiled
from directx_raytracer_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

K = 32  # triangles a cluster in the adversarial sets


def _cluster(v0, e1, e2):
    """(K, 12) Woop rows of up to K triangles, sentinels after them."""
    w = np.zeros((K, 3, 4), np.float32)
    w[..., 3] = -1e30
    w[:len(v0)] = _woop_transforms(v0, e1, e2)
    return w.reshape(K, 12)


def adversarial_clusters(seed: int = 0):
    """(C, K, 12) Woop rows of five clusters and their triangles' vertices
    (C, K, 3, 3) (NaN past each cluster's triangles): ordinary triangles
    in a unit box; slender ones (widths 1e-3 to 1e-6 of their length);
    triangles in the planes of their box's faces (axis-aligned, so rays
    along a face graze them); small triangles at 1e3 from the origin; and
    one cluster of sentinels alone."""
    rng = np.random.default_rng(seed)
    sets = []
    n = K - 4
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    sets.append((v0, rng.normal(size=(n, 3)).astype(np.float32) * 0.3,
                 rng.normal(size=(n, 3)).astype(np.float32) * 0.3))
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    side = np.cross(e1, rng.normal(size=(n, 3))).astype(np.float32)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    width = 10.0 ** rng.uniform(-6, -3, (n, 1))
    sets.append((rng.uniform(2, 3, (n, 3)).astype(np.float32), e1,
                 (e1 * rng.uniform(0.2, 0.8, (n, 1)) + side * width
                  * np.linalg.norm(e1, axis=1, keepdims=True)).astype(np.float32)))
    ax = np.arange(n) % 3
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v0[np.arange(n), ax] = np.where(np.arange(n) % 2, 1.0, -1.0)  # on a face
    e1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e1[np.arange(n), ax] = 0.0
    e2[np.arange(n), ax] = 0.0
    sets.append((v0 + np.float32(5.0), e1, e2))
    v0 = (np.float32(1e3) + rng.uniform(-1, 1, (n, 3))).astype(np.float32)
    sets.append((v0, rng.normal(size=(n, 3)).astype(np.float32) * 0.01,
                 rng.normal(size=(n, 3)).astype(np.float32) * 0.01))
    rows = [_cluster(*s) for s in sets] + [_cluster(*(np.zeros((0, 3),
                                                               np.float32),) * 3)]
    verts = np.full((len(rows), K, 3, 3), np.nan, np.float32)
    for c, (v0, e1, e2) in enumerate(sets):
        verts[c, :len(v0)] = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    return torch.from_numpy(np.stack(rows)), verts


def adversarial_rays(verts, seed: int = 1):
    """Rays (R, 3) at every triangle's vertices, edge midpoints, centroid
    and points 1e-6 of the box outside each vertex, from 8 directions (a
    random one, the 6 axis directions with two zero components, one along
    the triangle's first edge) and two distances (3.0 away, and 1e-3 away,
    inside the box); and, for the axis directions, origins moved onto the
    plane of the box's face the ray enters through."""
    rng = np.random.default_rng(seed)
    v = verts.reshape(-1, 3, 3)
    v = v[~np.isnan(v).any(axis=(1, 2))].astype(np.float64)
    full = ~np.isnan(verts).all(axis=(1, 2, 3))  # clusters with triangles
    lo = np.full((verts.shape[0], 3), np.nan)
    hi = np.full((verts.shape[0], 3), np.nan)
    lo[full] = np.nanmin(verts[full], axis=(1, 2))
    hi[full] = np.nanmax(verts[full], axis=(1, 2))
    cl = np.repeat(np.arange(verts.shape[0]), K)[~np.isnan(
        verts.reshape(-1, 9)).any(axis=1)]
    mid = (v + np.roll(v, 1, axis=1)) / 2
    ext = (hi - lo)[cl][:, None, :]
    outward = np.sign(v - (lo + hi)[cl][:, None, :] / 2) * 1e-6 * ext
    targets = np.concatenate([v, mid, v.mean(axis=1, keepdims=True),
                              v + outward], axis=1)  # (T, 10, 3)
    edge = v[:, 1] - v[:, 0]
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    o, d = [], []
    for j in range(8):
        if j == 0:
            dj = rng.normal(size=(len(v), 3))
        elif j <= 6:
            dj = np.tile(axes[j - 1], (len(v), 1))
        else:
            dj = edge
        dj = dj / np.linalg.norm(dj, axis=1, keepdims=True)
        for dist in (3.0, 1e-3):
            o.append(targets - dist * dj[:, None, :])
            d.append(np.broadcast_to(dj[:, None, :], targets.shape))
        if 1 <= j <= 6:  # onto the plane of the entry face
            a = (j - 1) % 3
            face = np.where(j <= 3, lo[cl, a], hi[cl, a])
            oj = targets - 3.0 * dj[:, None, :]
            oj[..., a] = face[:, None]
            o.append(oj)
            d.append(np.broadcast_to(dj[:, None, :], targets.shape))
    o = np.concatenate(o, axis=1).reshape(-1, 3).astype(np.float32)
    d = np.concatenate(d, axis=1).reshape(-1, 3).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def accepted_t(wrows, o, d, t_min=T_MIN):
    """The least t at which each ray's Woop test accepts a triangle of each
    cluster (R, C), +inf where none does: the plain walks' pair test."""
    c = wrows.shape[0]
    r = o.shape[0]
    out = torch.full((r, c), float("inf"))
    for cl in range(c):
        t, u, v = ci._woop_tests(wrows[cl][None], o[None], d[None],
                                 torch.tensor([0]))
        ok = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= t_min)
        out[:, cl] = torch.where(ok, t, float("inf")).amin(dim=2)[0]
    return out


def assert_keeps_accepted(wrows, o, d):
    """Every (ray, cluster) pair the Woop test accepts at some t keeps
    through ``cull_keep`` at best = exactly that t; returns the pairs."""
    crows = ci.cull_rows(wrows)
    t = accepted_t(wrows, o, d)
    hit = torch.isfinite(t)
    keep = ci.cull_keep(o[:, None], d[:, None], torch.where(hit, t, 0.0),
                        crows[None])
    assert bool(keep[hit].all()), f"{int((hit & ~keep).sum())} pairs dropped"
    return int(hit.sum())


@pytest.fixture(scope="module")
def adversarial():
    wrows, verts = adversarial_clusters()
    return wrows, verts, *adversarial_rays(verts)


@pytest.mark.parametrize("case", ["all", "random", "axis", "edge", "near",
                                  "face_plane"])
def test_cull_keeps_every_accepted_pair_adversarial(adversarial, case):
    """The adversarial rays, by kind: each cluster of them must keep every
    pair its Woop test accepts at t <= best."""
    wrows, _, o, d = adversarial
    per_target = 10
    # adversarial_rays' order: per direction j, distances 3.0 and 1e-3,
    # then for the axis directions the face-plane origins.
    kinds = []
    for j in range(8):
        kinds += [("random" if j == 0 else "axis" if j <= 6 else "edge", "far"),
                  ("random" if j == 0 else "axis" if j <= 6 else "edge", "near")]
        if 1 <= j <= 6:
            kinds.append(("axis", "face_plane"))
    tris = o.shape[0] // (per_target * len(kinds))
    o3 = o.reshape(tris, len(kinds), per_target, 3)
    d3 = d.reshape(tris, len(kinds), per_target, 3)
    pick = [i for i, (dk, where) in enumerate(kinds)
            if case == "all" or case in (dk, where)]
    pairs = assert_keeps_accepted(wrows, o3[:, pick].reshape(-1, 3),
                                  d3[:, pick].reshape(-1, 3))
    assert pairs > 100


def test_adversarial_rays_reach_every_kind(adversarial):
    """The set is adversarial: rays hit exactly a box face's plane (axis
    directions with zero components), hits land on triangles whose
    vertices make the box's faces, and slender triangles are hit."""
    wrows, verts, o, d = adversarial
    assert bool((d == 0).any(dim=1).any())
    t = accepted_t(wrows, o, d)
    hit = torch.isfinite(t)
    assert all(int(hit[:, c].sum()) > 50 for c in range(4))
    assert not bool(hit[:, 4].any())  # sentinels accept nothing


@pytest.mark.parametrize("n_tris,tile_r", [(3_000, 768), (3_000, 256),
                                           (30_000, 768)])
def test_cull_keeps_every_accepted_pair_on_the_bench_scene(n_tris, tile_r):
    """The bench scene's primary rays against every cluster its tiles list:
    the pairs accepted at t <= the walk's final best keep."""
    b = primary_query(n_tris, tile_r)
    bt, _ = ci.closest_hit_plain(*b.args())
    tiles = b.counts.shape[0]
    o = b.origins.reshape(tiles, b.tile_r, 3)
    d = b.dirs.reshape(tiles, b.tile_r, 3)
    bt = bt.reshape(tiles, b.tile_r)
    needed = 0
    for i in range(b.visit.shape[1]):
        sel = (b.counts > i).nonzero()[:, 0]
        cl = b.visit[sel, i].long()
        t, u, v = ci._woop_tests(b.wrows[cl], o, d, sel)
        ok = (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= T_MIN)
        tacc = torch.where(ok, t, float("inf")).amin(dim=2)
        need = tacc <= bt[sel]
        keep = ci.cull_keep(o[sel], d[sel], torch.where(need, tacc, bt[sel]),
                            b.crows[cl][:, None])
        assert bool(keep[need].all())
        needed += int(need.sum())
    assert needed > 1000


def primary_query(n_tris, tile_r, width=384, height=216):
    """``bench_scene(n_tris)``'s primary batch at ``width`` x ``height`` in
    tiles of ``tile_r`` (24 x 32 or 8 x 32 pixels), as ``intersect_fused``
    builds it on the CPU."""
    scene = testscenes.bench_scene(n_tris, width, height)
    r = Renderer(scene, width, height, device="cpu")
    pos, rot = r.camera.snapshot()
    o, d = generate_rays_tiled(pos, rot, width, height, tile_r // 32, 32,
                               device="cpu")
    return ci.closest_query(o, d, r.bvh.clusters, r.bvh.wrows, tile_r,
                            srows=r.bvh.srows, crows=r.bvh.crows)


@pytest.mark.parametrize("tile_r", [768, 256])
def test_plain_tested_groups_within_the_visits(tile_r):
    """``closest_hit_plain(count_exec=True)``'s tested: on every tile at
    most its visits x ceil(tile_r / 32) groups, fewer in all on the
    primary batch (the cull bites); the results as without counting."""
    b = primary_query(30_000, tile_r)
    bt, bs, visits, tested = ci.closest_hit_plain(*b.args(), count_exec=True)
    want_t, want_s = ci.closest_hit_plain(*b.args())
    assert torch.equal(bt.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(bs, want_s)
    groups = tile_r // ci.CULL_GROUP
    assert tested.dtype == torch.int32 and tested.shape == b.counts.shape
    assert bool((tested >= 0).all()) and bool((tested <= visits * groups).all())
    assert 0 < int(tested.sum()) < int(visits.sum()) * groups
    # The CPU path of closest_hit is the plain walk's count.
    assert torch.equal(ci.closest_hit(*b.args(), count_exec=True)[3], tested)


def test_cull_rows_hold_every_triangle(adversarial):
    """Each cluster's box holds its triangles' vertices, grown by a margin
    (f > 0); the sentinel cluster's box is empty (lo > hi, f = 0); rows are
    (C, 8) f32 with a zero last column."""
    wrows, verts, _, _ = adversarial
    crows = ci.cull_rows(wrows)
    assert crows.shape == (wrows.shape[0], 8) and crows.dtype == torch.float32
    assert crows.is_contiguous() and bool((crows[:, 7] == 0).all())
    v = torch.from_numpy(verts)
    for c in range(4):
        p = v[c][~torch.isnan(v[c]).any(dim=2).any(dim=1)].reshape(-1, 3)
        assert bool((crows[c, 0:3] < p.amin(dim=0)).all())
        assert bool((crows[c, 3:6] > p.amax(dim=0)).all())
        assert float(crows[c, 6]) > 0
    assert bool((crows[4, 0:3] > crows[4, 3:6]).all()) and crows[4, 6] == 0
    # The slender cluster's bound is the widest relative to its size.
    size = (crows[:4, 3:6] - crows[:4, 0:3]).amax(dim=1)
    assert int(torch.argmax(crows[:4, 6] * 1e3 / size)) == 1


@pytest.mark.parametrize("d", [(0.0, 0.0, -1.0), (-0.0, 0.0, -1.0),
                               (1.0, 0.0, 0.0)])
@pytest.mark.parametrize("where", ["inside", "on_lo", "on_hi", "outside"])
def test_cull_keep_zero_direction_components(d, where):
    """A box [0, 1]^3 (no margin), a ray with zero direction components
    whose origin lies inside the box's slabs, on a face's plane or outside:
    kept iff its line runs through the closed box; best t = 10."""
    box = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    dd = torch.tensor(d)
    axis = int(torch.argmax(dd.abs()))
    other = (axis + 1) % 3
    o = torch.full((3,), 0.5)
    o[axis] = 5.0 if dd[axis] < 0 else -4.0
    o[other] = {"inside": 0.5, "on_lo": 0.0, "on_hi": 1.0,
                "outside": 1.5}[where]
    keep = ci.cull_keep(o, dd, torch.tensor(10.0), box)
    assert bool(keep) == (where != "outside")
