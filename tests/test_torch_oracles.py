"""The oracles of the torch port on the CPU, against the JAX package's and
against brute force: the LBVH build (``bvh/lbvh.py``), the rope walk
(``bvh/traverse.py``), the clustered walker and the un-presorted cluster
build (``bvh/clustered.py``), the binning oracle
(``bvh/binning_oracle.py``), the ``use_kernels``/``use_bvh`` routes, and
the small symbols (``woop_mats``, ``_closest_in_block``, ``tile_perm``,
``cross``/``dot``, ``read_png``, ``isect_kwargs``, ``Renderer.to_u8``/
``mode_name``).

Both packages build from the same buffers: the JAX geometry is handed to
the port as numpy (``scene_from_numpy``), and a JAX tree through
``lbvh_from_numpy``, so both walks can walk the same tree.

Tolerances: integer structure (Morton codes, ``order``, ``left``, ``skip``)
and AABBs exact — the same integer ops, a stable sort, min/max; walks
against brute force: hit/miss equal, t within rtol 1e-3, same winner on >
99% of hits (the reference's gates, tests/test_bvh.py:99-108); the port's
walk against the JAX walk on the same tree: hit/miss equal, t within 1e-5,
and the winner equal wherever the runner-up's t is more than 1e-6 away."""

import dataclasses

import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.bvh import (
    build_bvh,
    build_clusters,
    build_lbvh,
    clusters_from_numpy,
    intersect_clustered,
    lbvh_from_numpy,
    make_bvh_intersect_fn,
    make_bvh_occluder_factory,
    occluded_clustered,
    traverse_closest,
    traverse_occluded,
)
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.bvh import lbvh as plbvh
from directx_raytracer_tpu_torch.bvh.binning_oracle import bin_clusters
from directx_raytracer_tpu_torch.models.scene import (
    build_device_scene,
    scene_from_numpy,
)
from directx_raytracer_tpu_torch.ops import intersect as px
from directx_raytracer_tpu_torch.ops.rays import (
    generate_rays,
    generate_rays_tiled,
    tile_perm,
)
from directx_raytracer_tpu_torch.render import render_whitted
from directx_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_intersect import device_scene_leaves, numpy_leaves

torch.set_num_threads(2)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def geo_pair(scene):
    """The JAX geometry and the port's, from the same buffers."""
    jd = j_build(scene)
    return jd.geometry, scene_from_numpy(device_scene_leaves(jd), "cpu").geometry


def dense_soup(n_tris, seed):
    """A soup the camera sees a good share of (the default soup's rays
    mostly miss)."""
    return pts.random_soup(n_tris, seed=seed, spread=3.0, size=1.0)


def rays(scene, w=48, h=36):
    return generate_rays(scene.camera.position, scene.camera.rotation, w, h,
                         device="cpu")


# ---------------------------------------------------------------------------
# LBVH build
# ---------------------------------------------------------------------------


def test_clz32():
    cases = {0: 32, 1: 31, 2: 30, 3: 30, 0x7FFFFFFF: 1, 0x40000000: 1,
             0x00010000: 15, 0xFFFF: 16, 255: 24, -1: 0, -(2**31): 0, -12345: 0}
    x = torch.tensor(list(cases), dtype=torch.int32)
    assert plbvh._clz32(x).tolist() == list(cases.values())
    rng = np.random.default_rng(0)
    # Every bit length, and values past 2^24 where a float trick fails.
    r = np.concatenate([rng.integers(0, 2**31, 5000),
                        (1 << rng.integers(0, 31, 2000)) + rng.integers(0, 2, 2000),
                        (1 << rng.integers(24, 31, 2000)) - 1]).astype(np.int64)
    want = [32 - int(v).bit_length() for v in r]
    got = plbvh._clz32(torch.from_numpy(r.astype(np.int32)))
    assert got.dtype == torch.int32 and got.tolist() == want


def test_morton_codes_match_jax():
    from directx_raytracer_tpu.bvh.lbvh import morton_codes as j_morton

    rng = np.random.default_rng(1)
    c = rng.uniform(-3, 7, (4000, 3)).astype(np.float32)
    c[:50] = c[50:100]  # duplicates
    lo, hi = c.min(axis=0), c.max(axis=0)
    got = plbvh.morton_codes(t(c), t(lo), t(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_morton(c, lo, hi)))
    assert int(got.max()) < 2**30 and int(got.min()) >= 0


@pytest.mark.parametrize("make", [
    lambda: jts.random_soup(1, seed=1), lambda: jts.random_soup(2, seed=2),
    lambda: jts.random_soup(7, seed=7), lambda: jts.random_soup(1000, seed=3),
    lambda: jts.bench_scene(3_000, 96, 48), lambda: jts.cornell_box(),
], ids=["soup1", "soup2", "soup7", "soup1000", "bench3000", "cornell"])
def test_lbvh_equals_jax(make):
    """Sentinel slots share one Morton code (many equal keys), so the
    stable sort and the index tiebreak both matter."""
    from directx_raytracer_tpu.bvh import build_lbvh as j_build_lbvh

    jgeo, pgeo = geo_pair(make())
    want = numpy_leaves(j_build_lbvh(jgeo))
    got = build_lbvh(pgeo)
    assert got.n_tris == want["n_tris"] == pgeo.n_tris
    for name in ("order", "left", "skip"):
        x = getattr(got, name)
        assert x.dtype == torch.int32, name
        np.testing.assert_array_equal(x.numpy(), want[name], err_msg=name)
    for name in ("aabb_min", "aabb_max", "v0", "e1", "e2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=name)
    # The carried-over tree is the same tree.
    carried = lbvh_from_numpy(want, "cpu")
    for f in dataclasses.fields(carried):
        a, b = getattr(carried, f.name), getattr(got, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert (carried.root, carried.leaf_base, carried.n_internal) == (
        got.root, got.leaf_base, got.n_internal)


def test_karras_ranges_match_jax_on_duplicate_keys():
    from directx_raytracer_tpu.bvh.lbvh import _karras_ranges as j_karras

    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 40, 300).astype(np.int32))  # many ties
    left, right = plbvh._karras_ranges(t(keys))
    jl, jr = j_karras(keys)
    np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(right.numpy(), np.asarray(jr))


class TestInvariants:
    @pytest.mark.parametrize("n_tris", [1, 2, 7, 100, 1000])
    def test_structure(self, n_tris):
        geo = build_device_scene(pts.random_soup(n_tris, seed=n_tris),
                                 "cpu").geometry
        bvh = build_lbvh(geo)
        n = bvh.n_tris
        assert n == geo.n_tris and geo.n_real_tris == n_tris
        left, skip = bvh.left.numpy(), bvh.skip.numpy()
        # Every triangle appears exactly once in the sorted order.
        assert sorted(bvh.order.tolist()) == list(range(n))
        n_nodes = 2 * n - 1
        # Walk the skip-threaded tree from the root; every node must be
        # visited exactly once when we always descend.
        visited = np.zeros(n_nodes, bool)
        cur, steps = bvh.root, 0
        while cur != -1 and steps <= n_nodes + 1:
            assert not visited[cur]
            visited[cur] = True
            cur = left[cur] if left[cur] != -1 else skip[cur]
            steps += 1
        assert visited.all()

    @pytest.mark.parametrize("n_tris", [2, 50, 500])
    def test_parent_aabbs_contain_children(self, n_tris):
        geo = build_device_scene(pts.random_soup(n_tris, seed=7 * n_tris + 1),
                                 "cpu").geometry
        bvh = build_lbvh(geo)
        n = bvh.n_tris
        amin, amax = bvh.aabb_min.numpy(), bvh.aabb_max.numpy()
        left = bvh.left.numpy()[: n - 1]
        right = bvh.skip.numpy()[left]  # the left child's sibling
        for kids in (left, right):
            assert (amin[: n - 1] <= amin[kids] + 1e-6).all()
            assert (amax[: n - 1] >= amax[kids] - 1e-6).all()

    def test_leaf_aabbs_are_triangle_bounds(self):
        geo = build_device_scene(pts.random_soup(64, seed=3), "cpu").geometry
        bvh = build_lbvh(geo)
        n = bvh.n_tris
        p0 = bvh.v0.numpy()
        p1, p2 = p0 + bvh.e1.numpy(), p0 + bvh.e2.numpy()
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        np.testing.assert_allclose(bvh.aabb_min.numpy()[n - 1:], lo, atol=1e-6)
        np.testing.assert_allclose(bvh.aabb_max.numpy()[n - 1:], hi, atol=1e-6)

    def test_a_sweep_bound_below_the_depth_raises(self):
        """Ropes left unthreaded would end walks early (the JAX build
        returns such a tree): the port refuses."""
        geo = build_device_scene(dense_soup(300, seed=2), "cpu").geometry
        with pytest.raises(ValueError, match="deeper than max_depth=3"):
            build_lbvh(geo, max_depth=3)
        deep = build_lbvh(geo, max_depth=62)
        assert torch.equal(deep.skip, build_lbvh(geo).skip)

    def test_empty_scene_raises(self):
        from directx_raytracer_tpu_torch.models.scene import Scene

        with pytest.raises(ValueError):
            build_lbvh(build_device_scene(Scene(), "cpu").geometry)


# ---------------------------------------------------------------------------
# The rope walk
# ---------------------------------------------------------------------------


def assert_matches_bruteforce(got, ref):
    assert torch.equal(got.mask, ref.mask)
    hit = ref.mask
    np.testing.assert_allclose(got.t[hit].numpy(), ref.t[hit].numpy(), rtol=1e-3)
    if hit.any():
        assert (got.tri == ref.tri)[hit].float().mean() > 0.99


class TestTraversalEqualsBruteForce:
    @pytest.mark.parametrize("n_tris,seed", [(1, 0), (13, 1), (300, 2), (2000, 3)])
    def test_closest_hit_matches(self, n_tris, seed):
        scene = pts.random_soup(n_tris, seed=seed)
        geo = build_device_scene(scene, "cpu").geometry
        o, d = rays(scene)
        assert_matches_bruteforce(traverse_closest(o, d, build_lbvh(geo)),
                                  px.intersect_bruteforce(o, d, geo.woop))

    def test_structured_scene_matches(self):
        scene = pts.bench_scene(n_tris=5000, width=64, height=36)
        geo = build_device_scene(scene, "cpu").geometry
        o, d = rays(scene, 64, 36)
        ref = px.intersect_bruteforce(o, d, geo.woop)
        got = traverse_closest(o, d, build_lbvh(geo), block=1000)  # ragged blocks
        assert_matches_bruteforce(got, ref)
        assert ref.mask.sum() > 500

    @pytest.mark.parametrize("make", [pts.random_soup, dense_soup],
                             ids=["soup", "dense"])
    def test_occlusion_matches(self, make):
        scene = make(200, seed=11)
        geo = build_device_scene(scene, "cpu").geometry
        o, d = rays(scene, 32, 24)
        t_max = torch.full((o.shape[0],), 40.0)
        ref = px.occluded_bruteforce(o, d, geo.woop, t_max)
        got = traverse_occluded(o, d, build_lbvh(geo), t_max, block=500)
        assert torch.equal(got, ref)
        if make is dense_soup:
            assert ref.any() and not ref.all()

    def test_per_ray_t_max_and_disarmed_rays(self):
        scene = dense_soup(100, seed=5)
        geo = build_device_scene(scene, "cpu").geometry
        o, d = rays(scene, 16, 12)
        bvh = build_lbvh(geo)
        far = traverse_closest(o, d, bvh)
        cut = float(far.t[far.mask].median())  # rays beyond it must miss
        near = traverse_closest(o, d, bvh, t_max=torch.full((o.shape[0],), cut))
        assert torch.equal(near.mask, far.mask & (far.t < cut))
        assert near.mask.any() and (far.mask & ~near.mask).any()
        # t_max = t_min: a padding ray, never hit and never blocked.
        off = torch.full((o.shape[0],), 1e-3)
        assert not traverse_closest(o, d, bvh, t_max=off).mask.any()
        assert not traverse_occluded(o, d, bvh, off).any()
        empty = traverse_closest(o[:0], d[:0], bvh)
        assert empty.t.shape == (0,) and empty.tri.dtype == torch.int32


@pytest.mark.parametrize("make,w,h", [
    (lambda: jts.random_soup(300, seed=2, spread=3.0, size=1.0), 48, 36),
    (lambda: jts.bench_scene(3_000, 96, 48), 96, 48),
], ids=["soup300", "bench3000"])
def test_walk_matches_jax_walk_on_the_same_tree(make, w, h):
    from directx_raytracer_tpu.bvh import build_lbvh as j_build_lbvh
    from directx_raytracer_tpu.bvh import traverse_closest as j_closest
    from directx_raytracer_tpu.bvh import traverse_occluded as j_occluded

    scene = make()
    jgeo, pgeo = geo_pair(scene)
    jbvh = j_build_lbvh(jgeo)
    bvh = lbvh_from_numpy(numpy_leaves(jbvh), "cpu")
    o, d = rays(scene, w, h)
    want = j_closest(o.numpy(), d.numpy(), jbvh)
    got = traverse_closest(o, d, bvh)
    w_tri, w_t = np.asarray(want.tri), np.asarray(want.t)
    hit = w_tri >= 0
    np.testing.assert_array_equal(got.mask.numpy(), hit)
    assert hit.sum() > 200
    np.testing.assert_allclose(got.t.numpy()[hit], w_t[hit], rtol=1e-5)
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit],
                               atol=1e-4)
    # The winner is exact wherever the two walks' t differ by less than the
    # gap to any other candidate: where t agrees to 1e-6 yet the winners
    # differ, two triangles tie (a shared edge).
    differ = (got.tri.numpy() != w_tri) & hit
    gap = np.abs(got.t.numpy()[differ] - w_t[differ])
    assert (gap <= 1e-6 * np.abs(w_t[differ]) + 1e-6).all()
    assert differ.mean() < 0.01

    t_max = torch.full((o.shape[0],), 0.75 * float(np.median(w_t[hit])))
    blocked = traverse_occluded(o, d, bvh, t_max)
    j_blocked = np.asarray(j_occluded(o.numpy(), d.numpy(), jbvh, t_max.numpy()))
    np.testing.assert_array_equal(blocked.numpy(), j_blocked)
    assert j_blocked.any() and not j_blocked.all()


# ---------------------------------------------------------------------------
# The clustered walker
# ---------------------------------------------------------------------------


def unsorted(geo):
    """The geometry shuffled out of treelet order (sentinel slots and all),
    and the permutation: new slot -> old slot."""
    n = geo.n_tris
    perm = torch.from_numpy(np.random.default_rng(8).permutation(n))
    moved = {f.name: getattr(geo, f.name)[perm]
             for f in dataclasses.fields(geo)
             if isinstance(getattr(geo, f.name), torch.Tensor)
             and getattr(geo, f.name).shape[:1] == (n,)}
    return dataclasses.replace(geo, morton_sorted=False, **moved), perm


class TestClusteredEqualsBruteForce:
    @pytest.mark.parametrize("presorted", [True, False],
                             ids=["presorted", "unpresorted"])
    @pytest.mark.parametrize("n_tris,seed,k", [(13, 1, 128), (300, 2, 32),
                                               (2000, 3, 128)])
    def test_closest_hit_matches(self, n_tris, seed, k, presorted):
        scene = pts.random_soup(n_tris, seed=seed)
        geo = build_device_scene(scene, "cpu").geometry
        if not presorted:
            geo, _ = unsorted(geo)
        o, d = rays(scene)
        cs = build_clusters(geo, k=k)
        assert cs.identity_order is presorted and cs.k == k
        ref = px.intersect_bruteforce(o, d, geo.woop)
        assert_matches_bruteforce(intersect_clustered(o, d, cs, block=500), ref)
        assert sorted(x for x in cs.order.tolist() if x >= 0) == list(
            range(geo.n_tris))

    @pytest.mark.parametrize("presorted", [True, False],
                             ids=["presorted", "unpresorted"])
    def test_occlusion_matches(self, presorted):
        scene = dense_soup(200, seed=11)
        geo = build_device_scene(scene, "cpu").geometry
        if not presorted:
            geo, _ = unsorted(geo)
        o, d = rays(scene, 32, 24)
        t_max = torch.full((o.shape[0],), 40.0)
        t_max[::7] = 0.0  # disarmed rays are never blocked
        ref = px.occluded_bruteforce(o, d, geo.woop, t_max)
        got = occluded_clustered(o, d, build_clusters(geo, k=32), t_max,
                                 block=300)
        assert torch.equal(got, ref) and ref.any() and not ref[::7].any()

    @pytest.mark.parametrize("k", [32, 128])
    def test_per_ray_t_max_respected(self, k):
        # Rays with a short t_max must miss geometry beyond it.
        scene = dense_soup(100, seed=5)
        geo = build_device_scene(scene, "cpu").geometry
        o, d = rays(scene, 16, 12)
        cs = build_clusters(geo, k=k)
        far = intersect_clustered(o, d, cs)
        cut = float(far.t[far.mask].median())
        near = intersect_clustered(o, d, cs,
                                   t_max=torch.full((o.shape[0],), cut))
        assert torch.equal(near.mask, far.mask & (far.t < cut))
        assert near.mask.any() and (far.mask & ~near.mask).any()


def test_unpresorted_clusters_equal_jax():
    """The un-presorted build against the JAX package's on the same
    shuffled geometry: the same Morton order and buffers, bit for bit."""
    import jax.numpy as jnp

    from directx_raytracer_tpu.bvh.clustered import build_clusters as j_clusters

    jgeo, pgeo = geo_pair(jts.random_soup(700, seed=6))
    pgeo_u, perm = unsorted(pgeo)
    moved = {f.name: jnp.asarray(np.asarray(getattr(jgeo, f.name))[perm.numpy()])
             for f in dataclasses.fields(jgeo)
             if hasattr(getattr(jgeo, f.name), "shape")
             and getattr(jgeo, f.name).shape[:1] == (jgeo.n_tris,)}
    jgeo_u = dataclasses.replace(jgeo, morton_sorted=False, **moved)
    want = numpy_leaves(j_clusters(jgeo_u, k=64))
    got = numpy_leaves(build_clusters(pgeo_u, k=64))
    assert got["identity_order"] is False and want["identity_order"] is False
    for name, w in want.items():
        g = got[name]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
        else:
            assert g == w, name
    # The un-presorted ClusterSet crosses through clusters_from_numpy as it is.
    carried = clusters_from_numpy(want, "cpu")
    assert carried.identity_order is False
    assert torch.equal(carried.order, t(want["order"]))


def test_clustered_walker_matches_jax_walker():
    from directx_raytracer_tpu.bvh.clustered import build_clusters as j_clusters
    from directx_raytracer_tpu.bvh.clustered import (
        intersect_clustered as j_intersect,
        occluded_clustered as j_occluded,
    )

    scene = jts.bench_scene(3_000, 96, 48)
    jgeo, pgeo = geo_pair(scene)
    jcs = j_clusters(jgeo)
    cs = clusters_from_numpy(numpy_leaves(jcs), "cpu")
    o, d = rays(scene, 96, 48)
    want = j_intersect(o.numpy(), d.numpy(), jcs, block=1536)
    got = intersect_clustered(o, d, cs, block=1536)
    hit = np.asarray(want.tri) >= 0
    np.testing.assert_array_equal(got.mask.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-5)
    assert (got.tri.numpy() == np.asarray(want.tri))[hit].mean() > 0.99
    t_max = torch.full((o.shape[0],), 30.0)
    np.testing.assert_array_equal(
        occluded_clustered(o, d, cs, t_max, block=1536).numpy(),
        np.asarray(j_occluded(o.numpy(), d.numpy(), jcs, t_max.numpy(),
                              block=1536)))


# ---------------------------------------------------------------------------
# The routes: use_kernels, use_bvh
# ---------------------------------------------------------------------------


class TestRendererIntegration:
    def test_whitted_with_bvh_matches_bruteforce(self):
        scene = pts.cornell_box(48, 32)
        d = build_device_scene(scene, "cpu")
        bvh = build_bvh(d.geometry)
        pos, rot = scene.camera.snapshot()
        img_bvh, _ = render_whitted(
            d, pos, rot, 48, 32, max_depth=2,
            intersect_fn=make_bvh_intersect_fn(bvh, use_kernels=False),
            occluder_factory=make_bvh_occluder_factory(bvh, use_kernels=False))
        img_ref, _ = render_whitted(d, pos, rot, 48, 32, max_depth=2)
        # Shared-edge hits may resolve to either coincident triangle
        # (different winner between intersectors); allow a handful of pixels.
        mismatch = ((img_bvh - img_ref).abs() > 1e-4).any(dim=-1)
        assert mismatch.float().mean() < 0.002, f"{int(mismatch.sum())} pixels"

    def test_both_routes_agree_on_a_bvh_scene(self):
        scene = pts.bench_scene(3_000, 96, 48)
        d = build_device_scene(scene, "cpu")
        bvh = build_bvh(d.geometry)
        o, dd = rays(scene, 96, 48)
        walker = make_bvh_intersect_fn(bvh, use_kernels=False)(o, dd, d.geometry)
        fused = make_bvh_intersect_fn(bvh)(o, dd, d.geometry, tile_r=256)
        assert torch.equal(walker.mask, fused.mask)
        assert (walker.tri == fused.tri)[fused.mask].float().mean() > 0.99
        tm = torch.full((o.shape[0],), 30.0)
        a = make_bvh_occluder_factory(bvh, use_kernels=False)(d.geometry)(o, dd, tm)
        b = make_bvh_occluder_factory(bvh)(d.geometry)(o, dd, tm)
        assert (a == b).float().mean() >= 0.999 and a.any()

    def test_renderer_chooses_by_the_callers_device(self, monkeypatch):
        """use_kernels=None: the walker on the CPU, the kernels on any other
        device (asked of the device named, never of whether a kernel
        built); use_bvh forces the BVH on or off."""
        calls = []
        monkeypatch.setattr(
            "directx_raytracer_tpu_torch.render.renderer.make_bvh_intersect_fn",
            lambda bvh, use_kernels: calls.append(use_kernels))
        scene = pts.bench_scene(3_000, 96, 48)
        assert Renderer(scene, 96, 48, device="cpu").bvh is not None
        Renderer(scene, 96, 48, device="cpu", use_kernels=True)
        Renderer(scene, 96, 48, device="meta")  # stands for a CUDA device
        assert calls == [False, True, True]
        r = Renderer(scene, 96, 48, device="cpu", use_bvh=False)
        assert r.bvh is None and r.intersect_fn is None
        small = Renderer(pts.cornell_box(), 32, 24, device="cpu", use_bvh=True,
                         use_kernels=False)
        assert small.bvh is not None and len(calls) == 4
        assert Renderer(pts.cornell_box(), 32, 24, device="cpu").bvh is None

    def test_to_u8_and_mode_name(self):
        from directx_raytracer_tpu.render.renderer import Renderer as JRenderer
        from directx_raytracer_tpu_torch.ops.debug_shading import MODE_NAMES

        r = Renderer(pts.single_triangle(), 32, 24, device="cpu")
        img = r.render_frame(5)
        u8 = r.to_u8(img)
        assert isinstance(u8, np.ndarray) and u8.dtype == np.uint8
        np.testing.assert_array_equal(u8, r.to_u8_device(img).numpy())
        assert [Renderer.mode_name(m) for m in range(7)] == list(MODE_NAMES)
        assert Renderer.mode_name(5) == JRenderer.mode_name(5)


# ---------------------------------------------------------------------------
# The binning oracle
# ---------------------------------------------------------------------------


class TestBinnerOracleEquivalence:
    """The production binner (here its plain version) must schedule exactly
    the visit sets of the independently derived sorted oracle."""

    @pytest.fixture(scope="class")
    def x(self):
        scene = jts.bench_scene(n_tris=5_000, width=96, height=48)
        jd = j_build(scene)
        pd = scene_from_numpy(device_scene_leaves(jd), "cpu")
        pos, rot = scene.camera.snapshot()
        o, d = generate_rays_tiled(pos, rot, 96, 48, 8, 8, device="cpu")
        return dict(jd=jd, bvh=build_bvh(pd.geometry), o=o, d=d)

    def test_visit_sets_match_bin_lists_plain(self, x):
        bvh, o, d = x["bvh"], x["o"], x["d"]
        tiles = o.shape[0] // 64
        ids, entry, counts = bin_clusters(o.reshape(tiles, 64, 3),
                                          d.reshape(tiles, 64, 3), bvh.clusters)
        visit, ventry, p_counts, width = ci.bin_lists_plain(
            ci.tile_params(o, d, 64), ci.cluster_rows(bvh.clusters))
        assert torch.equal(counts, p_counts) and int(counts.sum()) > 0
        c = bvh.clusters.aabb_min.shape[0]
        for tile in range(tiles):
            n = int(counts[tile])
            assert set(ids[tile, :n].tolist()) == set(visit[tile, :n].tolist())
            assert all(0 <= cl < c for cl in ids[tile, :n].tolist())
        # Near to far, misses at +inf behind the list.
        assert (entry[:, 1:] >= entry[:, :-1]).all()
        listed = torch.arange(c) < counts[:, None]
        assert torch.isinf(entry[~listed]).all() and torch.isfinite(entry[listed]).all()
        # The same conservative entry distances, in the same order.
        np.testing.assert_allclose(entry[:, :width][listed[:, :width]].numpy(),
                                   ventry[listed[:, :width]].numpy(), rtol=1e-6)

    def test_matches_the_jax_oracle(self, x):
        from directx_raytracer_tpu.bvh import build_bvh as j_build_bvh
        from directx_raytracer_tpu.bvh.binning_oracle import (
            bin_clusters as j_bin_clusters,
        )

        bvh, o, d = x["bvh"], x["o"], x["d"]
        tiles = o.shape[0] // 64
        ot, dt = o.reshape(tiles, 64, 3), d.reshape(tiles, 64, 3)
        ids, entry, counts = bin_clusters(ot, dt, bvh.clusters)
        jids, jentry, jcounts = j_bin_clusters(
            ot.numpy(), dt.numpy(), j_build_bvh(x["jd"].geometry).clusters)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        jids, jentry = np.asarray(jids), np.asarray(jentry)
        for tile in range(tiles):
            n = int(counts[tile])
            assert set(ids[tile, :n].tolist()) == set(jids[tile, :n].tolist())
        listed = (torch.arange(entry.shape[1]) < counts[:, None]).numpy()
        np.testing.assert_allclose(entry.numpy()[listed], jentry[listed],
                                   rtol=1e-5)

    def test_parked_and_invalid(self, x):
        """A parked tile (origin 1e30) lists nothing; an invalid cluster is
        never listed."""
        bvh = x["bvh"]
        tiles = x["o"].shape[0] // 64
        ot, dt = x["o"].reshape(tiles, 64, 3), x["d"].reshape(tiles, 64, 3)
        busy = int(bin_clusters(ot, dt, bvh.clusters)[2].argmax())
        o = ot[[busy, busy]].clone()
        d = dt[[busy, busy]].clone()
        o[1], d[1] = 1e30, 1.0
        cs = dataclasses.replace(bvh.clusters, valid=bvh.clusters.valid.clone())
        first = int(bin_clusters(o, d, cs)[0][0, 0])
        cs.valid[first] = False
        ids, _, counts = bin_clusters(o, d, cs)
        assert int(counts[1]) == 0 and int(counts[0]) > 0
        assert first not in ids[0, :int(counts[0])].tolist()


# ---------------------------------------------------------------------------
# The small symbols
# ---------------------------------------------------------------------------


def test_woop_mats_and_closest_in_block_match_jax():
    import jax.numpy as jnp

    from directx_raytracer_tpu.ops import intersect as jx

    scene = jts.random_soup(200, seed=9, spread=3.0, size=1.0)
    jgeo, pgeo = geo_pair(scene)
    w4, w3 = px.woop_mats(pgeo.woop)
    jw4, jw3 = jx.woop_mats(jgeo.woop)
    np.testing.assert_array_equal(w4.numpy(), np.asarray(jw4))
    np.testing.assert_array_equal(w3.numpy(), np.asarray(jw3))
    # The operand is the host build's Woop rows, triangle-major.
    assert torch.equal(w4.T.reshape(-1, 3, 4), pgeo.woop)
    assert w4.shape == (4, 3 * pgeo.woop.shape[0]) and w3.shape[0] == 3

    o, d = rays(scene, 24, 18)
    n = o.shape[0]
    carry = (torch.full((n,), float("inf")), torch.full((n,), -1, dtype=torch.int32),
             torch.zeros(n), torch.zeros(n))
    jcarry = (jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32),
              jnp.zeros(n), jnp.zeros(n))
    for base in (0, 128):
        carry = px._closest_in_block(o, d, pgeo.woop[base:base + 128], base,
                                     carry, 1e-3, 1e4)
        jcarry = jx._closest_in_block(o.numpy(), d.numpy(),
                                      jgeo.woop[base:base + 128], base, jcarry,
                                      1e-3, 1e4)
    hit = np.asarray(jcarry[1]) >= 0
    assert hit.sum() > 20
    np.testing.assert_array_equal(carry[1].numpy() >= 0, hit)
    assert (carry[1].numpy() == np.asarray(jcarry[1]))[hit].mean() > 0.99
    np.testing.assert_allclose(carry[0].numpy()[hit], np.asarray(jcarry[0])[hit],
                               rtol=1e-4)
    ref = px.intersect_bruteforce(o, d, pgeo.woop[:256])
    assert torch.equal(carry[1], ref.tri) and torch.equal(carry[0], ref.t)


def test_tile_perm_matches_jax_and_the_tiled_rays():
    from directx_raytracer_tpu.ops.rays import tile_perm as j_tile_perm

    for rows, width in ((48, 96), (36, 64), (7, 5)):
        got, want = tile_perm(rows, width), j_tile_perm(rows, width)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    scene = pts.cornell_box(64, 48)
    pos, rot = scene.camera.snapshot()
    _, raster = generate_rays(pos, rot, 64, 48, device="cpu")
    _, tiled = generate_rays_tiled(pos, rot, 64, 48, 8, 32, device="cpu")
    assert torch.equal(raster[torch.from_numpy(tile_perm(48, 64)).long()], tiled)


def test_cross_and_dot_match_jax():
    from directx_raytracer_tpu.utils import vecmath as jv
    from directx_raytracer_tpu_torch.utils import vecmath as pv

    rng = np.random.default_rng(2)
    a = rng.normal(size=(50, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(pv.cross(t(a), t(b)).numpy(),
                               np.asarray(jv.cross(a, b)), atol=1e-6)
    np.testing.assert_allclose(pv.dot(t(a), t(b)).numpy(),
                               np.asarray(jv.dot(a, b)), atol=1e-6)
    assert pv.dot(t(a), t(b), keepdim=True).shape == (50, 1)


def test_read_png_round_trips_and_reads_filtered_files(tmp_path):
    from PIL import Image

    from directx_raytracer_tpu.utils.image import read_png as j_read_png
    from directx_raytracer_tpu_torch.utils.image import read_png, write_png

    rng = np.random.default_rng(5)
    for shape in ((9, 7, 3), (5, 11), (6, 4, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "own.png")
        write_png(path, img)
        np.testing.assert_array_equal(read_png(path), img)
        np.testing.assert_array_equal(read_png(path), j_read_png(path))
    # A smooth image, which Pillow's encoder writes with Sub/Up/Average/
    # Paeth scanline filters.
    y, x = np.mgrid[0:40, 0:33]
    smooth = np.stack([x * 7 % 256, (x + y) * 3 % 256, y * 5 % 256],
                      axis=-1).astype(np.uint8)
    path = str(tmp_path / "pil.png")
    Image.fromarray(smooth).save(path, optimize=True)
    np.testing.assert_array_equal(read_png(path), smooth)
    (tmp_path / "not.png").write_bytes(b"nope")
    with pytest.raises(ValueError):
        read_png(str(tmp_path / "not.png"))


def test_isect_kwargs_passes_tile_r_only_where_declared():
    from directx_raytracer_tpu.render.debug import isect_kwargs as j_kwargs
    from directx_raytracer_tpu_torch.render.debug import isect_kwargs, render_debug

    def with_tile_r(o, d, geo, tile_r=None):
        return None

    def plain(o, d, geo):
        return None

    for fn in (with_tile_r, plain):
        for tile_r in (None, 768):
            assert isect_kwargs(fn, tile_r) == j_kwargs(fn, tile_r)
    assert isect_kwargs(with_tile_r, 768) == {"tile_r": 768}
    assert isect_kwargs(plain, 768) == {} == isect_kwargs(with_tile_r, None)

    # A three-argument intersector renders.
    scene = pts.single_triangle(32, 24)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    seen = []

    def brute(o, dd, geo):
        seen.append(o.shape[0])
        return px.intersect_bruteforce(o, dd, geo.woop)

    img = render_debug(d, pos, rot, 5, 32, 24, intersect_fn=brute)
    assert torch.equal(img, render_debug(d, pos, rot, 5, 32, 24))
    assert seen == [32 * 24]
