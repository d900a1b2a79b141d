"""Multi-device rendering of the torch port (``parallel/``) on the CPU,
against its own single-device renderers and the JAX package's
``render_whitted_multichip`` on the virtual 8-device mesh.

Two layers, as the port has them: the shard functions summed and
concatenated over every (t, s) in one process (the grids of
tests/test_sharding.py), and the collective entry points in four spawned
gloo processes (a 2 x 2 grid).  The spawned functions live at module level
and this module imports jax only inside the tests that compare with it, so
a spawned child imports torch and the port alone.

Tolerances: shard sums against the single-device frame 1e-5 absolute (the
same rays; the sample sum runs in another order), 1e-4 at spp 3 (the
reference's own figure for f32 accumulation noise, tests/test_sharding.py:
77-79); against the JAX frame the Whitted parity gate of
tests/test_torch_whitted.py (2 u8 levels on >= 99% of pixels); the
path-traced 2 x 2 accumulation against a single-device PathTracer the
block-mean gate of tests/test_sharding.py:118-125."""

import numpy as np
import pytest
import torch

from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.models.scene import build_device_scene
from directx_raytracer_tpu_torch.parallel import (
    global_mesh_shape,
    init_distributed,
    launch,
    local_device,
    make_global_mesh,
    make_mesh,
    pathtrace_multichip,
    pathtrace_shard,
    render_whitted_multichip,
    untile_multichip,
    whitted_shard,
)
from directx_raytracer_tpu_torch.parallel.sharding import fold_in
from directx_raytracer_tpu_torch.render import render_whitted
from directx_raytracer_tpu_torch.render.pathtrace import PathTracer
from directx_raytracer_tpu_torch.utils.image import to_u8

torch.set_num_threads(2)

W = 64
SPAWN_TIMEOUT = 240  # seconds: a hung rendezvous fails the test, not the suite
PIXEL_LEVELS, PIXEL_AGREE = 2, 0.99

# name -> (n_tiles, n_samples, height, render kwargs, atol)
GRIDS = {
    "tiles8": (8, 1, 48, dict(max_depth=3), 1e-5),
    "tiles2_samples4_spp4": (2, 4, 48, dict(max_depth=2, spp=4), 1e-5),
    "tiles8_height47": (8, 1, 47, dict(max_depth=2), 1e-5),
    "tiles4_samples2_spp3": (4, 2, 48, dict(max_depth=2, spp=3), 1e-4),
    "samples8_spp16": (1, 8, 48, dict(max_depth=2, spp=16), 1e-5),
}


@pytest.fixture(scope="module")
def cornell():
    scene = pts.cornell_box(W, 48)
    return scene, build_device_scene(scene, "cpu")


def sum_shards(d, pos, rot, height, n_tiles, n_samples, **kw):
    """The frame and stats of an (n_tiles, n_samples) grid, every shard
    computed here: summed over s, concatenated over t, cropped."""
    stripes, stats = [], None
    for t in range(n_tiles):
        acc = None
        for s in range(n_samples):
            img, st = whitted_shard(d, pos, rot, W, height, n_tiles,
                                    n_samples, t, s, **kw)
            acc = img if acc is None else acc + img
            stats = st if stats is None else {k: stats[k] + st[k] for k in st}
        stripes.append(acc)
    return torch.cat(stripes)[:height], stats


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shards_sum_to_single_device_frame(cornell, name):
    n_tiles, n_samples, height, kw, atol = GRIDS[name]
    scene, d = cornell
    pos, rot = scene.camera.snapshot()
    img, stats = sum_shards(d, pos, rot, height, n_tiles, n_samples, **kw)
    ref, ref_stats = render_whitted(d, pos, rot, W, height, **kw)
    assert img.shape == (height, W, 3)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=atol, rtol=0)
    assert int(stats["dropped"].sum()) == int(ref_stats["dropped"].sum())
    assert ref.max() > 0.05


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shards_match_jax_multichip(cornell, name):
    """The JAX package's shard_map frame on the virtual 8-device CPU mesh
    against the port's shard sums, at the Whitted parity gate."""
    import jax

    from directx_raytracer_tpu import testscenes as jts
    from directx_raytracer_tpu.models.scene import build_device_scene as j_build
    from directx_raytracer_tpu.parallel import make_mesh as j_make_mesh
    from directx_raytracer_tpu.parallel import (
        render_whitted_multichip as j_multichip,
    )
    from directx_raytracer_tpu.utils.image import to_u8 as j_to_u8

    n_tiles, n_samples, height, kw, _ = GRIDS[name]
    assert jax.device_count() >= 8
    scene, d = cornell
    pos, rot = scene.camera.snapshot()
    img, _ = sum_shards(d, pos, rot, height, n_tiles, n_samples, **kw)
    jscene = jts.cornell_box(W, 48)
    jimg, _ = j_multichip(j_build(jscene), pos, rot, W, height,
                          j_make_mesh(n_tiles=n_tiles, n_samples=n_samples),
                          **kw)
    diff = np.abs(to_u8(img).astype(int) - j_to_u8(np.asarray(jimg)).astype(int))
    assert ((diff <= PIXEL_LEVELS).all(axis=-1)).mean() >= PIXEL_AGREE


def test_bounce_stats_sum_over_shards():
    """A scene whose queue holds live rays (a mirror floor): the alive
    counts summed over a 2 x 2 grid equal the single-device frame's."""
    scene = pts.bench_scene(3_000, 96, 48)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    kw = dict(max_depth=3, spp=2)
    ref, ref_stats = render_whitted(d, pos, rot, 96, 48, **kw)
    stripes, alive = [], 0
    for t in range(2):
        acc = 0
        for s in range(2):
            img, st = whitted_shard(d, pos, rot, 96, 48, 2, 2, t, s, **kw)
            acc = acc + img
            alive += int(st["alive"].sum())
        stripes.append(acc)
    np.testing.assert_allclose(torch.cat(stripes).numpy(), ref.numpy(),
                               atol=1e-5, rtol=0)
    assert alive == int(ref_stats["alive"].sum()) > 0


# ---------------------------------------------------------------------------
# The collective entry points, in spawned gloo processes
# ---------------------------------------------------------------------------


def _whitted_rank(rank, world, height, kw):
    torch.set_num_threads(1)
    scene = pts.cornell_box(W, 48)
    d = build_device_scene(scene, local_device("cpu"))
    pos, rot = scene.camera.snapshot()
    mesh = make_mesh(n_tiles=2, n_samples=2)
    global_mesh = make_global_mesh(n_samples=2)
    img, stats = render_whitted_multichip(d, pos, rot, W, height, mesh, **kw)
    from directx_raytracer_tpu_torch.render.renderer import describe_devices

    return dict(coords=mesh.coords, global_coords=global_mesh.coords,
                shape=global_mesh.shape, img=img, stats=stats,
                devices=describe_devices())


def _pathtrace_rank(rank, world, spp, depth):
    torch.set_num_threads(1)
    scene = pts.cornell_box(W, 48, light_intensity=60.0)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    mesh = make_mesh(n_tiles=2, n_samples=2)
    acc = pathtrace_multichip(d, pos, rot, 0, W, 48, mesh, spp=spp,
                              max_depth=depth)
    return untile_multichip(acc / spp, W, 48, 2)


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")


def test_spawned_2x2_whitted_equals_single_device(cornell):
    """Four gloo processes, height 47 (a padded stripe) and spp 3 (a padded
    sample): every rank holds the whole frame, equal to the single-device
    one."""
    scene, d = cornell
    pos, rot = scene.camera.snapshot()
    kw = dict(max_depth=2, spp=3)
    out = launch(_whitted_rank, 4, (47, kw), timeout=SPAWN_TIMEOUT,
                 device="cpu")
    ref, ref_stats = render_whitted(d, pos, rot, W, 47, **kw)
    assert [o["coords"] for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in out:
        assert o["global_coords"] == o["coords"]
        assert o["shape"] == {"tiles": 2, "samples": 2}
        assert o["img"].shape == (47, W, 3)
        np.testing.assert_allclose(o["img"].numpy(), ref.numpy(), atol=1e-4,
                                   rtol=0)
        assert int(o["stats"]["dropped"].sum()) == 0
        assert "of 4 processes, backend gloo" in o["devices"]


def test_spawned_2x2_pathtrace_converges_like_single_device():
    spp = 16
    out = launch(_pathtrace_rank, 4, (spp, 3), timeout=SPAWN_TIMEOUT,
                 device="cpu")
    img_mc = out[0].numpy()
    for o in out[1:]:  # every rank holds the same accumulation
        np.testing.assert_array_equal(o.numpy(), img_mc)
    assert img_mc.shape == (48, W, 3)
    assert np.isfinite(img_mc).all() and (img_mc >= 0).all()

    scene = pts.cornell_box(W, 48, light_intensity=60.0)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    pt = PathTracer(d, W, 48, max_depth=3, seed=9).step(pos, rot, n=spp)
    img_sc = pt.image().numpy()
    # Independent streams at 16 spp are individually noisy; block averaging
    # (12x16 pixels) collapses the Monte Carlo error so the two estimators
    # must agree structurally.
    blk = lambda im: im.reshape(4, 12, 4, 16, 3).mean(axis=(1, 3))
    a, b = blk(img_mc), blk(img_sc)
    rel = np.abs(a - b).mean(axis=-1) / (0.5 + b.mean(axis=-1))
    assert rel.max() < 0.2
    assert abs(img_mc.mean() - img_sc.mean()) < 0.05


def test_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails"):
        launch(_failing_rank, 2, timeout=SPAWN_TIMEOUT, device="cpu")


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


def test_pathtrace_shard_streams():
    """The same (seed, t, s, i) always gives the same sample; two shards
    never share a stream; a 1 x 1 grid without a process group is the
    shard itself, rescaled."""
    scene = pts.cornell_box(32, 24, light_intensity=60.0)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    args = (d, pos, rot, 5, 32, 24)
    a = pathtrace_shard(*args, 1, 2, 0, 0, spp=2, max_depth=2)
    again = pathtrace_shard(*args, 1, 2, 0, 0, spp=2, max_depth=2)
    other = pathtrace_shard(*args, 1, 2, 0, 1, spp=2, max_depth=2)
    assert torch.equal(a, again)
    assert not torch.equal(a, other)
    assert a.shape == (24 * 32, 3) and torch.isfinite(a).all() and a.max() > 0
    seeds = {fold_in(5, t, s, i) for t in range(4) for s in range(4)
             for i in range(4)}
    assert len(seeds) == 64 and all(0 <= x < 2**63 for x in seeds)
    assert fold_in(5, 1, 2, 3) == fold_in(5, 1, 2, 3) != fold_in(6, 1, 2, 3)

    mesh = make_mesh()
    assert mesh.shape == {"tiles": 1, "samples": 1} and mesh.coords == (0, 0)
    whole = pathtrace_multichip(*args, mesh, spp=1, max_depth=2)
    assert torch.equal(whole, pathtrace_shard(*args, 1, 1, 0, 0, spp=1,
                                              max_depth=2))
    with pytest.raises(ValueError):
        make_mesh(n_tiles=2)


def test_untile_multichip_matches_jax():
    from directx_raytracer_tpu.parallel import untile_multichip as j_untile

    rng = np.random.default_rng(3)
    for width, height, n_tiles in ((64, 48, 4), (64, 47, 8), (96, 40, 2)):
        rows = -(-height // n_tiles)
        flat = rng.normal(size=(n_tiles * rows * width, 3)).astype(np.float32)
        got = untile_multichip(torch.from_numpy(flat), width, height, n_tiles)
        want = np.asarray(j_untile(flat, width, height, n_tiles))
        assert got.shape == (height, width, 3)
        np.testing.assert_array_equal(got.numpy(), want)


class TestMultihost:
    def test_global_mesh_shape(self):
        assert global_mesh_shape(8, 1) == (8, 1)
        assert global_mesh_shape(8, 4) == (2, 4)
        assert global_mesh_shape(8, 3) == (4, 2)  # clamped to a divisor
        assert global_mesh_shape(1, 4) == (1, 1)
        with pytest.raises(ValueError):
            global_mesh_shape(0)

    def test_global_mesh_shape_matches_jax(self):
        from directx_raytracer_tpu.parallel import global_mesh_shape as j_shape

        for n in range(1, 17):
            for s in range(0, 9):
                assert global_mesh_shape(n, s) == j_shape(n, s)

    def test_make_global_mesh_local(self):
        mesh = make_global_mesh(n_samples=2)
        assert mesh.axis_names == ("tiles", "samples")
        assert mesh.shape["tiles"] * mesh.shape["samples"] == 1

    def test_single_process_init_noop(self):
        import torch.distributed as dist

        assert init_distributed() == 1
        assert not dist.is_initialized()

    def test_backend_follows_the_callers_device(self, monkeypatch):
        """nccl only where every process has a card of its own and the
        caller did not name the CPU; a named backend is taken as it is."""
        import torch.distributed as dist

        seen = []
        monkeypatch.setattr(dist, "init_process_group",
                            lambda **kw: seen.append(kw["backend"]))
        monkeypatch.setattr(dist, "get_world_size", lambda: 4)
        monkeypatch.setattr(dist, "get_rank", lambda: 0)
        monkeypatch.setattr(dist, "get_backend", lambda: seen[-1])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert init_distributed("localhost:1", 4, 0) == 4
        assert init_distributed("localhost:1", 4, 0, backend="gloo") == 4
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert init_distributed("localhost:1", 4, 0) == 4
        assert seen == ["nccl", "gloo", "gloo"]

    def test_local_device_never_silently_cpu(self):
        assert local_device("cpu") == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                local_device()
