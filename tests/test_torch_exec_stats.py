"""The closest-hit walk's executed-visit count and the measurement tools
built on it (tools/exec_stats.py, kernel_micro.py, cull_stats.py), torch
port vs JAX package, on the CPU (the kernels through their plain versions).

Both packages get the same buffers: the JAX clusters and rays handed over
as numpy, and, for the count, the same visit lists: the port's
``bin_lists`` lists (near to far) are the JAX schedule's table at g = 1
(one cluster a grid step), so the TPU kernel's per-step skip and the port's
break stop a tile at the same position.  The JAX kernel runs
``_launch(count_exec=True)`` in interpret mode, as
tests/test_pallas_interpret.py:273-315 runs it.

Tolerances: executed totals within 1% and per-tile counts equal on >= 99%
of tiles (the TPU kernel's bf16x3 products and packed-t truncation may
flip the gate on a knife-edge entry); the count's build leaves results
bit-equal; pairs per ray of cull_stats equal JAX's
``bin_clusters_bits(impl="xla")`` counts exactly (the same slab test)."""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.bvh import build_bvh as j_build_bvh
from directx_raytracer_tpu.bvh import pallas_intersect as jpi
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.ops.rays import generate_rays_tiled as j_rays_tiled
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.bvh import clusters_from_numpy
from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.tools import cull_stats, exec_stats, kernel_micro
from test_torch_intersect import numpy_leaves

torch.set_num_threads(2)

W, H, TILE, TILE_R = 96, 48, (24, 32), 256  # the interpret-mode fixture
EXEC_TOTAL_RTOL = 0.01
EXEC_TILE_AGREE = 0.99


@pytest.fixture(scope="module")
def fx():
    scene = jts.bench_scene(3_000, W, H)
    jbvh = j_build_bvh(j_build(scene).geometry)
    pos, rot = scene.camera.snapshot()
    jo, jd = j_rays_tiled(pos, rot, W, H, *TILE)
    cs = clusters_from_numpy(numpy_leaves(jbvh.clusters), "cpu")
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    tp = ci.tile_params(o, d, TILE_R)
    visit, ventry, counts, width = ci.bin_lists(tp, ci.cluster_rows(cs))
    return SimpleNamespace(jbvh=jbvh, jo=jo, jd=jd, o=o, d=d, cs=cs,
                           wrows=ci.woop_rows(cs), tp=tp, visit=visit,
                           ventry=ventry, counts=counts, width=width)


def seeds(fx, kind):
    n = fx.o.shape[0]
    t = torch.full((n,), 10000.0)
    return t if kind == "10000" else ci.scene_exit_seed(fx.o, fx.d, fx.cs, t)


def jax_executed(fx, init_t) -> np.ndarray:
    """Per-tile executed visits of the TPU kernel's counting build, on the
    port's lists at g = 1 (interpret mode)."""
    tiles, c = fx.counts.shape[0], fx.cs.aabb_min.shape[0]
    visit, ventry, counts = fx.visit.numpy(), fx.ventry.numpy(), fx.counts.numpy()
    entry = np.full((tiles, c), jpi.BIG, np.float32)
    for t in range(tiles):
        entry[t, visit[t, :counts[t]]] = ventry[t, :counts[t]]
    budget = 1 << int(np.ceil(np.log2(max(int(counts.sum()), 2))))
    vt, vcs, vf, ve, rem = jpi.build_visit_groups_table(
        jnp.asarray(visit), jnp.asarray(entry), jnp.asarray(counts), budget, 1)
    assert int(rem) == 0 and len(vcs) == 1
    n = fx.o.shape[0]
    rays8 = jnp.concatenate(
        [fx.jo, jnp.ones((n, 1), jnp.float32), fx.jd,
         jnp.zeros((n, 1), jnp.float32)], axis=1).reshape(
        tiles, TILE_R, 8).swapaxes(1, 2)
    rays8 = jpi.rays_split(jnp.concatenate(
        [rays8, jnp.zeros((1, 8, TILE_R), jnp.float32)]))
    jt = jnp.concatenate([jnp.asarray(init_t.numpy()).reshape(tiles, 1, TILE_R),
                          jnp.zeros((1, 1, TILE_R), jnp.float32)])
    slot = jnp.full((tiles + 1, 1, TILE_R), -1, jnp.int32)
    _, _, ec = jpi._launch(rays8, jt, slot, vt, vcs, vf, ve, fx.jbvh.wplanar,
                           k=fx.cs.k, tile_r=TILE_R, budget=budget,
                           count_exec=True)
    return np.bincount(np.asarray(vt), weights=np.asarray(ec),
                       minlength=tiles + 1)[:tiles].astype(np.int64)


@pytest.mark.parametrize("kind", ["10000", "scene_exit"])
def test_count_exec_matches_jax_kernel(fx, kind):
    """The port's executed visits per tile against the TPU kernel's
    count_exec build on the same lists and seeds.  With the scene-exit
    seeds the early-out fires (a tile stops short of its list)."""
    init_t = seeds(fx, kind)
    _, _, port, _ = ci.closest_hit(fx.o, fx.d, init_t, fx.wrows,
                                   ci.cull_rows(fx.wrows), fx.visit, fx.ventry,
                                   fx.counts, TILE_R, count_exec=True)
    port = port.numpy().astype(np.int64)
    want = jax_executed(fx, init_t)
    assert port.sum() > 0
    assert abs(int(port.sum()) - int(want.sum())) <= EXEC_TOTAL_RTOL * want.sum()
    assert (port == want).mean() >= EXEC_TILE_AGREE
    assert (port <= fx.counts.numpy()).all()
    if kind == "scene_exit":
        assert port.sum() < fx.counts.sum()  # the early-out fired


@pytest.mark.parametrize("tile_r", [768, 256, 100])
def test_count_exec_leaves_results_unchanged(small, tile_r):
    """count_exec=True: best t and slot bit-equal to the plain call, and
    visits <= counts per tile; the stats' visit total equals their sum."""
    b = exec_stats.ray_batch(small, *_primary_rays(small), tile_r)
    bt, bs = ci.closest_hit(*b.args(), width=b.width)
    stats = {}
    bt2, bs2, visits, _ = ci.closest_hit_plain(*b.args(), stats=stats,
                                               count_exec=True)
    assert torch.equal(bt.view(torch.int32), bt2.view(torch.int32))
    assert torch.equal(bs, bs2)
    assert visits.dtype == torch.int32 and visits.shape == b.counts.shape
    assert bool((visits <= b.counts).all()) and int(visits.sum()) == stats["visits"]
    assert torch.equal(ci.closest_hit(*b.args(), count_exec=True, chunk=1)[2],
                       visits)


def _primary_rays(r):
    from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled

    pos, rot = r.camera.snapshot()
    return generate_rays_tiled(pos, rot, r.width, r.height, 8, 32, device="cpu")


@pytest.fixture(scope="module")
def small():
    return Renderer(pts.bench_scene(3_000, W, H), W, H, device="cpu")


def test_exec_stats_counts_the_primary_batch(small, capsys):
    c = exec_stats.run(small)
    b = exec_stats.primary_batch(small)
    assert c["scheduled"] == int(b.counts.sum()) > 0
    assert c["executed"] == c["plain"] <= c["scheduled"]  # the plain walk on CPU
    assert c["items"] == exec_stats.work_items(b.counts)
    assert c["pairs_sched"] == pytest.approx(float(b.counts.double().mean()) * 128)
    assert re.search(r"scheduled visits=\d+ executed=\d+ \(\d+\.\d%\) plain "
                     r"walk=\d+; pairs/ray sched=[\d.]+ exec=[\d.]+; work "
                     r"items=\d+, longest list \d+; cull share [\d.]+% "
                     r"\(\d+ 32-ray groups tested\), plain walk [\d.]+% "
                     r"\[cpu\]",
                     capsys.readouterr().out)


def test_exec_stats_main_on_the_cpu(capsys):
    assert exec_stats.main(["3000", "--width", "96", "--height", "48",
                            "--device", "cpu"]) == 0
    assert "ntris=3000 96x48 primary: 6 tiles x 768 rays" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [exec_stats, kernel_micro, cull_stats])
def test_tools_refuse_without_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main(["3000"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_micro_split():
    s = kernel_micro.split(e_real=1.2, e_all=1.7, e_none=0.1, items=4_000,
                           listed=8_000)
    assert s["machinery_us_per_item"] == pytest.approx(0.025)
    assert s["compute_us_per_visit"] == pytest.approx(0.2)
    assert s["early_out_saves"] == pytest.approx(0.5 / 1.7)


@pytest.mark.parametrize("tile_r", [64, 768])  # the finest and coarsest
def test_cull_stats_pairs_match_jax(fx, tile_r):
    """Pairs per ray and clusters per tile against JAX's binner on the same
    tiles of the same rays (8x32 pixel tiles, ``tile_r`` rays a tile)."""
    scene = jts.bench_scene(3_000, W, H)
    pos, rot = scene.camera.snapshot()
    jo, jd = j_rays_tiled(pos, rot, W, H, 8, 32)
    tiles = jo.shape[0] // tile_r
    n = tiles * tile_r
    want = np.asarray(jpi.bin_clusters_bits(
        jo[:n].reshape(tiles, tile_r, 3), jd[:n].reshape(tiles, tile_r, 3),
        fx.jbvh.clusters, impl="xla")[3])
    got = cull_stats.counts_at(torch.from_numpy(np.array(jo)),
                               torch.from_numpy(np.array(jd)),
                               ci.cluster_rows(fx.cs), tile_r)
    np.testing.assert_array_equal(got.numpy(), want)
    s = cull_stats.stats(got, fx.cs.k)
    assert s["pairs_per_ray"] == pytest.approx(want.mean() * fx.cs.k)
    assert s["max"] == want.max() and s["items"] == exec_stats.work_items(got)


def test_cull_stats_run_prints_every_tile_size(small, capsys):
    out = cull_stats.run(small)
    assert sorted(out) == sorted(cull_stats.TILE_RS)
    text = capsys.readouterr().out
    for tile_r in cull_stats.TILE_RS:
        assert f"tile_r={tile_r:4d}: pairs/ray=" in text
