"""The whole slice, torch port vs JAX package: debug frames in all 7 modes,
the Renderer, and the ``viewer render`` command.

The port renders through its Renderer (the BVH path with the kernels'
plain versions above 512 triangle slots, brute force below); the JAX
reference renders with its brute-force oracle.  Modes 3-6 compare pixels:
within 2 u8 levels on >= 99% of pixels (the golden gate of
bench.py:196-206).  Modes 0-2 hash ids through ``sin``, whose last ulps
differ between backends (debug_shading.py precision note), so they
compare the hit ids the hash reads: equal on >= 99.9% of pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.ops import intersect as jx
from directx_raytracer_tpu.ops.rays import generate_rays_tiled as j_rays_tiled
from directx_raytracer_tpu.render.debug import render_debug as j_render_debug
from directx_raytracer_tpu.render.debug import untile as j_untile
from directx_raytracer_tpu.utils.image import to_u8 as j_to_u8
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.ops.debug_shading import MISS_COLOR, NUM_MODES
from directx_raytracer_tpu_torch.ops.intersect import hit_record, intersect_bruteforce
from directx_raytracer_tpu_torch.ops.rays import generate_rays_tiled, pick_schedule
from directx_raytracer_tpu_torch.render.debug import render_debug, untile
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.utils.image import to_u8
from directx_raytracer_tpu_torch.viewer.app import main as viewer_main

torch.set_num_threads(2)

W, H = 96, 48
PIXEL_LEVELS, PIXEL_AGREE = 2, 0.99
ID_AGREE = 0.999
SCENES = {
    "single_triangle": lambda m: m.single_triangle(W, H),
    "bench_scene_3000": lambda m: m.bench_scene(3_000, W, H),
}


class Pair:
    """One scene rendered by both packages, frames cached per mode."""

    def __init__(self, name):
        self.jscene = SCENES[name](jts)
        self.jd = j_build(self.jscene)
        self.renderer = Renderer(SCENES[name](pts), W, H, device="cpu")
        self.pos, self.rot = self.jscene.camera.snapshot()
        self._port, self._jax = {}, {}

    def port(self, mode):
        if mode not in self._port:
            self._port[mode] = self.renderer.render_frame(mode)
        return self._port[mode]

    def jax(self, mode):
        if mode not in self._jax:
            self._jax[mode] = np.asarray(j_render_debug(
                self.jd, self.pos, self.rot, jnp.int32(mode), W, H,
                fetch_record=(mode <= 3)))
        return self._jax[mode]

    def port_ids(self):
        r = self.renderer
        geo = r.dscene.geometry
        tile, tile_r = pick_schedule(H, W)
        o, d = generate_rays_tiled(self.pos, self.rot, W, H, *tile)
        if r.intersect_fn is None:
            hit = intersect_bruteforce(o, d, geo.woop)
        else:
            hit = r.intersect_fn(o, d, geo, tile_r=tile_r)
        _, loc, mesh, _, _ = hit_record(o, d, geo.packed, hit)
        ids = torch.stack([loc, mesh, hit.mask.to(torch.int32)], dim=-1)
        return untile(ids, W, H, tile).numpy()

    def near_cell_edge(self, eps=1e-4):
        tile, _ = pick_schedule(H, W)
        o, d = generate_rays_tiled(self.pos, self.rot, W, H, *tile)
        hit = intersect_bruteforce(o, d, self.renderer.dscene.geometry.woop)
        t = torch.where(hit.mask, hit.t, 0.0)
        p = untile(o + d * t[:, None], W, H, tile).numpy()[..., [0, 2]]
        hits = untile(hit.mask[:, None], W, H, tile).numpy()[..., 0]
        return hits & (np.abs(p - np.round(p)) < eps).any(axis=-1)

    def jax_ids(self):
        tile, _ = pick_schedule(H, W)
        o, d = j_rays_tiled(self.pos, self.rot, W, H, *tile)
        geo = self.jd.geometry
        hit = jx.intersect_bruteforce(o, d, geo.woop)
        _, loc, mesh, _, _ = jx.hit_record(o, d, geo.packed, hit)
        ids = jnp.stack([loc, mesh, hit.mask.astype(jnp.int32)], axis=-1)
        return np.asarray(j_untile(ids, W, H, tile))


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    return Pair(request.param)


def test_renderer_picks_bvh_by_size(pair):
    slots = pair.renderer.dscene.geometry.n_tris
    assert (pair.renderer.bvh is not None) == (slots > 512)


@pytest.mark.parametrize("mode", [3, 4, 5, 6])
def test_geometric_modes_match_jax(pair, mode):
    got, want = to_u8(pair.port(mode)), j_to_u8(pair.jax(mode))
    ok = (np.abs(got.astype(int) - want.astype(int)) <= PIXEL_LEVELS).all(-1)
    if mode == 6:
        # floor() is discontinuous at cell edges: a hit point within 1e-4
        # of an integer x or z takes either color on an ulp of t (the
        # single triangle lies in the plane z = 0), so it is not compared.
        ok |= pair.near_cell_edge()
    assert ok.mean() >= PIXEL_AGREE


def test_hash_modes_read_the_same_ids(pair):
    ids, ref = pair.port_ids(), pair.jax_ids()
    assert ref[..., 2].sum() > 0
    assert (ids == ref).all(axis=-1).mean() >= ID_AGREE


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_hash_modes_cover_the_hits(pair, mode):
    """Hash-mode frames: finite, in [0, 1], and miss-cyan exactly where the
    JAX frame is (the hit mask; colors themselves are per-backend)."""
    img = pair.port(mode).numpy()
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    miss = np.all(img == np.float32(MISS_COLOR), axis=-1)
    jmiss = np.all(pair.jax(mode) == np.float32(MISS_COLOR), axis=-1)
    assert (miss == jmiss).mean() >= ID_AGREE


def test_render_debug_matches_renderer(pair):
    """The Renderer is render_debug with the renderer's intersector."""
    r = pair.renderer
    img = render_debug(r.dscene, pair.pos, pair.rot, 5, W, H,
                       intersect_fn=r.intersect_fn, fetch_record=False)
    assert torch.equal(img, pair.port(5))
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    assert NUM_MODES == 7


def test_viewer_render_writes_png(tmp_path, capsys):
    from PIL import Image

    out = tmp_path / "frame.png"
    viewer_main(["render", "--builtin", "single_triangle", "--width", "64",
                 "--height", "48", "--mode", "5", "--device", "cpu",
                 "-o", str(out)])
    assert "wrote" in capsys.readouterr().out
    want = to_u8(Renderer(pts.single_triangle(), 64, 48, device="cpu")
                 .render_frame(5))
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


def test_describe_devices():
    from directx_raytracer_tpu_torch.render.renderer import describe_devices

    report = describe_devices()
    if torch.cuda.is_available():
        assert report.startswith("cuda:0 ")
    else:
        assert report == "cpu: no CUDA device"
