"""Ray generation and untiling of the torch port vs the JAX package.

Tolerance: 1e-6 absolute on unit directions — both evaluate the same f32
ops in the same order; rsqrt may round differently by an ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu.ops import rays as jrays
from directx_raytracer_tpu.render.debug import untile as j_untile
from directx_raytracer_tpu_torch.models.camera import Camera
from directx_raytracer_tpu_torch.ops import rays as prays
from directx_raytracer_tpu_torch.render.debug import untile

torch.set_num_threads(2)

ATOL = 1e-6


def cameras():
    bench = Camera((0.0, 14.0, 26.0))
    bench.rotate(0.0, 20.0)
    turned = Camera((1.0, -2.0, 3.0))
    turned.pan(35.0)
    turned.tilt(-10.0)
    turned.roll(5.0)
    return {"identity": Camera(), "bench": bench, "turned": turned}


@pytest.mark.parametrize("size", [(1080, 1920), (48, 96), (32, 64), (40, 64),
                                  (37, 53), (7, 5), (600, 800)])
def test_pick_schedule_matches_jax(size):
    assert prays.pick_schedule(*size) == jrays.pick_schedule(*size)
    assert prays.pick_tile(*size) == jrays.pick_tile(*size)


@pytest.mark.parametrize("cam", sorted(cameras()))
@pytest.mark.parametrize("size", [(96, 48), (65, 49)])
def test_generate_rays_matches_jax(cam, size):
    pos, rot = cameras()[cam].snapshot()
    w, h = size
    o, d = prays.generate_rays(pos, rot, w, h, device="cpu")
    jo, jd = jrays.generate_rays(pos, rot, w, h)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cam", sorted(cameras()))
@pytest.mark.parametrize("size,tile", [((96, 48), (24, 32)),
                                       ((64, 40), (20, 32)),
                                       ((64, 32), (8, 32))])
def test_generate_rays_tiled_matches_jax(cam, size, tile):
    pos, rot = cameras()[cam].snapshot()
    w, h = size
    o, d = prays.generate_rays_tiled(pos, rot, w, h, *tile, device="cpu")
    jo, jd = jrays.generate_rays_tiled(pos, rot, w, h, *tile)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    # Untiling the tile-major rays gives the row-major rays back.
    _, d_raster = prays.generate_rays(pos, rot, w, h, device="cpu")
    np.testing.assert_allclose(untile(d, w, h, tile).reshape(-1, 3).numpy(),
                               d_raster.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("tile", [(24, 32), (4, 8), None])
def test_untile_matches_jax(tile):
    """Tolerance: none — a pure permutation."""
    w, h = 96, 48
    flat = np.random.default_rng(1).standard_normal((w * h, 3)).astype(np.float32)
    got = untile(torch.from_numpy(flat), w, h, tile).numpy()
    want = np.asarray(j_untile(jnp.asarray(flat), w, h, tile))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset", [(0.375, 0.125), (1.0 / 6.0, 0.5 + 1.0 / 6.0),
                                    (0.0, 1.0)])
def test_offsets_match_jax(offset):
    """Sub-pixel offsets (RGSS and Hammersley samples) in both raygens."""
    pos, rot = cameras()["bench"].snapshot()
    w, h = 96, 48
    o, d = prays.generate_rays(pos, rot, w, h, offset, device="cpu")
    jo, jd = jrays.generate_rays(pos, rot, w, h, offset)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    o, d = prays.generate_rays_tiled(pos, rot, w, h, 24, 32, offset,
                                     device="cpu")
    jo, jd = jrays.generate_rays_tiled(pos, rot, w, h, 24, 32, offset)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    assert prays.RGSS_OFFSETS == jrays.RGSS_OFFSETS


@pytest.mark.parametrize("row_start,rows", [(0, 24), (24, 24), (8, 16),
                                            (5, 7), (41, 7)])
def test_row_bands_match_jax(row_start, rows):
    """``row_start``/``rows``: the band of the row-major raygen is exactly
    that slice of the port's own full frame (the same ops on the same pixel
    coordinates), and agrees with the JAX band like the full frame does.
    Even bands (the frame cut in two, a tile-aligned inner band) and uneven
    ones (7 rows from row 5, the last 7 rows)."""
    pos, rot = cameras()["turned"].snapshot()
    w, h = 64, 48
    off = (0.25, 0.75)
    o, d = prays.generate_rays(pos, rot, w, h, off, row_start, rows, device="cpu")
    jo, jd = jrays.generate_rays(pos, rot, w, h, off, row_start, rows)
    assert d.shape == (rows * w, 3) and o.shape == (rows * w, 3)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    _, full = prays.generate_rays(pos, rot, w, h, off, device="cpu")
    np.testing.assert_array_equal(
        d.numpy(), full.reshape(h, w, 3)[row_start:row_start + rows]
        .reshape(-1, 3).numpy())


@pytest.mark.parametrize("row_start,rows,tile", [(0, 24, (24, 32)),
                                                 (24, 24, (8, 32)),
                                                 (16, 8, (8, 32)),
                                                 (5, 14, (7, 16))])
def test_tiled_row_bands_match_jax(row_start, rows, tile):
    """The tile-major band: tiles are counted inside the band, and
    untiling it gives the row-major band exactly."""
    pos, rot = cameras()["bench"].snapshot()
    w, h = 64, 48
    off = (0.625, 0.875)
    o, d = prays.generate_rays_tiled(pos, rot, w, h, *tile, off, row_start,
                                     rows, device="cpu")
    jo, jd = jrays.generate_rays_tiled(pos, rot, w, h, *tile, off, row_start,
                                       rows)
    assert d.shape == (rows * w, 3)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    _, band = prays.generate_rays(pos, rot, w, h, off, row_start, rows,
                                  device="cpu")
    np.testing.assert_array_equal(
        untile(d, w, rows, tile).reshape(-1, 3).numpy(), band.numpy())
