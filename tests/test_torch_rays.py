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
