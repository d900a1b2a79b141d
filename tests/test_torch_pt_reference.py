"""The path tracer's keyed draws and the plain reference that judges it
(``benchmark/reference/pathtrace.py``), on the CPU.

* The draws' pure-torch twin (``ops/draws.py``) equals the reference's own
  integer code (Philox4x32-10 on numpy's uint64) bit for bit, and both give
  Random123's known answers.
* A pass's uniforms follow each row's pixel: a permuted queue, another
  pixel tiling or a row band draw the same numbers for the same pixel.
* Uniformity over 2^20 draws a stream.  The draws are a fixed function of
  fixed inputs, so these limits cannot flake; each sits at about six
  standard deviations of a true uniform sample (about 1e-9 two-sided),
  far above any real defect's reading:
  mean within 6 sqrt(1/12/n) = 1.69e-3 of 1/2; variance within
  6 sqrt((1/80 - 1/144)/n) = 4.37e-4 of 1/12; the 16-bin chi-square
  (15 degrees of freedom) below 73.6, its 1 - 1e-9 quantile.
* The port's ``PathTracer`` (plain kernels) against the reference over
  every pixel of a depth-4 sample of the bench scene at 96 x 48: held to
  the ``pt_100k`` cell's rule (off pixels over graded-or-off pixels within
  the cell's ``off_pct`` limit).
* ``PathTracer`` keys sample k by (seed, k), restarts at ``reset()``, and
  a checkpoint resumes equal to never having stopped.
* A sample's host syncs are the camera's two and the Whitted passes'
  sites: the keyed draws and the jitter add none.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import port  # noqa: E402
from benchmark.harness import to_u8  # noqa: E402
from benchmark.reference import pathtrace as ref  # noqa: E402
from benchmark.reference.geometry import Triangles  # noqa: E402
from benchmark.scenes import bench_scene  # noqa: E402
from directx_raytracer_tpu_torch.ops import draws  # noqa: E402
from directx_raytracer_tpu_torch.ops.rays import pick_schedule  # noqa: E402
from directx_raytracer_tpu_torch.render import pathtrace as ppt  # noqa: E402
from directx_raytracer_tpu_torch.render import wavefront as wf  # noqa: E402
from directx_raytracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from directx_raytracer_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

W, H, DEPTH = 96, 48, 4
N_UNIFORM = 2**20
MEAN_TOL, VAR_TOL, CHI2_MAX = 1.69e-3, 4.37e-4, 73.6
CELL = json.loads((ROOT / "benchmark" / "cells" / "pt_100k.json").read_text())

# Random123's known answers for Philox4x32-10: (counter, key) -> output.
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


def key_words(key: int):
    return key & 0xFFFFFFFF, key >> 32


# ---------------------------------------------------------------------------
# The twin against the reference's integer code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    assert tuple(draws.philox_plain(*counter, key[0] | key[1] << 32)) == want
    got = draws.philox_plain(torch.tensor([counter[0]]), *counter[1:],
                             key[0] | key[1] << 32)
    assert tuple(int(w[0]) for w in got) == want
    assert tuple(int(w) for w in ref.philox(*counter, *key)) == want


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**63 + 5])
def test_twin_equals_the_reference_integer_code(seed):
    rng = np.random.default_rng(seed % 2**32)
    raster = rng.integers(0, 1920 * 1080, size=50_000)
    ids = torch.from_numpy(raster).to(torch.int32)
    row_major = draws.Layout(1, 1920, 1920)
    for k in (0, 1, 2**33 + 1):
        key = draws.sample_key(seed, k)
        assert key_words(key) == ref.sample_key(seed, k)
        assert tuple(draws.jitter_plain(key, "cpu").double().tolist()) == \
            ref.jitter(key_words(key))
        for bounce in (0, 1, 3):
            got = draws.pt_draws_plain(ids, key, bounce, row_major)
            assert got.dtype == torch.float32 and got.shape == (4, raster.size)
            want = ref.uniforms(key_words(key), raster, bounce)
            np.testing.assert_array_equal(got.double().numpy(), want)
            assert got.min() >= 0 and got.max() < 1


# ---------------------------------------------------------------------------
# Draws follow the pixel, not the queue
# ---------------------------------------------------------------------------


def tile_major_ids(tile, width, rows):
    """(raster-order grid of tile-major ids) for ``pick_schedule``'s tile."""
    th, tw = tile
    idx = np.arange(rows * width).reshape(rows // th, width // tw, th, tw)
    return torch.from_numpy(idx.transpose(0, 2, 1, 3).reshape(rows, width).copy())


def test_a_permuted_queue_draws_the_same_numbers_a_row():
    key = draws.sample_key(3, 1)
    tile, _ = pick_schedule(1080, 1920)
    layout = draws.Layout.of(tile, 1920)
    ids = torch.randperm(1920 * 1080, generator=torch.Generator().manual_seed(1))
    ids = ids[:300_000].to(torch.int32)
    base = ppt._draw(key, layout, ids, 2)
    for seed in range(3):
        perm = torch.randperm(ids.shape[0], generator=torch.Generator().manual_seed(seed))
        assert torch.equal(ppt._draw(key, layout, ids[perm], 2), base[:, perm])


def test_tiles_and_bands_key_by_the_raster_pixel():
    """The same pixel draws the same numbers whether the queue holds its
    tile-major id, its row-major id or its id inside a band of rows."""
    key = draws.sample_key(11, 0)
    width, height = 96, 48
    tile, _ = pick_schedule(height, width)
    grid = tile_major_ids(tile, width, height)  # grid[py, px] = tile-major id
    tiled = draws.pt_draws_plain(grid.reshape(-1), key, 1, draws.Layout.of(tile, width))
    plain = draws.pt_draws_plain(torch.arange(width * height), key, 1,
                                 draws.Layout.of(None, width))
    assert torch.equal(tiled, plain)
    rows = 24
    band_tile, _ = pick_schedule(rows, width)
    band = tile_major_ids(band_tile, width, rows).reshape(-1)
    lower = draws.pt_draws_plain(band, key, 1, draws.Layout.of(band_tile, width, rows))
    assert torch.equal(lower, plain[:, rows * width:])


@pytest.mark.parametrize("stream", range(4))
def test_draws_are_uniform(stream):
    key = draws.sample_key(0, 0)
    u = draws.pt_draws_plain(torch.arange(N_UNIFORM), key, 1,
                             draws.Layout(1, 1920, 1920))[stream].double()
    assert abs(float(u.mean()) - 0.5) < MEAN_TOL
    assert abs(float(u.var()) - 1.0 / 12.0) < VAR_TOL
    counts = torch.bincount((u * 16).long(), minlength=16).double()
    expected = N_UNIFORM / 16
    assert float(((counts - expected) ** 2 / expected).sum()) < CHI2_MAX


# ---------------------------------------------------------------------------
# The port against the plain reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench():
    data = bench_scene.build(2**31 + 11, n_tris=3_000, width=W, height=H)
    r = Renderer(port.port_scene(data), W, H, device="cpu", use_kernels=True)
    return data, r


def test_sample_matches_the_plain_reference(bench):
    data, r = bench
    pt = ppt.PathTracer(r.dscene, W, H, max_depth=DEPTH, seed=0,
                        intersect_fn=r.intersect_fn,
                        occluder_factory=r.occluder_factory)
    pos, rot = r.camera.snapshot()
    pt.step(pos, rot)
    got = r.to_u8_device(pt.image()).reshape(-1, 3).long()
    flat = torch.arange(W * H)
    linear = ref.render_pixels(Triangles(data, "cpu"), data, (pos, rot), flat % W,
                               flat // W, {"max_depth": DEPTH, "seed": 0})
    bad = (got != to_u8(linear)).any(dim=1)
    graded = ((linear > 0) & (linear < 1)).any(dim=1)
    off_pct = 100.0 * int(bad.sum()) / max(int((bad | graded).sum()), 1)
    print(f"off {int(bad.sum())} of {int((bad | graded).sum())} graded-or-off pixels")
    assert int(graded.sum()) > W * H // 4  # the scene fills the frame
    assert off_pct <= CELL["limits"]["off_pct"]


# ---------------------------------------------------------------------------
# Sample keys, reset and checkpoints
# ---------------------------------------------------------------------------


def test_sample_k_is_keyed_by_seed_and_k_and_reset_restarts(bench, tmp_path):
    _, r = bench
    pos, rot = r.camera.snapshot()

    def tracer(seed):
        return ppt.PathTracer(r.dscene, W, H, max_depth=2, seed=seed)

    def sample(key):
        return ppt.pathtrace_sample(r.dscene, pos, rot, key, W, H, max_depth=2)

    pt = tracer(5).step(pos, rot, n=2)
    assert torch.equal(pt.accum, sample(draws.sample_key(5, 0))
                       + sample(draws.sample_key(5, 1)))
    pt.reset()
    assert pt.n_samples == 0 and not pt.accum.any()
    assert torch.equal(pt.step(pos, rot).image(), tracer(5).step(pos, rot).image())
    assert not torch.equal(tracer(6).step(pos, rot).accum, pt.accum)

    # A checkpoint after 2 samples, resumed by a tracer of another seed,
    # then 1 more sample: equal to 3 samples in one go.
    pt = tracer(5).step(pos, rot, n=2)
    ckpt = str(tmp_path / "state.npz")
    pt.save_state(ckpt)
    resumed = tracer(9)
    resumed.load_state(ckpt)
    assert resumed.seed == 5 and resumed.n_samples == 2
    resumed.step(pos, rot)
    assert torch.equal(resumed.image(), tracer(5).step(pos, rot, n=3).image())


def test_a_sample_adds_no_host_sync(bench):
    """Camera 2 (the jitter is made on the device: no offset copy), then
    per shading pass the query's and the occluder's bin widths, per
    compaction its count and its parked row; ``pt.rays`` counts the rows
    that entered each pass's query."""
    _, r = bench
    pos, rot = r.camera.snapshot()
    pt = ppt.PathTracer(r.dscene, W, H, max_depth=DEPTH, seed=1,
                        intersect_fn=r.intersect_fn,
                        occluder_factory=r.occluder_factory)
    before = dict(trace.COUNTS)
    alive = []
    real = wf._pass

    def spy(*args, n_alive=None, **kwargs):
        if n_alive is not None:  # a bounce pass
            alive.append(n_alive)
        return real(*args, n_alive=n_alive, **kwargs)

    wf._pass = spy
    try:
        pt.step(pos, rot)
    finally:
        wf._pass = real
    made = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
            if v != before.get(k, 0)}
    shading = 1 + sum(a > 0 for a in alive)
    compacting = 1 + sum(a > 0 for a in alive[:-1])
    assert made.pop("pt.rays") == W * H + sum(alive)
    assert made == {"sync.camera": 2, "sync.bin_width": 2 * shading,
                    "sync.compact_count": compacting, "sync.park_row": compacting}
