"""The path-tracing slice, torch port vs JAX package (this suite runs on the
CPU, kernels through their plain versions).

Both packages shade identical buffers: each JAX DeviceScene is handed to the
port as numpy (``scene_from_numpy``).  The two frameworks' generators give
different numbers from one seed, so wherever one pass is compared the
uniforms are drawn with ``jax.random`` exactly as the JAX function draws
them and handed to the port as numpy.

Tolerances, each with its reason:
* ``_onb``/``_cosine_sample``: 1e-6 absolute, the same f32 ops (sqrt, sin
  and cos may round an ulp apart);
* ``_pt_shade_chunk``: contributions and candidate origins, directions and
  throughput within 1e-4 absolute on rows active on both sides (sums over
  lights in another order, pow and the divides of the Fresnel term), and
  ``active`` equal on >= 99.5% of rows: a row whose branch or roulette draw
  sits within f32 rounding of ``fres`` or ``p`` may take the other branch;
* whole samples are compared statistically, see ``test_mean_matches_jax``;
* a sample through the BVH wrappers against the same sample through brute
  force: within 2 u8 levels on >= 99% of pixels, the Whitted frame gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.models.material import Material as JMaterial
from directx_raytracer_tpu.models.material import MaterialType
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.ops.rays import generate_rays_tiled as j_rays_tiled
from directx_raytracer_tpu.render import pathtrace as jpt
from directx_raytracer_tpu.render import whitted as jw
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.models.scene import scene_from_numpy
from directx_raytracer_tpu_torch.ops.rays import pick_schedule
from directx_raytracer_tpu_torch.render import pathtrace as ppt
from directx_raytracer_tpu_torch.render import whitted as pw
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.utils.image import to_u8
from test_torch_intersect import device_scene_leaves

torch.set_num_threads(2)

UNIT_ATOL = 1e-6
CHUNK_ATOL = 1e-4
ACTIVE_AGREE = 0.995
PIXEL_LEVELS, PIXEL_AGREE = 2, 0.99
W, H = 48, 36


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port_scene(jd):
    return scene_from_numpy(device_scene_leaves(jd), "cpu")


def cornell(glass: bool = False):
    scene = jts.cornell_box(W, H, light_intensity=60.0)
    if glass:  # the tall block becomes glass
        scene.materials[0] = JMaterial(
            type=MaterialType.REFRACTIVE, ior=1.5,
            albedo=np.ones(3, np.float32), smooth_shading=False)
    return scene


@pytest.fixture(scope="module", params=["diffuse", "glass"])
def box(request):
    scene = cornell(glass=request.param == "glass")
    jd = j_build(scene)
    return scene, jd, port_scene(jd)


# ---------------------------------------------------------------------------
# Sampling units
# ---------------------------------------------------------------------------


def normals(n: int) -> np.ndarray:
    """Seeded unit normals, with the poles n_z = +-1 and an equator row
    n_z = 0 in front."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[0], v[1], v[2] = (0, 0, 1), (0, 0, -1), (0.6, 0.8, 0)
    return v


def test_onb_matches_jax():
    n = normals(2000)
    for got, want in zip(ppt._onb(t(n)), jpt._onb(jnp.asarray(n))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=UNIT_ATOL, rtol=0)
    tan, bit = (x.numpy() for x in ppt._onb(t(n)))
    for a, b in ((tan, bit), (tan, n), (bit, n)):  # orthonormal, poles too
        assert np.abs((a * b).sum(1)).max() < 1e-5
    assert np.abs(np.linalg.norm(tan, axis=1) - 1).max() < 1e-5


def test_cosine_sample_matches_jax():
    n = normals(2000)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)  # as jpt._cosine_sample splits it
    u1 = np.asarray(jax.random.uniform(k1, (n.shape[0],)))
    u2 = np.asarray(jax.random.uniform(k2, (n.shape[0],)))
    got = ppt._cosine_sample(t(u1), t(u2), t(n)).numpy()
    want = np.asarray(jpt._cosine_sample(key, jnp.asarray(n)))
    np.testing.assert_allclose(got, want, atol=UNIT_ATOL, rtol=0)
    assert ((got * n).sum(1) >= -1e-6).all()  # in the normal's hemisphere


# ---------------------------------------------------------------------------
# One pass
# ---------------------------------------------------------------------------


def jax_uniforms(key, n: int):
    """The four streams jpt._pt_shade_chunk draws from ``key`` for n rows:
    u1, u2 of the cosine sample, the branch pick, the roulette draw."""
    _, k_dir, k_branch, k_rr = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_dir)
    return [np.asarray(jax.random.uniform(k, (n,)))
            for k in (k1, k2, k_branch, k_rr)]


def primary_state(scene):
    tile, _ = pick_schedule(H, W)
    pos, rot = scene.camera.snapshot()
    o, d = j_rays_tiled(pos, rot, W, H, *tile, offset=(0.3, 0.6))
    n = W * H
    return {"origins": np.asarray(o), "dirs": np.asarray(d),
            "throughput": np.ones((n, 3), np.float32),
            "pixel": np.arange(n, dtype=np.int32),
            "active": np.ones((n,), bool)}


def bounce_state(scene, pd):
    """The live prefix of the queue the port's primary pass leaves: rays
    off the walls and blocks, with their throughput."""
    state = {k: t(v) for k, v in primary_state(scene).items()}
    geo = pd.geometry
    gen = torch.Generator().manual_seed(9)
    fb = torch.zeros((W * H + 1, 3))
    queue, alive = ppt._pt_pass(pd, state, fb, ppt._draw(gen, W * H, "cpu"), 0,
                                pw._default_intersect,
                                pw._default_occluder(geo), W * H)
    assert alive > 100  # the box fills a small part of the frame
    return {k: v[:alive].numpy() for k, v in queue.items()}


@pytest.mark.parametrize("depth", [0, 3])
def test_shade_chunk_matches_jax(box, depth):
    scene, jd, pd = box
    state = primary_state(scene) if depth == 0 else bounce_state(scene, pd)
    n = state["active"].shape[0]
    key = jax.random.PRNGKey(17 + depth)
    jcontrib, jcand = jpt._pt_shade_chunk(
        jd, {k: jnp.asarray(v) for k, v in state.items()}, None, key, depth,
        jw._default_intersect, jw._default_occluder(jd.geometry), defer=True)
    contrib, cand = ppt._pt_shade_chunk(
        pd, {k: t(v) for k, v in state.items()},
        [t(u) for u in jax_uniforms(key, n)], depth, pw._default_intersect,
        pw._default_occluder(pd.geometry))

    assert torch.isfinite(contrib).all() and (contrib >= 0).all()
    np.testing.assert_allclose(contrib.numpy(), np.asarray(jcontrib),
                               atol=CHUNK_ATOL, rtol=0)
    assert contrib.max() > 0.05
    active, jactive = cand["active"].numpy(), np.asarray(jcand["active"])
    flipped = int((active != jactive).sum())
    print(f"depth {depth}: {flipped} of {n} rows differ in active")
    assert flipped <= (1 - ACTIVE_AGREE) * n
    both = active & jactive
    assert both.sum() > 50
    if depth >= ppt.RR_START:  # the roulette dropped some
        assert active.sum() < n
    np.testing.assert_array_equal(cand["pixel"].numpy(), np.asarray(jcand["pixel"]))
    # A row whose branch draw sits on fres takes the other glass branch on
    # one side: such rows (none where nothing is glass) are left out.
    same_branch = np.abs(cand["dirs"].numpy() - np.asarray(jcand["dirs"])).max(1) < 0.1
    assert (both & ~same_branch).sum() <= (1 - ACTIVE_AGREE) * n
    rows = both & same_branch
    for k in ("origins", "dirs", "throughput"):
        np.testing.assert_allclose(cand[k].numpy()[rows], np.asarray(jcand[k])[rows],
                                   atol=CHUNK_ATOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# The four cases of tests/test_pathtrace.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def diffuse_box():
    scene = pts.cornell_box(W, H, light_intensity=60.0)
    from directx_raytracer_tpu_torch.models.scene import build_device_scene
    return scene, build_device_scene(scene, "cpu")


def test_direct_term_matches_whitted_at_depth1(diffuse_box):
    scene, d = diffuse_box
    pos, rot = scene.camera.snapshot()
    pt = ppt.PathTracer(d, W, H, max_depth=1, seed=1).step(pos, rot, n=24)
    img_pt = pt.image().numpy()
    img_w = pw.render_whitted(d, pos, rot, W, H, max_depth=1)[0].numpy()
    lit = img_w.max(axis=-1) > 0.02
    err = np.abs(img_pt - img_w).mean(axis=-1)
    # jittered sampling blurs edges; compare the robust central tendency
    assert np.median(err[lit]) < 0.02
    # Indirect light only ADDS energy: deeper tracing must not darken.
    pt6 = ppt.PathTracer(d, W, H, max_depth=5, seed=2).step(pos, rot, n=24)
    assert pt6.image().sum() > img_pt.sum() * 0.98


def test_variance_decreases_with_samples(diffuse_box):
    scene, d = diffuse_box
    pos, rot = scene.camera.snapshot()

    def image(seed, n):
        return ppt.PathTracer(d, W, H, max_depth=3, seed=seed) \
            .step(pos, rot, n=n).image()

    few = (image(3, 2) - image(4, 2)).abs().mean()
    many = (image(5, 16) - image(6, 16)).abs().mean()
    assert many < few  # ~1/sqrt(n) shrinkage
    assert torch.isfinite(image(3, 2)).all()


def test_checkpoint_roundtrip(tmp_path, diffuse_box):
    scene, d = diffuse_box
    pos, rot = scene.camera.snapshot()
    pt = ppt.PathTracer(d, W, H, max_depth=2, seed=7).step(pos, rot, n=3)
    ckpt = str(tmp_path / "state.npz")
    pt.save_state(ckpt)
    with np.load(ckpt) as z:
        assert sorted(z.files) == ["accum", "height", "key", "n_samples", "width"]

    resumed = ppt.PathTracer(d, W, H, max_depth=2, seed=0)
    resumed.load_state(ckpt)
    assert resumed.n_samples == 3
    np.testing.assert_allclose(resumed.image().numpy(), pt.image().numpy())

    # Continue sampling after resume: identical to never having stopped.
    pt.step(pos, rot, n=2)
    resumed.step(pos, rot, n=2)
    np.testing.assert_allclose(resumed.image().numpy(), pt.image().numpy(),
                               atol=1e-6)
    # ... and to a tracer that never stopped at all.
    whole = ppt.PathTracer(d, W, H, max_depth=2, seed=7).step(pos, rot, n=5)
    np.testing.assert_allclose(whole.image().numpy(), pt.image().numpy(),
                               atol=1e-6)
    resumed.reset()
    assert resumed.n_samples == 0 and not resumed.accum.any()

    bad = ppt.PathTracer(d, 24, 18, max_depth=2)
    with pytest.raises(ValueError, match="resolution mismatch"):
        bad.load_state(ckpt)


def test_glass_scene_is_finite():
    jd = j_build(cornell(glass=True))
    scene = cornell(glass=True)
    pos, rot = scene.camera.snapshot()
    pt = ppt.PathTracer(port_scene(jd), W, H, max_depth=6, seed=11) \
        .step(pos, rot, n=4)
    img = pt.image()
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert img.max() > 0.05


def test_too_many_pixels_is_refused(diffuse_box):
    scene, d = diffuse_box
    pos, rot = scene.camera.snapshot()
    with pytest.raises(ValueError, match="ids must stay below"):
        ppt.pathtrace_tile(d, pos, rot, torch.Generator(), 8192, 4096)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def test_mean_matches_jax():
    """Mean of 32 depth-3 samples on cornell_box(48, 36) from PathTracer on
    both sides.  The generators differ, so the comparison is statistical:
    the median over lit pixels of the per-pixel abs difference.  Two JAX
    runs of this mean with different seeds differ by 0.188-0.250 by that
    measure (seeds 0, 1, 2 pairwise; the lit pixels are few and bright,
    mean 2.08); the gate is twice the smallest, 0.376.  The image means
    must also agree within 10% (two JAX seeds: within 4%)."""
    scene = cornell()
    jd = j_build(scene)
    pos, rot = scene.camera.snapshot()
    want = np.asarray(jpt.PathTracer(jd, W, H, max_depth=3, seed=0)
                      .step(pos, rot, n=32).image())
    got = ppt.PathTracer(port_scene(jd), W, H, max_depth=3, seed=0) \
        .step(pos, rot, n=32).image().numpy()
    lit = want.max(axis=-1) > 0.02
    diff = float(np.median(np.abs(got - want).mean(axis=-1)[lit]))
    print(f"median abs difference over {int(lit.sum())} lit pixels: {diff:.4f}; "
          f"image means {got.mean():.4f} (port) {want.mean():.4f} (JAX)")
    assert diff < 0.376
    assert abs(got.mean() - want.mean()) < 0.10 * want.mean()


def test_bvh_sample_matches_bruteforce():
    """One depth-3 sample of bench_scene(3_000) through the BVH wrappers
    (binning, closest_hit_plain, any_hit_plain on the CPU) against the same
    sample through brute force, from the same generator seed."""
    w, h = 96, 48
    r = Renderer(pts.bench_scene(3_000, w, h), w, h, device="cpu",
                 use_kernels=True)
    assert r.bvh is not None
    pos, rot = r.camera.snapshot()

    def sample(**fns):
        gen = torch.Generator().manual_seed(21)
        return ppt.pathtrace_sample(r.dscene, pos, rot, gen, w, h,
                                    max_depth=3, **fns)

    got = sample(intersect_fn=r.intersect_fn, occluder_factory=r.occluder_factory)
    want = sample()
    diff = np.abs(to_u8(got).astype(int) - to_u8(want).astype(int))
    assert ((diff <= PIXEL_LEVELS).all(axis=-1)).mean() >= PIXEL_AGREE
    assert (got != r.dscene.background_color).any(dim=-1).sum() > w * h // 10
