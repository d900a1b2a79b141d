"""The Whitted slice, torch port vs JAX package: the shading units, the
wavefront compaction, whole frames, the Renderer and ``viewer render
--whitted`` (this suite runs on the CPU, kernels through their plain
versions).

Both packages shade identical buffers: each frame's JAX DeviceScene is
handed to the port as numpy (``scene_from_numpy``), and unit inputs are made
from a seed with numpy.  The JAX frames render with brute force; each JAX
Whitted frame is one jit compile, so the frames are few and small.

Tolerances, each with its reason:
* units (reflect, refract_fresnel, sample_textures, hit_attributes): 1e-6
  absolute — the same f32 ops, pow/sqrt may round an ulp apart;
* direct_lighting: 1e-5 relative (sums over lights and pow in another
  order), on the same shadow verdicts (the occluders are the two packages'
  brute-force oracles, which agree exactly here);
* ``_compact_sort``: exact — a stable sort on equal int32 keys and a gather;
* frames: within 2 u8 levels on >= 99% of pixels (the golden gate of
  bench.py:196-206: a seam pixel may take either triangle), alive per pass
  within 1% of the pixel count, dropped equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directx_raytracer_tpu import testscenes as jts
from directx_raytracer_tpu.models.camera import Camera as JCamera
from directx_raytracer_tpu.models.light import Light as JLight
from directx_raytracer_tpu.models.material import Material as JMaterial
from directx_raytracer_tpu.models.material import MaterialType
from directx_raytracer_tpu.models.mesh import Mesh as JMesh
from directx_raytracer_tpu.models.scene import Scene as JScene
from directx_raytracer_tpu.models.scene import SceneSettings as JSettings
from directx_raytracer_tpu.models.scene import build_device_scene as j_build
from directx_raytracer_tpu.models.texture import Texture as JTexture
from directx_raytracer_tpu.models.texture import TextureType
from directx_raytracer_tpu.ops import intersect as jx
from directx_raytracer_tpu.ops import shading as jsh
from directx_raytracer_tpu.ops.rays import generate_rays_tiled as j_rays_tiled
from directx_raytracer_tpu.render import whitted as jw
from directx_raytracer_tpu.utils.image import to_u8 as j_to_u8
from directx_raytracer_tpu_torch import testscenes as pts
from directx_raytracer_tpu_torch.models.scene import LightTable, scene_from_numpy
from directx_raytracer_tpu_torch.ops import intersect as px
from directx_raytracer_tpu_torch.ops import shading as psh
from directx_raytracer_tpu_torch.render import render_whitted
from directx_raytracer_tpu_torch.render import whitted as pw
from directx_raytracer_tpu_torch.render.renderer import Renderer
from directx_raytracer_tpu_torch.utils.image import to_u8
from directx_raytracer_tpu_torch.viewer.app import main as viewer_main
from test_torch_intersect import device_scene_leaves
from test_whitted import _floor_scene, _mesh

torch.set_num_threads(2)

PIXEL_LEVELS, PIXEL_AGREE = 2, 0.99
ALIVE_SHARE = 0.01
UNIT_ATOL = 1e-6


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port_scene(jd):
    return scene_from_numpy(device_scene_leaves(jd), "cpu")


# ---------------------------------------------------------------------------
# Scenes (JAX models; the port gets the built buffers)
# ---------------------------------------------------------------------------


def _quad(x0, x1, z0, z1, mat):
    m = JMesh(vertices=np.array([[x0, 0, z0], [x1, 0, z0], [x0, 0, z1],
                                 [x1, 0, z1]], np.float32),
              indices=np.array([0, 2, 1, 3, 1, 2], np.int32),  # +y winding
              material_index=mat)
    m.uvs = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    m.calculate_vertex_normals()
    return m


def textured_scene(png_dir):
    """Three unit quads under a light, seen from above: a diffuse checker,
    a constant edges texture and a constant bitmap (a 4x4 PNG)."""
    from PIL import Image

    q = np.zeros((4, 4, 3), np.uint8)
    q[:2, :2], q[:2, 2:] = (255, 0, 0), (0, 255, 0)
    q[2:, :2], q[2:, 2:] = (0, 0, 255), (255, 255, 0)
    Image.fromarray(q).save(png_dir / "t.png")
    scene = JScene()
    scene.settings = JSettings(background_color=np.array([0.1, 0.1, 0.1],
                                                          np.float32))
    scene.camera = JCamera(position=(0.0, 2.5, 0.0))
    scene.camera.rotate(0.0, 89.0)
    scene.textures += [
        JTexture(name="check", type=TextureType.CHECKER,
                 color_a=np.array([1.0, 1.0, 1.0], np.float32),
                 color_b=np.array([0.2, 0.1, 0.0], np.float32), scalar=0.25),
        JTexture(name="wire", type=TextureType.EDGES,
                 color_a=np.array([1.0, 1.0, 0.0], np.float32),
                 color_b=np.array([0.1, 0.1, 0.3], np.float32), scalar=0.08),
        JTexture(name="bmp", type=TextureType.BITMAP,
                 file_path=str(png_dir / "t.png")),
        JTexture(name="flat", type=TextureType.ALBEDO,
                 color_a=np.array([0.2, 0.9, 0.4], np.float32)),
    ]
    for i, (name, mtype) in enumerate([("check", MaterialType.DIFFUSE),
                                       ("wire", MaterialType.CONSTANT),
                                       ("bmp", MaterialType.CONSTANT)]):
        mat = JMaterial(type=mtype)
        mat.texture_name = name
        scene.materials.append(mat)
        scene.meshes.append(_quad(-1.65 + 1.1 * i, -0.65 + 1.1 * i, -0.5, 0.5, i))
    scene.lights.append(JLight(position=np.array([0.0, 3.0, 0.0], np.float32),
                               intensity=150.0))
    return scene


def floor_occluder():
    scene = _floor_scene()
    scene.meshes.append(_mesh(
        [[0.2, 1.5, 1.4], [1.4, 1.5, 1.4], [0.2, 1.5, 0.2], [1.4, 1.5, 0.2]],
        [0, 1, 2, 3, 2, 1]))
    return scene


def floor_mirror():
    scene = _floor_scene(mtype=MaterialType.REFLECTIVE,
                         albedo=(0.9, 0.8, 0.7))
    scene.meshes.append(_mesh(
        [[-50, 4, 50], [50, 4, 50], [-50, 4, -50], [50, 4, -50]],
        [0, 1, 2, 1, 3, 2], material_index=1))
    scene.meshes.append(_mesh(  # a diffuse block the mirror also shows
        [[-1, 0.5, 1], [1, 0.5, 1], [-1, 0.5, -1], [1, 0.5, -1]],
        [0, 2, 1, 3, 1, 2], material_index=2))
    scene.materials += [
        JMaterial(type=MaterialType.CONSTANT,
                  albedo=np.array([1.0, 0.0, 0.0], np.float32)),
        JMaterial(type=MaterialType.DIFFUSE,
                  albedo=np.array([0.3, 0.6, 0.9], np.float32))]
    return scene


def glass_slab():
    scene = _floor_scene(mtype=MaterialType.REFRACTIVE)
    scene.materials[0].ior = 1.5
    scene.settings.background_color = np.array([1.0, 1.0, 1.0], np.float32)
    scene.meshes.append(_mesh(
        [[-50, -2, 50], [50, -2, 50], [-50, -2, -50], [50, -2, -50]],
        [0, 1, 2, 3, 2, 1], material_index=1))
    scene.materials.append(JMaterial(
        type=MaterialType.CONSTANT, albedo=np.array([0.0, 0.0, 1.0], np.float32)))
    return scene


def grazing_tir():
    scene = _floor_scene(mtype=MaterialType.REFRACTIVE)
    scene.materials[0].ior = 1.5
    return scene


def specular_cornell():
    scene = jts.cornell_box(32, 24)
    for m in scene.materials:
        if m.type == MaterialType.DIFFUSE:
            m.specular, m.shininess = 0.8, 8.0
    return scene


# name -> (make_scene(png_dir), width, height, render kwargs)
FRAMES = {
    "cornell": (lambda p: jts.cornell_box(64, 48), 64, 48, dict(max_depth=3)),
    "floor_occluder": (lambda p: floor_occluder(), 48, 48, dict(max_depth=2)),
    "floor_mirror": (lambda p: floor_mirror(), 32, 32, dict(max_depth=3)),
    "glass_slab_spp3": (lambda p: glass_slab(), 16, 16,
                        dict(max_depth=4, spp=3)),
    "grazing_tir": (lambda p: grazing_tir(), 33, 33, dict(max_depth=4)),
    "textured": (textured_scene, 48, 48, dict(max_depth=2)),
    "specular_spp4": (lambda p: specular_cornell(), 32, 24,
                      dict(max_depth=2, spp=4)),
}


def assert_frames_agree(img, stats, jimg, jstats, n_pix):
    diff = np.abs(to_u8(img).astype(int) - j_to_u8(np.asarray(jimg)).astype(int))
    assert ((diff <= PIXEL_LEVELS).all(axis=-1)).mean() >= PIXEL_AGREE
    alive, jalive = stats["alive"].numpy(), np.asarray(jstats["alive"])
    assert alive.shape == jalive.shape
    assert (np.abs(alive - jalive) <= ALIVE_SHARE * n_pix).all()
    np.testing.assert_array_equal(stats["dropped"].numpy(),
                                  np.asarray(jstats["dropped"]))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_matches_jax(name, tmp_path):
    make_scene, w, h, kw = FRAMES[name]
    scene = make_scene(tmp_path)
    jd = j_build(scene, base_dir=str(tmp_path))
    pos, rot = scene.camera.snapshot()
    jimg, jstats = jw.render_whitted(jd, pos, rot, w, h, **kw)
    img, stats = render_whitted(port_scene(jd), pos, rot, w, h, **kw)
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()
    assert_frames_agree(img, stats, jimg, jstats, w * h)
    # Not trivial: something is lit, or rays bounce (the grazing-TIR glass
    # under a black sky stays black).
    assert img.max() > 0.05 or stats["alive"].sum() > 0


def test_bench_scene_renderer_matches_jax():
    """bench_scene(3000) through the port's Renderer on the CPU (the BVH
    path: binning, closest_hit_plain and any_hit_plain) against the JAX
    brute-force frame."""
    w, h = 96, 48
    scene = jts.bench_scene(3_000, w, h)
    pos, rot = scene.camera.snapshot()
    jimg, jstats = jw.render_whitted(j_build(scene), pos, rot, w, h,
                                     max_depth=3)
    r = Renderer(pts.bench_scene(3_000, w, h), w, h, device="cpu",
                 use_kernels=True)
    assert r.bvh is not None and r.occluder_factory is not None
    img, stats = r.render_whitted_frame(max_depth=3)
    assert_frames_agree(img, stats, jimg, jstats, w * h)
    assert stats["alive"][0] > 0  # the mirror floor spawns bounce rays
    u8 = r.to_u8_device(img)
    assert u8.dtype == torch.uint8
    np.testing.assert_array_equal(u8.numpy(), to_u8(img))


def test_viewer_render_whitted_writes_png(tmp_path, capsys):
    from PIL import Image

    out = tmp_path / "whitted.png"
    viewer_main(["render", "--builtin", "cornell_box", "--width", "32",
                 "--height", "24", "--whitted", "--depth", "2", "--spp", "4",
                 "--device", "cpu", "-o", str(out)])
    assert "whitted" in capsys.readouterr().out
    img, _ = Renderer(pts.cornell_box(), 32, 24, device="cpu") \
        .render_whitted_frame(max_depth=2, spp=4)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), to_u8(img))


# ---------------------------------------------------------------------------
# Row bands of render_tile
# ---------------------------------------------------------------------------


def band_scene(name):
    if name == "cornell":
        return pts.cornell_box(64, 48), 64, 48, 2
    return pts.bench_scene(3_000, 96, 48), 96, 48, 3  # bounce passes alive


@pytest.mark.parametrize("name,bands", [
    ("cornell", [(0, 24), (24, 24)]),
    ("cornell", [(0, 12), (12, 24), (36, 12)]),
    ("cornell", [(0, 7), (7, 41)]),        # row-major bands (no tile divides 7)
    ("bench", [(0, 24), (24, 24)]),
])
def test_bands_concatenate_to_the_full_frame(name, bands):
    """``render_tile(row_start, rows)`` stripes are the frame's rows
    exactly: a pixel's rays and shading do not depend on its band, and the
    sink row and the queue follow the band's pixel count."""
    from directx_raytracer_tpu_torch.models.scene import build_device_scene

    scene, w, h, depth = band_scene(name)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    offs = pw.spp_offsets(1)
    full, full_stats = pw.render_tile(d, pos, rot, w, h, offs, 1.0,
                                      max_depth=depth)
    whole, _ = render_whitted(d, pos, rot, w, h, max_depth=depth)
    assert torch.equal(full, whole)
    stripes, alive = [], 0
    for row_start, rows in bands:
        img, stats = pw.render_tile(d, pos, rot, w, h, offs, 1.0,
                                    row_start=row_start, rows=rows,
                                    max_depth=depth)
        assert img.shape == (rows, w, 3)
        stripes.append(img)
        alive += int(stats["alive"].sum())
    np.testing.assert_array_equal(torch.cat(stripes).numpy(), full.numpy())
    assert alive == int(full_stats["alive"].sum())
    if name == "bench":
        assert alive > 0


def test_band_past_the_bottom_renders_and_crops():
    """A band reaching below the frustum (the multi-device path's last
    stripe) renders; its rows inside the frame are the frame's."""
    from directx_raytracer_tpu_torch.models.scene import build_device_scene

    scene = pts.cornell_box(64, 47)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    offs = pw.spp_offsets(1)
    full, _ = render_whitted(d, pos, rot, 64, 47, max_depth=2)
    img, _ = pw.render_tile(d, pos, rot, 64, 47, offs, 1.0, row_start=40,
                            rows=8, max_depth=2)
    assert img.shape == (8, 64, 3) and torch.isfinite(img).all()
    np.testing.assert_array_equal(img[:7].numpy(), full[40:].numpy())


def test_band_matches_jax_band():
    """The same band through the JAX ``render_tile``: the frame gate."""
    scene = jts.cornell_box(64, 48)
    jd = j_build(scene)
    pos, rot = scene.camera.snapshot()
    offs = pw.spp_offsets(4)
    kw = dict(row_start=12, rows=24, max_depth=2)
    jimg, jstats = jw.render_tile(jd, pos, rot, 64, 48,
                                  jnp.asarray(offs, jnp.float32), 0.25, **kw)
    img, stats = pw.render_tile(port_scene(jd), pos, rot, 64, 48, offs, 0.25,
                                **kw)
    assert img.shape == (24, 64, 3)
    assert_frames_agree(img, stats, jimg, jstats, 64 * 24)


def test_zero_offset_weight_contributes_nothing():
    from directx_raytracer_tpu_torch.models.scene import build_device_scene

    scene = pts.cornell_box(32, 24)
    d = build_device_scene(scene, "cpu")
    pos, rot = scene.camera.snapshot()
    one, _ = pw.render_tile(d, pos, rot, 32, 24, [(0.25, 0.75)], 0.5,
                            max_depth=2)
    padded, stats = pw.render_tile(
        d, pos, rot, 32, 24, [(0.25, 0.75), (0.5, 0.5)], 0.5, max_depth=2,
        offset_weights=[1.0, 0.0])
    assert torch.equal(padded, one) and one.max() > 0.02
    assert stats["alive"].shape == (4,)  # the padding offset still traces
    both, _ = pw.render_tile(d, pos, rot, 32, 24, [(0.25, 0.75), (0.5, 0.5)],
                             0.5, max_depth=2, offset_weights=[1.0, 1.0])
    assert not torch.equal(both, one)


# ---------------------------------------------------------------------------
# Wavefront compaction
# ---------------------------------------------------------------------------


def candidates(n: int, seed: int, active_share: float):
    """2n candidate rows (A = first n, B = last n) with repeated origins
    and directions, so the stable sort's tie order matters."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (2 * n, 3)).astype(np.float32)
    o[1::4] = o[0::4][: len(o[1::4])]
    d = rng.normal(size=(2 * n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[2::4] = d[0::4][: len(d[2::4])]
    return {
        "origins": o, "dirs": d,
        "throughput": rng.uniform(0, 1, (2 * n, 3)).astype(np.float32),
        "pixel": np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32),
        "active": rng.random(2 * n) < active_share,
    }


@pytest.mark.parametrize("case,capacity", [
    ("no_overflow", 256), ("overflow_drops_b", 120), ("clamp", 40)])
def test_compact_sort_matches_jax(case, capacity):
    n = 128
    cand = candidates(n, seed=5, active_share=0.6)
    lo, hi = np.full(3, -5, np.float32), np.full(3, 5, np.float32)
    jq, jalive, jdrop = jw._compact_sort(
        {k: jnp.asarray(v) for k, v in cand.items()}, capacity,
        jnp.asarray(lo), jnp.asarray(hi), split_at=n)
    q, alive, drop = pw._compact_sort(
        {k: t(v) for k, v in cand.items()}, capacity, t(lo), t(hi), split_at=n)
    n_active = int(cand["active"].sum())
    n_a = int(cand["active"][:n].sum())
    assert (alive, drop) == (int(jalive), int(jdrop))
    assert alive == min(n_active, capacity)
    assert drop == max(n_active - capacity, 0)
    for k in q:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]), err_msg=k)
    assert (q["pixel"][alive:] == pw.PIXEL_SENTINEL).all()
    assert (q["origins"][alive:] == 1e30).all()
    if case == "overflow_drops_b":
        assert n_a <= capacity < n_active
        # every active A row survives; the dropped rows are all B rows
        kept = set(map(tuple, q["origins"][:alive].numpy().tolist()))
        a_rows = cand["origins"][:n][cand["active"][:n]]
        assert all(tuple(r) in kept for r in a_rows.tolist())
    if case == "clamp":
        assert capacity < n_a and alive == capacity


def test_queue_capacity_matches_jax_rule():
    for n_pix, qf in ((2_073_600, 1), (2_073_600, 2), (64 * 48, 1), (33 * 33, 2)):
        q = n_pix * qf
        chunk = -(-max(q // 16, 256) // 256) * 256
        assert pw.queue_capacity(n_pix, qf) == -(-q // chunk) * chunk
    assert pw.queue_capacity(2_073_600, 1) == 2_076_672


# ---------------------------------------------------------------------------
# Shading units
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hits(tmp_path_factory):
    """Primary hits of bench_scene(3000) and of the textured scene (JAX
    brute force + hit record), handed to both packages."""
    out = {}
    png_dir = tmp_path_factory.mktemp("tex")
    for name, scene, w, h in (("bench", jts.bench_scene(3_000, 96, 48), 96, 48),
                              ("textured", textured_scene(png_dir), 48, 48)):
        jd = j_build(scene, base_dir=str(png_dir))
        pos, rot = scene.camera.snapshot()
        o, d = j_rays_tiled(pos, rot, w, h, 8, 16)
        hit = jx.intersect_bruteforce(o, d, jd.geometry.woop)
        hit, _, _, _, rec = jx.hit_record(o, d, jd.geometry.packed, hit)
        out[name] = dict(jd=jd, pd=port_scene(jd), o=o, d=d, hit=hit, rec=rec)
    return out


def port_hit(jhit):
    return px.Hit(t=t(jhit.t), tri=t(jhit.tri), u=t(jhit.u), v=t(jhit.v))


@pytest.mark.parametrize("scene", ["bench", "textured"])
def test_hit_attributes_match_jax(hits, scene):
    x = hits[scene]
    want = jsh.hit_attributes(x["jd"], x["o"], x["d"], x["hit"], x["rec"])
    got = psh.hit_attributes(x["pd"], t(x["o"]), t(x["d"]), port_hit(x["hit"]),
                             t(x["rec"]))
    m = np.asarray(x["hit"].tri) >= 0
    assert m.sum() > 100
    for k in want:
        np.testing.assert_allclose(got[k].numpy()[m], np.asarray(want[k])[m],
                                   atol=UNIT_ATOL, rtol=0, err_msg=k)


def test_sample_textures_all_types(hits):
    """ALBEDO, EDGES, CHECKER, BITMAP, and a negative id (row 0), at uvs in
    and outside [0, 1]."""
    x = hits["textured"]
    rng = np.random.default_rng(2)
    n = 4000
    tex_id = rng.integers(-1, 4, n).astype(np.int32)
    uv = rng.uniform(-0.25, 1.25, (n, 2)).astype(np.float32)
    bary = rng.uniform(0, 0.6, (n, 2)).astype(np.float32)
    want = jsh.sample_textures(x["jd"].textures, jnp.asarray(tex_id),
                               jnp.asarray(uv), jnp.asarray(bary))
    got = psh.sample_textures(x["pd"].textures, t(tex_id), t(uv), t(bary))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=UNIT_ATOL,
                               rtol=0)
    assert len({tuple(c) for c in got.numpy().round(3).tolist()}) >= 8


def unit_vectors(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_reflect_and_refract_match_jax():
    """Entering (d.n < 0), exiting (d.n > 0) and total internal reflection
    (exiting at grazing angles through ior 1.5)."""
    rng = np.random.default_rng(4)
    n = 3000
    d, nn = unit_vectors(rng, n), unit_vectors(rng, n)
    ior = rng.choice(np.float32([1.0, 1.33, 1.5, 2.4]), n).astype(np.float32)
    cos = (d * nn).sum(1)
    tir = jsh.refract_fresnel(jnp.asarray(d), jnp.asarray(nn),
                              jnp.asarray(ior))[3]
    assert (cos < 0).any() and (cos > 0).any() and np.asarray(tir).any()
    np.testing.assert_allclose(psh.reflect(t(d), t(nn)).numpy(),
                               np.asarray(jsh.reflect(jnp.asarray(d),
                                                      jnp.asarray(nn))),
                               atol=UNIT_ATOL, rtol=0)
    got = psh.refract_fresnel(t(d), t(nn), t(ior))
    want = jsh.refract_fresnel(jnp.asarray(d), jnp.asarray(nn), jnp.asarray(ior))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=UNIT_ATOL,
                                   rtol=0)


def test_spp_offsets_match_jax():
    for spp in range(1, 17):
        assert pw.spp_offsets(spp) == jw.spp_offsets(spp)
    with pytest.raises(ValueError):
        pw.spp_offsets(0)


@pytest.mark.parametrize("mask,view,sort", [
    (False, False, False), (True, False, True), (True, True, True),
    (False, True, False), (True, True, False)])
def test_direct_lighting_matches_jax(hits, mask, view, sort):
    x = hits["bench"]
    jd, pd = x["jd"], x["pd"]
    attrs = jsh.hit_attributes(jd, x["o"], x["d"], x["hit"], x["rec"])
    pts_, nrm = np.asarray(attrs["point"]), np.asarray(attrs["normal"])
    n = pts_.shape[0]
    rng = np.random.default_rng(9)
    msk = (np.asarray(x["hit"].tri) >= 0) & (rng.random(n) < 0.8)
    shin = rng.uniform(2, 32, n).astype(np.float32)
    jgeo, pgeo = jd.geometry, pd.geometry

    def j_occ(o, d, tm):
        return jx.occluded_bruteforce(o, d, jgeo.woop, tm)

    def p_occ(o, d, tm):
        return px.occluded_bruteforce(o, d, pgeo.woop, tm)

    jkw = dict(mask=jnp.asarray(msk) if mask else None,
               view=x["d"] if view else None,
               shininess=jnp.asarray(shin) if view else None,
               sort_bounds=(jgeo.scene_lo, jgeo.scene_hi) if sort else None)
    pkw = dict(mask=t(msk) if mask else None,
               view=t(x["d"]) if view else None,
               shininess=t(shin) if view else None,
               sort_bounds=(pgeo.scene_lo, pgeo.scene_hi) if sort else None)
    want = jsh.direct_lighting(attrs["point"], attrs["normal"], jd.lights,
                               j_occ, **jkw)
    got = psh.direct_lighting(t(pts_), t(nrm), pd.lights, p_occ, **pkw)
    want = want if view else (want,)
    got = got if view else (got,)
    finite = np.isfinite(pts_).all(1)
    for g, w in zip(got, want):
        g, w = g.numpy()[finite], np.asarray(w)[finite]
        assert (w > 0).any()
        if mask:
            assert (w == 0).any()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_backfacing_shadow_disarm_is_exact():
    """The cos > 0 disarm: a surface facing away from every light gets
    t_max = 0 and zero light with or without an occluder."""
    lights = LightTable(position=torch.tensor([[0.0, 10.0, 0.0]]),
                        intensity=torch.tensor([1000.0]), n_lights=1)
    points = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    normals = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    mask = torch.tensor([True, True])
    calls = []

    def occluder(o, d, tm):
        calls.append(tm)
        return torch.zeros((o.shape[0],), dtype=torch.bool)

    lit = psh.direct_lighting(points, normals, lights, occluder, mask=mask)
    unlit = psh.direct_lighting(points, normals, lights, None, mask=mask)
    assert lit[1, 0] == 0.0 and unlit[1, 0] == 0.0 and lit[0, 0] > 0.0
    (tm,) = calls
    assert tm.min() == 0.0 and tm.max() > 0.0


@pytest.mark.parametrize("sort", [False, True])
def test_masked_shadow_rays_park_only_when_sorted(sort):
    """Masked-but-live rays keep their geometry with t_max = 0 (a parked
    origin would blow up their tile's box); in Morton-sorted mode they sit
    in the tail and are parked at 1e30."""
    rng = np.random.default_rng(1)
    n = 64
    points = t(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    normals = t(unit_vectors(rng, n))
    mask = torch.arange(n) % 3 != 0
    lights = LightTable(position=torch.tensor([[0.0, 5.0, 0.0]]),
                        intensity=torch.tensor([10.0]), n_lights=1)
    seen = {}

    def occluder(o, d, tm):
        seen.update(o=o, tm=tm)
        return torch.zeros((o.shape[0],), dtype=torch.bool)

    bounds = (torch.full((3,), -1.0), torch.full((3,), 1.0)) if sort else None
    psh.direct_lighting(points, normals, lights, occluder, mask=mask,
                        sort_bounds=bounds)
    o, tm = seen["o"], seen["tm"]
    if sort:
        n_armed = int(mask.sum())
        assert (o[n_armed:] == 1e30).all() and (tm[n_armed:] == 0).all()
        assert (o[:n_armed].abs() < 2).all()
    else:
        assert (o.abs() < 2).all()
        assert (tm[~mask] == 0).all()
