"""The supersampled Whitted frame over glass and the plain reference that
judges it (``benchmark/reference/whitted_glass.py``), on the CPU.

* The port's ``render_whitted_frame(5, 4)`` (plain kernels) against the
  reference over every pixel of ``bench_scene_glass`` at 20,000 triangles
  (12 of its 24 spheres glass), 96 x 48: held to the ``whitted_glass_100k``
  cell's rule (off pixels over graded-or-off pixels within the cell's
  ``off_pct`` limit).
* The reference's refraction at one glass sphere: Snell's law, Schlick's
  0.04 at normal incidence for ior 1.5, total internal reflection with
  weight 1 for a grazing ray inside.
* Without glass at spp 1 the reference equals ``reference/whitted.py``
  pixel for pixel.
* The frame's ``whitted.rays``, ``whitted.split`` and ``wavefront.dropped``
  deltas equal what its stats and its shading steps' candidate masks give,
  and its ``sync.*`` counts are its documented sites: the counters add no
  host sync.
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
from benchmark.reference import geometry  # noqa: E402
from benchmark.reference import whitted as plain_ref  # noqa: E402
from benchmark.reference import whitted_glass as ref  # noqa: E402
from benchmark.reference.geometry import Triangles  # noqa: E402
from benchmark.scenes import bench_scene, bench_scene_glass  # noqa: E402
from directx_raytracer_tpu_torch.render import whitted as pw  # noqa: E402
from directx_raytracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from directx_raytracer_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

W, H, DEPTH, SPP = 96, 48, 5, 4
CELL = json.loads((ROOT / "benchmark" / "cells" / "whitted_glass_100k.json").read_text())
KEYS = ("whitted.rays", "whitted.split", "wavefront.dropped")


@pytest.fixture(scope="module")
def small_blocks():
    """The reference in ray blocks of 1,024 (its temporaries a quarter of
    the default's): the same numbers in less memory."""
    saved = geometry.RAY_BLOCK
    geometry.RAY_BLOCK = 1024
    yield
    geometry.RAY_BLOCK = saved


@pytest.fixture(scope="module")
def glass_frame():
    """One depth-5, spp-4 frame of the glass scene at its start pose: the
    scene data, the renderer, the u8 image, the stats, the counter and sync
    deltas, and each non-last shading step's (pass, live branch-B rows)."""
    data = bench_scene_glass.build(2**31 + 11, n_tris=20_000, width=W, height=H)
    r = Renderer(port.port_scene(data), W, H, device="cpu", use_kernels=True)
    split = []
    real = pw._shade_hits

    def spy(*args, **kwargs):
        contrib, branches = real(*args, **kwargs)
        if branches is not None:
            split.append(int(branches[1]["active"].sum()))
        return contrib, branches

    before = dict(trace.COUNTS)
    pw._shade_hits = spy
    try:
        img, stats = r.render_whitted_frame(DEPTH, SPP)
    finally:
        pw._shade_hits = real
    made = {k: v - before.get(k, 0) for k, v in trace.COUNTS.items()
            if v != before.get(k, 0)}
    return {"data": data, "renderer": r, "u8": r.to_u8_device(img),
            "stats": stats, "made": made, "split": split}


def test_frame_matches_the_plain_reference(glass_frame, small_blocks):
    data, r = glass_frame["data"], glass_frame["renderer"]
    got = glass_frame["u8"].reshape(-1, 3).long()
    pos, rot = r.camera.snapshot()
    flat = torch.arange(W * H)
    linear = ref.render_pixels(Triangles(data, "cpu"), data, (pos, rot), flat % W,
                               flat // W, {"max_depth": DEPTH, "spp": SPP})
    bad = (got != to_u8(linear)).any(dim=1)
    graded = ((linear > 0) & (linear < 1)).any(dim=1)
    off_pct = 100.0 * int(bad.sum()) / max(int((bad | graded).sum()), 1)
    print(f"off {int(bad.sum())} of {int((bad | graded).sum())} graded-or-off pixels")
    assert int(graded.sum()) > W * H // 4  # the scene fills the frame
    assert off_pct <= CELL["limits"]["off_pct"]
    # The glass is in view: rows beyond one bounce a sample, and the split.
    assert sum(glass_frame["split"]) > 0
    assert int(glass_frame["stats"]["alive"].reshape(SPP, DEPTH)[:, 1:].sum()) > 0


def test_counters_equal_the_stats_and_the_candidate_masks(glass_frame):
    made, stats = glass_frame["made"], glass_frame["stats"]
    assert made["whitted.rays"] == SPP * W * H + int(stats["alive"].sum())
    assert made["whitted.split"] == sum(glass_frame["split"]) > 0
    assert made.get("wavefront.dropped", 0) == int(stats["dropped"].sum()) == 0


def test_counters_add_no_host_sync(glass_frame):
    """Per sub-pixel offset the camera's two uploads and the offset's one;
    per shading pass, which shades the four samples' rows at once, the
    query's and the occluder's bin widths; per compaction its one count
    read (every sample's branch-B count rides on it; the parked rows are
    written on the card)."""
    alive = glass_frame["stats"]["alive"].reshape(SPP, DEPTH).sum(dim=0)
    shading = 1 + int((alive[:DEPTH - 1] > 0).sum())
    compacting = 1 + int((alive[:DEPTH - 2] > 0).sum())
    syncs = {k: v for k, v in glass_frame["made"].items() if k.startswith("sync.")}
    assert syncs == {"sync.camera": 2 * SPP, "sync.offset": SPP,
                     "sync.bin_width": 2 * shading,
                     "sync.compact_count": compacting}


# ---------------------------------------------------------------------------
# The reference's refraction at one sphere
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sphere():
    """A unit glass sphere's triangles (float64) at the origin."""
    verts, idx = bench_scene.sphere_mesh(20, 20)
    data = {"meshes": [{"vertices": verts, "indices": idx, "material": 0}],
            "materials": [dict(bench_scene_glass.GLASS)]}
    return Triangles(data, "cpu")


def hit_normal(tris, o, d):
    """The hit points and unit face normals of rays (o, d) on ``tris``."""
    t, tri, _, _ = tris.closest(o, d)
    assert (tri >= 0).all()
    return o + d * t[:, None], tris.face_normal[tri]


def test_refraction_obeys_snell(sphere):
    n_rays = 64
    rng = np.random.default_rng(3)
    xy = torch.as_tensor(rng.uniform(-0.6, 0.6, (n_rays, 2)))
    o = torch.cat([xy, torch.full((n_rays, 1), 5.0, dtype=torch.float64)], dim=1)
    d = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64).expand(n_rays, 3)
    _, n = hit_normal(sphere, o, d)
    ior = torch.full((n_rays,), 1.5, dtype=torch.float64)
    refr, refl, fres, tir = ref.refract_fresnel(d, n, ior)
    assert not tir.any()
    sin_i = torch.linalg.vector_norm(torch.linalg.cross(d, n), dim=1)
    sin_t = torch.linalg.vector_norm(torch.linalg.cross(refr, n), dim=1)
    torch.testing.assert_close(sin_t * 1.5, sin_i, rtol=0, atol=1e-12)
    # In the plane of incidence, through the surface, unit length.
    assert (torch.linalg.det(torch.stack([d, n, refr], dim=1)).abs() < 1e-12).all()
    assert ((refr * n).sum(1) < 0).all() and ((refl * n).sum(1) > 0).all()
    torch.testing.assert_close(torch.linalg.vector_norm(refr, dim=1),
                               torch.ones(n_rays, dtype=torch.float64))
    # Leaving the glass the other way round: eta = ior, back to the ray.
    back, _, _, tir_back = ref.refract_fresnel(-refr, n, ior)
    assert not tir_back.any()
    torch.testing.assert_close(back, -d, rtol=0, atol=1e-12)
    assert ((fres > 0.04) & (fres < 1)).all()


def test_fresnel_at_normal_incidence_is_four_percent(sphere):
    o = torch.tensor([[0.0, 0.0, 5.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, -1.0]], dtype=torch.float64)
    _, n = hit_normal(sphere, o, d)
    d = -n  # exactly along the face normal
    for inside in (False, True):
        ray = -d if inside else d
        refr, _, fres, tir = ref.refract_fresnel(ray, n, torch.tensor([1.5], dtype=torch.float64))
        assert not tir.any()
        torch.testing.assert_close(fres, torch.tensor([0.04], dtype=torch.float64),
                                   rtol=0, atol=1e-15)
        torch.testing.assert_close(refr, ray, rtol=0, atol=1e-12)


def test_grazing_ray_inside_takes_total_internal_reflection(sphere):
    """A ray from inside the sphere meeting its surface at 80 degrees from
    the normal: sin^2 t = 2.25 sin^2 80 > 1, so all of it reflects."""
    o = torch.tensor([[0.0, 0.0, 0.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    p, n = hit_normal(sphere, o, d)
    tangent = torch.linalg.cross(n, torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64))
    tangent = tangent / torch.linalg.vector_norm(tangent)
    angle = np.deg2rad(80.0)
    ray = np.cos(angle) * n + np.sin(angle) * tangent  # outward, inside the glass
    _, refl, fres, tir = ref.refract_fresnel(ray, n, torch.tensor([1.5], dtype=torch.float64))
    assert tir.all() and float(fres) == 1.0
    torch.testing.assert_close(refl, ray - 2.0 * (ray * n).sum() * n)
    # Under the critical angle (41.8 degrees) it leaves the glass instead.
    ray = np.cos(np.deg2rad(40.0)) * n + np.sin(np.deg2rad(40.0)) * tangent
    _, _, fres, tir = ref.refract_fresnel(ray, n, torch.tensor([1.5], dtype=torch.float64))
    assert not tir.any() and float(fres) < 1.0


# ---------------------------------------------------------------------------
# Without glass: the Whitted reference
# ---------------------------------------------------------------------------


def test_without_glass_at_spp1_it_is_the_whitted_reference(small_blocks):
    data = bench_scene.build(2**31 + 11, n_tris=3_000, width=48, height=32)
    tris = Triangles(data, "cpu")
    pose = (data["camera"]["position"], data["camera"]["rotation"])
    flat = torch.arange(48 * 32)
    px, py = flat % 48, flat // 48
    args = {"max_depth": 3}
    want = plain_ref.render_pixels(tris, data, pose, px, py, args)
    got = ref.render_pixels(tris, data, pose, px, py, dict(args, spp=1))
    assert torch.equal(got, want)
    assert int(((want > 0) & (want < 1)).any(dim=1).sum()) > 48 * 32 // 4
