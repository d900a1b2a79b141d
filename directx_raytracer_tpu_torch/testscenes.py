"""Procedurally generated scenes for tests and benchmarks.

The reference ships a single asset (Scenes/Dragon.crtscene, 4,014 tris).
These builders cover the BASELINE.json config tiers without shipping large
binary assets: a unit triangle (config 1), a Cornell box (config 2), random
triangle soups and a UV-sphere / displaced-grid family up to 1M triangles
(configs 3-5 + the 100k-tri bench scene).

Counterpart of ``directx_raytracer_tpu/testscenes.py``, copied whole (numpy
only); ``bench_scene`` is the port's main workload.
"""

from __future__ import annotations

import numpy as np

from .models.camera import Camera
from .models.light import Light
from .models.material import Material, MaterialType
from .models.mesh import Mesh
from .models.scene import Scene, SceneSettings


def _mesh(vertices, triangles, material_index=0, uvs=None) -> Mesh:
    m = Mesh(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        indices=np.asarray(triangles, np.int32).reshape(-1),
        material_index=material_index,
    )
    if uvs is not None:
        m.uvs = np.asarray(uvs, np.float32).reshape(-1, 3)
    m.calculate_vertex_normals()
    return m


def single_triangle(width=640, height=480) -> Scene:
    """BASELINE config 1: one triangle in front of the camera."""
    scene = Scene()
    scene.settings = SceneSettings(
        background_color=np.array([0.0, 0.0, 0.0], np.float32),
        image_width=width,
        image_height=height,
    )
    scene.camera = Camera(position=(0.0, 0.0, 2.0))
    scene.meshes.append(
        _mesh(
            [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
            [0, 1, 2],
            uvs=[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        )
    )
    scene.materials.append(
        Material(type=MaterialType.CONSTANT, albedo=np.array([1.0, 0.2, 0.1], np.float32))
    )
    scene.lights.append(Light(position=np.array([0, 2, 2], np.float32), intensity=30.0))
    return scene


def cornell_box(width=800, height=600, light_intensity=60.0) -> Scene:
    """BASELINE config 2: classic Cornell box, Lambertian walls, point light.

    Box spans [-1,1]^3; camera at +z looking down -z (identity rotation)."""
    scene = Scene()
    scene.settings = SceneSettings(
        background_color=np.array([0.0, 0.0, 0.0], np.float32),
        image_width=width,
        image_height=height,
    )
    scene.camera = Camera(position=(0.0, 0.0, 3.2))

    def quad(a, b, c, d, mat):
        scene.meshes.append(_mesh([a, b, c, d], [0, 1, 2, 0, 2, 3], material_index=mat))

    # floor(0), ceiling(1), back(2), left red(3), right green(4)
    quad([-1, -1, 1], [1, -1, 1], [1, -1, -1], [-1, -1, -1], 0)
    quad([-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1], 0)
    quad([-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1], 0)
    quad([-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1], 1)
    quad([1, -1, -1], [1, -1, 1], [1, 1, 1], [1, 1, -1], 2)
    # short block
    scene.meshes.append(
        _mesh(
            [
                [-0.5, -1.0, -0.2], [0.0, -1.0, -0.2], [0.0, -0.4, -0.2], [-0.5, -0.4, -0.2],
                [-0.5, -1.0, -0.7], [0.0, -1.0, -0.7], [0.0, -0.4, -0.7], [-0.5, -0.4, -0.7],
            ],
            # front, top, left, right, back
            [0, 1, 2, 0, 2, 3,  3, 2, 6, 3, 6, 7,  4, 0, 3, 4, 3, 7,
             1, 5, 6, 1, 6, 2,  5, 4, 7, 5, 7, 6],
            material_index=0,
        )
    )

    white = np.array([0.73, 0.73, 0.73], np.float32)
    red = np.array([0.65, 0.05, 0.05], np.float32)
    green = np.array([0.12, 0.45, 0.15], np.float32)
    scene.materials += [
        Material(type=MaterialType.DIFFUSE, albedo=white),
        Material(type=MaterialType.DIFFUSE, albedo=red),
        Material(type=MaterialType.DIFFUSE, albedo=green),
    ]
    scene.lights.append(
        Light(position=np.array([0.0, 0.9, 0.4], np.float32), intensity=light_intensity)
    )
    return scene


def random_soup(n_tris: int, seed: int = 0, spread: float = 10.0, size: float = 0.5) -> Scene:
    """Random triangle soup in a [-spread, spread] cube — property-test fodder
    for BVH == brute-force equivalence."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tris, 1, 3))
    offsets = rng.uniform(-size, size, (n_tris, 3, 3))
    verts = (centers + offsets).astype(np.float32).reshape(-1, 3)
    tris = np.arange(3 * n_tris, dtype=np.int32)

    scene = Scene()
    scene.settings = SceneSettings(image_width=320, image_height=240)
    scene.camera = Camera(position=(0.0, 0.0, spread * 2.5))
    scene.meshes.append(_mesh(verts, tris))
    scene.materials.append(
        Material(type=MaterialType.DIFFUSE, albedo=np.array([0.7, 0.7, 0.7], np.float32))
    )
    scene.lights.append(Light(position=np.array([0, spread, spread], np.float32), intensity=900.0))
    return scene


def sphere_mesh(n_lat: int, n_lon: int, radius=1.0, center=(0.0, 0.0, 0.0)):
    """UV sphere: returns (vertices, triangles) arrays (2*n_lat*n_lon tris)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius + np.asarray(center)

    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            jn = (j + 1) % n_lon
            a = i * n_lon + j
            b = i * n_lon + jn
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + jn
            tris += [a, b, c, b, d, c]
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def bench_scene(n_tris: int = 100_000, width=1920, height=1080, seed: int = 7) -> Scene:
    """The BASELINE bench workload: ~n_tris triangles with spatial structure
    (a field of spheres over a ground plane), 1080p, 4 point lights."""
    scene = Scene()
    scene.settings = SceneSettings(
        background_color=np.array([0.0, 0.5, 0.0], np.float32),
        image_width=width,
        image_height=height,
    )
    scene.camera = Camera(position=(0.0, 14.0, 26.0))
    scene.camera.rotate(0.0, 20.0)  # view = -forward: +pitch tilts the view down

    # ground plane
    scene.meshes.append(
        _mesh([[-40, -5, 40], [40, -5, 40], [-40, -5, -40], [40, -5, -40]], [0, 1, 2, 3, 2, 1], 0)
    )

    rng = np.random.default_rng(seed)
    tris_per_sphere = 800  # 20 x 20 UV sphere
    n_spheres = max(1, (n_tris - 2) // tris_per_sphere)
    grid = int(np.ceil(np.sqrt(n_spheres)))
    count = 0
    verts_all, tris_all = [], []
    base = 0
    for i in range(grid):
        for j in range(grid):
            if count >= n_spheres:
                break
            cx = (i - grid / 2) * 4.0 + rng.uniform(-1, 1)
            cz = (j - grid / 2) * 4.0 + rng.uniform(-1, 1)
            cy = -4.0 + rng.uniform(0.0, 6.0)
            r = rng.uniform(0.6, 1.4)
            v, t = sphere_mesh(20, 20, radius=r, center=(cx, cy, cz))
            verts_all.append(v)
            tris_all.append(t + base)
            base += len(v)
            count += 1
    scene.meshes.append(
        _mesh(np.concatenate(verts_all), np.concatenate(tris_all), material_index=1)
    )

    scene.materials += [
        Material(type=MaterialType.REFLECTIVE, albedo=np.array([0.8, 0.8, 0.8], np.float32),
                 smooth_shading=True),
        Material(type=MaterialType.DIFFUSE, albedo=np.array([0.9, 0.6, 0.9], np.float32),
                 smooth_shading=True),
    ]
    for pos, inten in [((9, 7, 0), 2000.0), ((-9, 16, 0), 2000.0),
                       ((0, 9, 7.5), 500.0), ((0, 9, -7.5), 500.0)]:
        scene.lights.append(Light(position=np.array(pos, np.float32), intensity=inten))
    return scene


def const_color(width=800, height=800) -> Scene:
    """Named bring-up config for BASELINE config 1's "flat ConstColor
    shading" — the reference's legacy raster pipeline (ConstColor.hlsl,
    compiled but never initialized: DXRTRenderer.h:218-223).  A quad + a
    triangle, all CONSTANT materials: the Whitted renderer shades them flat
    (albedo, no lights, no bounces), so the render is an exact albedo
    fill — the first thing to bring up on new hardware.

    Use:  python -m directx_raytracer_tpu_torch.viewer render --builtin const_color
    """
    scene = Scene()
    scene.settings = SceneSettings(
        background_color=np.array([0.0, 0.0, 0.25], np.float32),
        image_width=width,
        image_height=height,
    )
    scene.camera = Camera(position=(0.0, 0.0, 3.0))
    # full-frame backdrop quad
    scene.meshes.append(
        _mesh(
            [[-4, -4, -1], [4, -4, -1], [-4, 4, -1], [4, 4, -1]],
            [0, 1, 2, 2, 1, 3],
            material_index=0,
        )
    )
    # foreground triangle
    scene.meshes.append(
        _mesh(
            [[-0.8, -0.6, 0.0], [0.8, -0.6, 0.0], [0.0, 0.9, 0.0]],
            [0, 1, 2],
            material_index=1,
        )
    )
    scene.materials += [
        Material(type=MaterialType.CONSTANT,
                 albedo=np.array([0.1, 0.35, 0.1], np.float32)),
        Material(type=MaterialType.CONSTANT,
                 albedo=np.array([1.0, 0.45, 0.1], np.float32)),
    ]
    return scene
