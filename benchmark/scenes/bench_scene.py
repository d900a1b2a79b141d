"""The bench scene: a field of UV spheres over a mirror ground plane.

A frozen copy of the port's ``testscenes.bench_scene`` (and its
``sphere_mesh``), kept here so that the benchmark's inputs cannot change
when the program does.  It returns the scene as plain numpy data (see
``benchmark/harness.py`` for the layout), which the harness hands to the
program (as the port's ``Scene``) and to the plain reference alike.

``n_tris`` triangles: ``(n_tris - 2) // 800`` spheres of 20 x 20 quads on a
jittered 4-unit grid (centre, height and radius drawn from ``seed``), one
ground quad, 4 point lights, a reflective ground and diffuse spheres, both
smooth-shaded; the camera at (0, 14, 26) looks 20 degrees down.
"""

from __future__ import annotations

import numpy as np

TRIS_PER_SPHERE = 800  # a 20 x 20 UV sphere


def sphere_mesh(n_lat: int, n_lon: int, radius=1.0, center=(0.0, 0.0, 0.0)):
    """UV sphere: (vertices (V, 3) f32, flat triangle indices (6 n_lat n_lon,)
    i32), in the order of the port's ``testscenes.sphere_mesh``."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius + np.asarray(center)
    i, j = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    jn = (j + 1) % n_lon
    a = i * n_lon + j
    b = i * n_lon + jn
    c = (i + 1) * n_lon + j
    d = (i + 1) * n_lon + jn
    tris = np.stack([a, b, c, b, d, c], axis=-1).reshape(-1)
    return verts.astype(np.float32), tris.astype(np.int32)


def look_down(pitch_deg: float) -> np.ndarray:
    """The camera rotation (columns right, up, forward; the view is
    -forward) after ``Camera.rotate(0, pitch_deg)``."""
    p = np.deg2rad(pitch_deg)
    forward = np.array([0.0, np.sin(p), np.cos(p)])
    forward /= np.linalg.norm(forward)
    right = np.cross([0.0, 1.0, 0.0], forward)
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    return np.stack([right, up, forward], axis=1).astype(np.float32)


def build(seed: int, n_tris: int = 100_000, width: int = 1920,
          height: int = 1080) -> dict:
    rng = np.random.default_rng(seed)
    n_spheres = max(1, (n_tris - 2) // TRIS_PER_SPHERE)
    grid = int(np.ceil(np.sqrt(n_spheres)))
    verts, tris = [], []
    base = 0
    for k in range(n_spheres):
        i, j = divmod(k, grid)
        cx = (i - grid / 2) * 4.0 + rng.uniform(-1, 1)
        cz = (j - grid / 2) * 4.0 + rng.uniform(-1, 1)
        cy = -4.0 + rng.uniform(0.0, 6.0)
        r = rng.uniform(0.6, 1.4)
        v, t = sphere_mesh(20, 20, radius=r, center=(cx, cy, cz))
        verts.append(v)
        tris.append(t + base)
        base += len(v)
    ground = {"vertices": np.array([[-40, -5, 40], [40, -5, 40], [-40, -5, -40],
                                    [40, -5, -40]], np.float32),
              "indices": np.array([0, 1, 2, 3, 2, 1], np.int32), "material": 0}
    spheres = {"vertices": np.concatenate(verts),
               "indices": np.concatenate(tris).astype(np.int32), "material": 1}
    return {
        "width": width,
        "height": height,
        "background": np.array([0.0, 0.5, 0.0], np.float32),
        "camera": {"position": np.array([0.0, 14.0, 26.0], np.float32),
                   "rotation": look_down(20.0)},
        "meshes": [ground, spheres],
        "materials": [
            {"type": "reflective", "albedo": np.array([0.8, 0.8, 0.8], np.float32),
             "smooth": True},
            {"type": "diffuse", "albedo": np.array([0.9, 0.6, 0.9], np.float32),
             "smooth": True},
        ],
        "lights": [{"position": np.array(p, np.float32), "intensity": i}
                   for p, i in (((9, 7, 0), 2000.0), ((-9, 16, 0), 2000.0),
                                ((0, 9, 7.5), 500.0), ((0, 9, -7.5), 500.0))],
    }
