"""The bench scene with half of its spheres glass.

``bench_scene.build`` as it is, seeded by the run: the same triangles,
lights, mirror ground and camera.  Sphere k (in the generator's order) moves
to a third mesh when k is even, with a refractive material of index 1.5:
62 of the 100k scene's 124 spheres.  The diffuse spheres keep their mesh
and material, so the meshes are the ground, the odd spheres and the even
ones.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes import bench_scene

GLASS = {"type": "refractive", "albedo": np.array([1.0, 1.0, 1.0], np.float32),
         "smooth": True, "ior": 1.5}


def build(seed: int, n_tris: int = 100_000, width: int = 1920,
          height: int = 1080) -> dict:
    data = bench_scene.build(seed, n_tris=n_tris, width=width, height=height)
    spheres = data["meshes"][1]
    tris = spheres["indices"].reshape(-1, bench_scene.TRIS_PER_SPHERE * 3)
    verts_per_sphere = len(spheres["vertices"]) // len(tris)
    verts = spheres["vertices"].reshape(len(tris), verts_per_sphere, 3)
    meshes = []
    for parity, material in ((1, 1), (0, 2)):
        ks = np.arange(parity, len(tris), 2)
        # Each sphere's indices, rebased from its place among all spheres
        # to its place among those kept.
        local = tris[ks] - (ks * verts_per_sphere)[:, None]
        rebased = local + (np.arange(len(ks)) * verts_per_sphere)[:, None]
        meshes.append({"vertices": verts[ks].reshape(-1, 3),
                       "indices": rebased.reshape(-1).astype(np.int32),
                       "material": material})
    data["meshes"] = [data["meshes"][0]] + meshes
    data["materials"] = data["materials"] + [GLASS]
    return data
