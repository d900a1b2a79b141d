"""The benchmark's door into the program, ``directx_raytracer_tpu_torch``.

The benchmark drives the port through the entries its viewer uses: the
port's ``Scene`` built from the benchmark's scene data, ``Renderer``
(``render_frame``, ``render_whitted_frame``, ``to_u8_device``) and the
camera the viewer moves.  Counters read from the program (the visit lists
of the closest-hit queries a frame runs) come through here too.  Nothing else of the
benchmark imports the port, and the plain reference never does.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from directx_raytracer_tpu_torch.models.camera import Camera
from directx_raytracer_tpu_torch.models.light import Light
from directx_raytracer_tpu_torch.models.material import Material, MaterialType
from directx_raytracer_tpu_torch.models.mesh import Mesh
from directx_raytracer_tpu_torch.models.scene import Scene, SceneSettings
from directx_raytracer_tpu_torch.render.renderer import Renderer

MATERIAL_TYPES = {"diffuse": MaterialType.DIFFUSE,
                  "reflective": MaterialType.REFLECTIVE,
                  "refractive": MaterialType.REFRACTIVE,
                  "constant": MaterialType.CONSTANT}


def port_scene(data: dict) -> Scene:
    """The port's host ``Scene`` for the benchmark's scene data; the port
    computes its own vertex normals, as its loaders do."""
    scene = Scene()
    scene.settings = SceneSettings(
        background_color=np.asarray(data["background"], np.float32),
        image_width=data["width"], image_height=data["height"])
    scene.camera = Camera(position=data["camera"]["position"],
                          rotation=data["camera"]["rotation"])
    for m in data["meshes"]:
        mesh = Mesh(vertices=np.asarray(m["vertices"], np.float32),
                    indices=np.asarray(m["indices"], np.int32),
                    material_index=m["material"])
        mesh.calculate_vertex_normals()
        scene.meshes.append(mesh)
    for mat in data["materials"]:
        scene.materials.append(Material(
            type=MATERIAL_TYPES[mat["type"]],
            albedo=np.asarray(mat["albedo"], np.float32),
            smooth_shading=bool(mat.get("smooth", False)),
            ior=float(mat.get("ior", 1.0))))
    for light in data["lights"]:
        scene.lights.append(Light(position=np.asarray(light["position"], np.float32),
                                  intensity=float(light["intensity"])))
    return scene


def renderer(data: dict, device) -> Renderer:
    """The viewer's ``Renderer`` over the scene data (the BVH build is part
    of it), at the scene's own size."""
    return Renderer(port_scene(data), data["width"], data["height"], device=device)


def set_pose(r: Renderer, pose) -> None:
    """Move the viewer's camera to ``pose`` = (position, rotation)."""
    r.camera.position = np.array(pose[0], np.float32)
    r.camera.rotation = np.array(pose[1], np.float32)


@contextmanager
def closest_queries():
    """While open, record every closest-hit query the program runs, as the
    query itself returned it: (its tiles' visit-list lengths from
    ``bin_lists``, a tensor left on the device; the slots of a cluster).
    It wraps ``cuda_intersect.closest_query``, which ``intersect_fused``
    looks up at each call, and puts it back on close."""
    from directx_raytracer_tpu_torch.bvh import cuda_intersect as ci

    seen: list = []
    original = ci.closest_query

    def recorded(*args, **kwargs):
        q = original(*args, **kwargs)
        seen.append((q.counts, int(q.wrows.shape[1])))
        return q

    ci.closest_query = recorded
    try:
        yield seen
    finally:
        ci.closest_query = original
