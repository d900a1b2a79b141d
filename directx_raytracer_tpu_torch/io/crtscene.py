"""Loader for the ``.crtscene`` JSON scene format.

Counterpart of ``directx_raytracer_tpu/io/crtscene.py``: its pure-Python
``loads``/``load`` path, copied unchanged.  The native C++ parser there
(``directx_raytracer_tpu/native``) is not ported yet, so ``load`` always
parses in Python.

Accepts the exact schema the reference parses (CRTSceneParser.cpp:407-427):

```
settings:  { background_color: [3], image_settings: { width, height } }
camera:    { matrix: [9] (row-major 3x3), position: [3] }
objects:   [ { material_index, vertices: [3V], triangles: [3T], uvs: [3V]? } ]
lights:    [ { intensity, position: [3] } ]
materials: [ { type, albedo: [3] | "texture name", smooth_shading, ior? } ]
textures:  [ { name, type, ...per-type params } ]
```

Quirks honored from the reference implementation:

* unknown material ``type`` strings fall back to REFRACTIVE
  (CRTSceneParser.cpp:325-343);
* a REFRACTIVE material reads ``ior`` and forces albedo to (1,1,1)
  (CRTSceneParser.cpp:360-370);
* a *string* ``albedo`` is a texture name (CRTSceneParser.cpp:380-384);
* unknown texture ``type`` strings fall back to a bitmap with ``file_path``
  (CRTSceneParser.cpp:292-303);
* vertex normals are computed at parse time (CRTSceneParser.cpp:131);
* every top-level section is optional (each parse step checks presence).

Divergence (documented): the reference ignores the parsed
``image_settings`` at render time — 1920x1080 is hard-coded in its swapchain,
output texture, dispatch, and raygen shader (DXRTRenderer.cpp:181-182,
925-926, 1348-1349; HLSL/ray_tracing_shaders.hlsl:24-25).  This framework
honors the scene file's width/height.
"""

from __future__ import annotations

import json

import numpy as np

from ..models.light import Light
from ..models.material import Material, MaterialType
from ..models.mesh import Mesh
from ..models.scene import Scene
from ..models.texture import Texture, TextureType

_MATERIAL_TYPES = {
    "diffuse": MaterialType.DIFFUSE,
    "reflective": MaterialType.REFLECTIVE,
    "constant": MaterialType.CONSTANT,
    # anything else — including "refractive" — resolves to REFRACTIVE,
    # matching getMaterialTypeFromString's fallback.
}


def _vec3(arr, start=0):
    return np.asarray(arr[start : start + 3], dtype=np.float32)


def _parse_settings(doc: dict, scene: Scene) -> None:
    s = doc.get("settings")
    if not isinstance(s, dict):
        return
    if "background_color" in s:
        scene.settings.background_color = _vec3(s["background_color"])
    img = s.get("image_settings")
    if isinstance(img, dict):
        if "width" in img:
            scene.settings.image_width = int(img["width"])
        if "height" in img:
            scene.settings.image_height = int(img["height"])


def _parse_camera(doc: dict, scene: Scene) -> None:
    c = doc.get("camera")
    if not isinstance(c, dict):
        return
    if "matrix" in c:
        m = np.asarray(c["matrix"], dtype=np.float32).reshape(3, 3)
        scene.camera.rotation = m
    if "position" in c:
        scene.camera.position = _vec3(c["position"])


def _parse_objects(doc: dict, scene: Scene) -> None:
    for obj in doc.get("objects") or []:
        mesh = Mesh()
        uvs = obj.get("uvs")
        if uvs:
            mesh.uvs = np.asarray(uvs, dtype=np.float32).reshape(-1, 3)
        verts = obj.get("vertices")
        if verts:
            mesh.vertices = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
        tris = obj.get("triangles")
        if tris:
            mesh.indices = np.asarray(tris, dtype=np.int32)
        mesh.material_index = int(obj.get("material_index", 0))
        mesh.calculate_vertex_normals()
        scene.meshes.append(mesh)


def _parse_lights(doc: dict, scene: Scene) -> None:
    for l in doc.get("lights") or []:
        light = Light()
        if "position" in l:
            light.position = _vec3(l["position"])
        if "intensity" in l:
            light.intensity = float(l["intensity"])
        scene.lights.append(light)


def _parse_materials(doc: dict, scene: Scene) -> None:
    for m in doc.get("materials") or []:
        mat = Material()
        if "type" in m:
            mat.type = _MATERIAL_TYPES.get(m["type"], MaterialType.REFRACTIVE)
        if mat.type == MaterialType.REFRACTIVE:
            if "ior" in m:
                mat.ior = float(m["ior"])
            mat.albedo = np.ones(3, np.float32)
        else:
            albedo = m.get("albedo")
            if isinstance(albedo, (list, tuple)):
                mat.albedo = _vec3(albedo)
            elif isinstance(albedo, str):
                mat.texture_name = albedo
        if "smooth_shading" in m:
            mat.smooth_shading = bool(m["smooth_shading"])
        # Blinn-Phong extension keys (absent from reference scenes).
        if "specular" in m:
            mat.specular = float(m["specular"])
        if "shininess" in m:
            mat.shininess = float(m["shininess"])
        scene.materials.append(mat)


def _parse_textures(doc: dict, scene: Scene) -> None:
    for t in doc.get("textures") or []:
        tex = Texture(name=t.get("name", ""))
        ttype = t.get("type", "")
        if ttype == "albedo":
            tex.type = TextureType.ALBEDO
            if "albedo" in t:
                tex.color_a = _vec3(t["albedo"])
        elif ttype == "edges":
            tex.type = TextureType.EDGES
            if "edge_color" in t:
                tex.color_a = _vec3(t["edge_color"])
            if "inner_color" in t:
                tex.color_b = _vec3(t["inner_color"])
            if "edge_width" in t:
                tex.scalar = float(t["edge_width"])
        elif ttype == "checker":
            tex.type = TextureType.CHECKER
            if "color_A" in t:
                tex.color_a = _vec3(t["color_A"])
            if "color_B" in t:
                tex.color_b = _vec3(t["color_B"])
            if "square_size" in t:
                tex.scalar = float(t["square_size"])
        else:  # bitmap, and the fallback for unknown types
            tex.type = TextureType.BITMAP
            tex.file_path = t.get("file_path", "")
        scene.textures.append(tex)


def loads(text: str) -> Scene:
    doc = json.loads(text)
    scene = Scene()
    _parse_settings(doc, scene)
    _parse_camera(doc, scene)
    _parse_objects(doc, scene)
    _parse_lights(doc, scene)
    _parse_materials(doc, scene)
    _parse_textures(doc, scene)
    return scene


def load(path: str) -> Scene:
    """Parse a .crtscene file (pure Python)."""
    with open(path, "r") as f:
        return loads(f.read())
