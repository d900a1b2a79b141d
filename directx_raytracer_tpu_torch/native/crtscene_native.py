"""ctypes front-end of the native .crtscene parser (parser.cpp).

Counterpart of ``directx_raytracer_tpu/native/crtscene_native.py``
(``load``).  ``load(path)`` returns a fully-populated Scene; it raises
``build.NativeLibraryError`` when the native library is unavailable and
``ValueError`` on a parse error (``io.crtscene.load`` decides whether to
fall back to the pure-Python parser).  Schema semantics mirror the
reference byte-for-byte (CRTSceneParser.cpp) — including
string-albedo-as-texture-name, refractive albedo forced to white, and
bitmap as the fallback texture type.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..models.camera import Camera
from ..models.light import Light
from ..models.material import Material, MaterialType
from ..models.mesh import Mesh
from ..models.scene import Scene, SceneSettings
from ..models.texture import Texture, TextureType
from . import build

_MAT_TYPES = {
    "diffuse": MaterialType.DIFFUSE,
    "reflective": MaterialType.REFLECTIVE,
    "refractive": MaterialType.REFRACTIVE,
    "constant": MaterialType.CONSTANT,
}


def load(path: str) -> Scene:
    lib = build.get_library()

    err = ctypes.create_string_buffer(256)
    handle = lib.crt_parse(path.encode(), err, len(err))
    if not handle:
        raise ValueError(f"native .crtscene parse failed: {err.value.decode()}")
    try:
        return _build_scene(lib, handle)
    finally:
        lib.crt_free(handle)


def _build_scene(lib, h) -> Scene:
    scene = Scene()

    bg = np.zeros(3, np.float32)
    w = ctypes.c_int()
    hgt = ctypes.c_int()
    lib.crt_settings(h, build.fptr(bg), ctypes.byref(w), ctypes.byref(hgt))
    scene.settings = SceneSettings(background_color=bg, image_width=w.value,
                                   image_height=hgt.value)

    mat9 = np.eye(3, dtype=np.float32).reshape(-1).copy()
    pos = np.zeros(3, np.float32)
    if lib.crt_camera(h, build.fptr(mat9), build.fptr(pos)):
        scene.camera = Camera(position=pos, rotation=mat9.reshape(3, 3))

    n = lib.crt_num_lights(h)
    if n:
        lpos = np.zeros((n, 3), np.float32)
        lint = np.zeros(n, np.float32)
        lib.crt_lights(h, build.fptr(lpos), build.fptr(lint))
        for i in range(n):
            scene.lights.append(Light(position=lpos[i].copy(),
                                      intensity=float(lint[i])))

    for i in range(lib.crt_num_materials(h)):
        typ = ctypes.create_string_buffer(64)
        tex = ctypes.create_string_buffer(128)
        albedo = np.zeros(3, np.float32)
        smooth = ctypes.c_int()
        ior = ctypes.c_float()
        has_tex = ctypes.c_int()
        spec2 = np.zeros(2, np.float32)  # specular, shininess
        lib.crt_material(h, i, typ, 64, build.fptr(albedo),
                         ctypes.byref(smooth), ctypes.byref(ior), tex, 128,
                         ctypes.byref(has_tex), build.fptr(spec2))
        # Unknown type strings fall back to REFRACTIVE
        # (CRTSceneParser.cpp:325-343), which forces albedo white (:360-370).
        mtype = _MAT_TYPES.get(typ.value.decode(), MaterialType.REFRACTIVE)
        # ior applies only to REFRACTIVE materials (matches io/crtscene.py:
        # the Python parser ignores an ior key on other types, and only
        # refractive shading ever consumes it).
        mat = Material(type=mtype, smooth_shading=bool(smooth.value))
        if mtype == MaterialType.REFRACTIVE:
            mat.ior = float(ior.value)
            mat.albedo = np.ones(3, np.float32)
        else:
            mat.albedo = albedo.copy()
        if has_tex.value:
            mat.texture_name = tex.value.decode()
        mat.specular = float(spec2[0])
        mat.shininess = float(spec2[1])
        scene.materials.append(mat)

    for i in range(lib.crt_num_textures(h)):
        name = ctypes.create_string_buffer(128)
        typ = ctypes.create_string_buffer(64)
        albedo = np.zeros(3, np.float32)
        ca = np.zeros(3, np.float32)
        cb = np.zeros(3, np.float32)
        edge = np.zeros(3, np.float32)
        scalars = np.zeros(2, np.float32)
        fpath = ctypes.create_string_buffer(256)
        lib.crt_texture(h, i, name, 128, typ, 64, build.fptr(albedo),
                        build.fptr(ca), build.fptr(cb), build.fptr(edge),
                        build.fptr(scalars), fpath, 256)
        tex = Texture(name=name.value.decode())
        ttype = typ.value.decode()
        if ttype == "albedo":
            tex.type = TextureType.ALBEDO
            tex.color_a = albedo.copy()
        elif ttype == "edges":
            tex.type = TextureType.EDGES
            tex.color_a = edge.copy()
            tex.color_b = cb.copy()
            tex.scalar = float(scalars[1])
        elif ttype == "checker":
            tex.type = TextureType.CHECKER
            tex.color_a = ca.copy()
            tex.color_b = cb.copy()
            tex.scalar = float(scalars[0])
        else:  # bitmap + unknown-type fallback (CRTSceneParser.cpp:292-303)
            tex.type = TextureType.BITMAP
            tex.file_path = fpath.value.decode()
        scene.textures.append(tex)

    for i in range(lib.crt_num_objects(h)):
        nv = ctypes.c_int()
        nt = ctypes.c_int()
        nuv = ctypes.c_int()
        mi = ctypes.c_int()
        lib.crt_object_counts(h, i, ctypes.byref(nv), ctypes.byref(nt),
                              ctypes.byref(nuv), ctypes.byref(mi))
        verts = np.zeros(nv.value, np.float32)
        tris = np.zeros(nt.value, np.int32)
        uvs = np.zeros(nuv.value, np.float32)
        lib.crt_object_data(h, i, build.fptr(verts), build.iptr(tris),
                            build.fptr(uvs))
        mesh = Mesh(vertices=verts.reshape(-1, 3), indices=tris,
                    material_index=mi.value)
        if nuv.value:
            mesh.uvs = uvs.reshape(-1, 3)
        # Parse-time vertex normals, natively (CRTMesh.cpp:66-94).
        mesh.normals = build.vertex_normals(lib, mesh.vertices, tris)
        scene.meshes.append(mesh)

    return scene
