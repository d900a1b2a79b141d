"""Build + bind the native runtime library (parser.cpp via g++ and ctypes).

Counterpart of ``directx_raytracer_tpu/native/build.py`` (``get_library``,
``fptr``, ``iptr``, ``vertex_normals``).  The shared library is compiled on
first use into the package's ``_build/`` directory, under a name that
carries a hash of parser.cpp and the compiler flags, so a changed source
builds anew.  Binding is plain ctypes; all arrays cross the boundary as
caller-allocated numpy buffers.

Unlike the JAX package's ``get_library``, which returns None when the
library cannot be built, this one raises ``NativeLibraryError``: the caller
(``io.crtscene.load``) decides whether that is a warning or an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "parser.cpp"
BUILD_DIR = _PKG / "_build"
COMPILER = "g++"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}  # library path -> bound CDLL


class NativeLibraryError(RuntimeError):
    """The native parser's library could not be built or loaded."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcrtscene_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [COMPILER, *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeLibraryError(f"native parser build failed: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeLibraryError(
            f"native parser build failed ({' '.join(cmd)}):\n{e.stderr}") from e
    os.replace(tmp, so)  # atomic: processes building at once agree


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.crt_parse.restype = ctypes.c_void_p
    lib.crt_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.crt_free.argtypes = [ctypes.c_void_p]
    lib.crt_settings.argtypes = [ctypes.c_void_p, c_float_p, c_int_p, c_int_p]
    lib.crt_camera.restype = ctypes.c_int
    lib.crt_camera.argtypes = [ctypes.c_void_p, c_float_p, c_float_p]
    lib.crt_num_lights.restype = ctypes.c_int
    lib.crt_num_lights.argtypes = [ctypes.c_void_p]
    lib.crt_lights.argtypes = [ctypes.c_void_p, c_float_p, c_float_p]
    lib.crt_num_materials.restype = ctypes.c_int
    lib.crt_num_materials.argtypes = [ctypes.c_void_p]
    lib.crt_material.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        c_float_p, c_int_p, c_float_p, ctypes.c_char_p, ctypes.c_int,
        c_int_p, c_float_p,
    ]
    lib.crt_num_textures.restype = ctypes.c_int
    lib.crt_num_textures.argtypes = [ctypes.c_void_p]
    lib.crt_texture.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, c_float_p, c_float_p, c_float_p,
        c_float_p, c_float_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.crt_num_objects.restype = ctypes.c_int
    lib.crt_num_objects.argtypes = [ctypes.c_void_p]
    lib.crt_object_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_int_p, c_int_p, c_int_p, c_int_p,
    ]
    lib.crt_object_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_float_p, c_int_p, c_float_p,
    ]
    lib.crt_vertex_normals.argtypes = [
        c_float_p, ctypes.c_int, c_int_p, ctypes.c_int, c_float_p,
    ]
    return lib


def get_library() -> ctypes.CDLL:
    """The bound ctypes library, built first if the one for this source is
    not there.  Raises ``NativeLibraryError`` when it cannot be built or
    loaded."""
    with _lock:
        so = library_path()
        lib = _libs.get(so)
        if lib is None:
            if not so.exists():
                _compile(so)
            try:
                lib = _libs[so] = _bind(ctypes.CDLL(str(so)))
            except OSError as e:
                raise NativeLibraryError(f"native parser unavailable: {e}") from e
        return lib


def fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def vertex_normals(lib, verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    tris = np.ascontiguousarray(tris, np.int32).reshape(-1)
    out = np.empty_like(verts)
    lib.crt_vertex_normals(fptr(verts), len(verts), iptr(tris), len(tris) // 3,
                           fptr(out))
    return out
