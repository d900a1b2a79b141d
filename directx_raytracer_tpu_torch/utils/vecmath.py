"""Vector / matrix math conventions of the CRT scene core, as numpy ops.

Counterpart of ``directx_raytracer_tpu/utils/vecmath.py``: its host-side
numpy helpers (``vec3``, ``np_normalize``, ``allclose_crt``, ``rot_x/y/z``,
``row_vec_mul``) copied unchanged.  The device-side ``normalize``/``dot``/
``cross`` helpers there serve the Whitted shader and come with that slice.

The reference implements a tiny 3-float vector (`CRTVector`) and a 3x3
row-major matrix (`CRTMatrix`) with two multiplication conventions:

* ``CRTMatrix * CRTMatrix`` — ordinary row-major matrix product
  (reference: CRTMatrix.cpp:4-24).
* ``CRTVector * CRTMatrix`` — a **row-vector** product ``v @ M``
  (reference: CRTMatrix.cpp:26-38), used e.g. by
  ``CRTCamera::panAroundTarget`` (CRTCamera.cpp:113-130).
* The DXR raygen shader multiplies the camera rotation with the ray
  direction as a **column vector**: ``world = M @ v``
  (reference: HLSL/ray_tracing_shaders.hlsl:47 — ``mul(cameraRotation, v)``
  with a row_major matrix uploaded untransposed at DXRTRenderer.cpp:258-265).

``EPSILON`` mirrors the reference's equality tolerance (CRTVector.cpp:76-81).
"""

from __future__ import annotations

import math

import numpy as np

EPSILON = 1e-6  # CRTVector operator== tolerance (CRTVector.cpp:78)
DEG2RAD = math.pi / 180.0


def vec3(x, y, z, dtype=np.float32):
    """Host-side 3-vector (numpy, f32 to match the C++ float math)."""
    return np.array([x, y, z], dtype=dtype)


def np_normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def allclose_crt(a, b, eps=EPSILON):
    """Reference CRTVector equality: per-component |a-b| < eps."""
    return bool(np.all(np.abs(np.asarray(a) - np.asarray(b)) < eps))


# ---------------------------------------------------------------------------
# Rotation factories — exact counterparts of the matrices CRTCamera builds.
# All are host-side float32 numpy (camera state lives on the host; only the
# final 3x3 is shipped to the device each frame, like the reference's
# camera constant buffer upload at DXRTRenderer.cpp:248-270).
# ---------------------------------------------------------------------------


def rot_y(degrees: float) -> np.ndarray:
    """Y-axis rotation used by pan / panAroundTarget (CRTCamera.cpp:9-19)."""
    r = np.float32(degrees * DEG2RAD)
    c, s = np.cos(r, dtype=np.float32), np.sin(r, dtype=np.float32)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], dtype=np.float32)


def rot_x(degrees: float) -> np.ndarray:
    """X-axis rotation used by tilt (CRTCamera.cpp:21-31)."""
    r = np.float32(degrees * DEG2RAD)
    c, s = np.cos(r, dtype=np.float32), np.sin(r, dtype=np.float32)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]], dtype=np.float32)


def rot_z(degrees: float) -> np.ndarray:
    """Z-axis rotation used by roll (CRTCamera.cpp:33-43)."""
    r = np.float32(degrees * DEG2RAD)
    c, s = np.cos(r, dtype=np.float32), np.sin(r, dtype=np.float32)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)


def row_vec_mul(v: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The reference's ``CRTVector * CRTMatrix`` row-vector convention
    (CRTMatrix.cpp:26-38): ``out[i] = sum_j v[j] * m[j][i]``."""
    return np.asarray(v) @ np.asarray(m)
