"""Triangle mesh — mirrors ``CRTMesh`` (reference: CRTMesh.{h,cpp}).

Counterpart of ``directx_raytracer_tpu/models/mesh.py`` (``Mesh``,
``face_normals``, ``vertex_normals``), copied unchanged (numpy only).

Geometry is stored SoA (vertices ``(V, 3)``, flat triangle indices ``(3T,)``,
UVs ``(V, 3)``) instead of vectors-of-objects, so meshes convert to device
buffers with zero reshaping.

Vertex normals follow CRTMesh::calculateVertexNormals (CRTMesh.cpp:66-94):
every adjacent triangle's **unit** geometric normal (normalize(cross(E0, E1)),
CRTTriangle.cpp:22-30) is accumulated per vertex, then the sums are
normalized — i.e., angle/area-unweighted accumulation.  Implemented as a
vectorized segment-sum rather than an index loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def face_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Unit geometric normals, one per triangle: normalize(cross(v1-v0, v2-v0))."""
    tri = indices.reshape(-1, 3)
    v0 = vertices[tri[:, 0]]
    e0 = vertices[tri[:, 1]] - v0
    e1 = vertices[tri[:, 2]] - v0
    n = np.cross(e0, e1)
    length = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.where(length > 0, length, 1.0)).astype(np.float32)


def vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Segment-sum of adjacent unit face normals, then normalize
    (CRTMesh.cpp:66-94 semantics, vectorized)."""
    fn = face_normals(vertices, indices)
    tri = indices.reshape(-1, 3)
    acc = np.zeros_like(vertices, dtype=np.float32)
    for corner in range(3):
        np.add.at(acc, tri[:, corner], fn)
    length = np.linalg.norm(acc, axis=-1, keepdims=True)
    return (acc / np.where(length > 0, length, 1.0)).astype(np.float32)


@dataclass
class Mesh:
    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    indices: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    material_index: int = 0
    normals: np.ndarray | None = None

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def calculate_vertex_normals(self) -> None:
        self.normals = vertex_normals(self.vertices, self.indices)
