"""Scene model + conversion to device-resident SoA tensors.

Counterpart of ``directx_raytracer_tpu/models/scene.py``.  The host side
(``Scene``, ``SceneSettings``) and the numpy builders (``_woop_transforms``,
``_np_treelet_leaves``, ``_np_morton_order``, ``build_geometry``,
``build_material_table``, ``build_texture_table``, ``build_light_table``)
are copied unchanged, so the port's buffers equal the JAX package's bit for
bit.  The device side differs only in container: dataclasses of torch
tensors with ``.to(device)`` in place of registered pytrees, and
``build_device_scene(scene, device)`` in place of ``jax.device_put``.
``scene_from_numpy`` takes the JAX package's buffers, handed over as numpy
arrays, so both packages can run on identical inputs.

Host side mirrors ``CRTScene`` (reference: CRTScene.{h,cpp}): settings
(background color + image size, CRTScene.h:9-14), a camera, meshes, lights,
materials and textures, with ``get_texture_by_name`` the same linear scan as
CRTScene.cpp:52-63.

Device side: instead of per-mesh vertex/index buffers + driver-built
BLAS/TLAS (DXRTRenderer.cpp:302-453, 548-806), the whole scene is flattened
at load time into a single triangle-major SoA (`DeviceScene`) of padded
f32 / i32 tensors.  Per-vertex attributes (normals, UVs) are pre-gathered
to per-triangle-corner arrays, and each triangle carries a precomputed
**Woop unit-triangle transform** (a 3x4 affine map into the triangle's
barycentric frame) — see ``ops.intersect``.

Padding note: triangle arrays are padded to a multiple of ``TRI_PAD`` with
sentinel triangles whose Woop translation is -1e30 and linear part 0, which
makes every padded intersection test produce t = +inf (a guaranteed miss)
without branching.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .camera import Camera
from .light import Light
from .material import Material, MaterialType
from .mesh import Mesh, face_normals
from .texture import Texture, TextureType

TRI_PAD = 128  # triangle-count padding; equal to the JAX package's


# ---------------------------------------------------------------------------
# Host-side scene
# ---------------------------------------------------------------------------


@dataclass
class SceneSettings:
    background_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    image_width: int = 1920
    image_height: int = 1080


@dataclass
class Scene:
    settings: SceneSettings = field(default_factory=SceneSettings)
    camera: Camera = field(default_factory=Camera)
    meshes: list[Mesh] = field(default_factory=list)
    lights: list[Light] = field(default_factory=list)
    materials: list[Material] = field(default_factory=list)
    textures: list[Texture] = field(default_factory=list)

    def get_texture_by_name(self, name: str) -> Texture | None:
        for tex in self.textures:
            if tex.name == name:
                return tex
        return None

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)


# ---------------------------------------------------------------------------
# Device-side tensors
# ---------------------------------------------------------------------------


class _Tensors:
    """``.to(device)`` for a dataclass: moves every tensor field (and every
    nested dataclass of tensors), copies the other fields as they are."""

    def to(self, device):
        def move(x):
            if isinstance(x, (torch.Tensor, _Tensors)):
                return x.to(device)
            return x

        return dataclasses.replace(
            self, **{f.name: move(getattr(self, f.name))
                     for f in dataclasses.fields(self)})


@dataclass
class Geometry(_Tensors):
    """Triangle-major SoA geometry, padded to a multiple of TRI_PAD."""

    v0: torch.Tensor  # (T, 3) f32 — first vertex
    e1: torch.Tensor  # (T, 3) f32 — v1 - v0
    e2: torch.Tensor  # (T, 3) f32 — v2 - v0
    woop: torch.Tensor  # (T, 3, 4) f32 — affine map into the unit-triangle frame
    face_normal: torch.Tensor  # (T, 3) f32 — unit geometric normal
    n0: torch.Tensor  # (T, 3) f32 — per-corner vertex normals (smooth shading)
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (T, 3) f32 — per-corner UVs (reference stores 3-comp UVs)
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # (T,) i32 — material index; -1 for padding
    mesh_id: torch.Tensor  # (T,) i32 — InstanceID analog (mesh index)
    local_id: torch.Tensor  # (T,) i32 — PrimitiveIndex analog (tri index in mesh)
    # ONE fused record row per triangle, so a hit fetches everything the
    # shading path needs (geometry, vertex attributes, material) with one
    # row gather.  Layout: v0(3) e1(3) e2(3) local mesh mat | n0(3) n1(3)
    # n2(3) fn(3) uv0.xy uv1.xy uv2.xy | mtype malbedo(3) ior smooth tex_id
    # specular shininess | pad.  The three ids are int32 BIT PATTERNS in
    # f32 slots: read them only with ``.view(torch.int32)``.
    packed: torch.Tensor  # (T, 40) f32
    scene_lo: torch.Tensor  # (3,) f32 — scene AABB
    scene_hi: torch.Tensor  # (3,) f32
    n_tris: int  # DEVICE triangle slots (treelet leaves x CLUSTER_K, incl.
    #              interleaved guaranteed-miss padding; BVH slot == id)
    n_real_tris: int  # true parsed triangle count (stats / tests)
    morton_sorted: bool  # triangles stored in BVH cluster order (slot == id)


@dataclass
class MaterialTable(_Tensors):
    mtype: torch.Tensor  # (M,) i32 — MaterialType
    albedo: torch.Tensor  # (M, 3) f32
    ior: torch.Tensor  # (M,) f32
    smooth: torch.Tensor  # (M,) bool
    tex_id: torch.Tensor  # (M,) i32 — index into TextureTable, -1 = constant albedo
    packed: torch.Tensor  # (M, 12) f32 — type albedo(3) ior smooth tex_id specular shininess pad(3)


@dataclass
class TextureTable(_Tensors):
    ttype: torch.Tensor  # (K,) i32 — TextureType
    color_a: torch.Tensor  # (K, 3) f32
    color_b: torch.Tensor  # (K, 3) f32
    scalar: torch.Tensor  # (K,) f32 — square_size / edge_width
    bitmap_id: torch.Tensor  # (K,) i32 — index into atlas, -1 = procedural
    atlas: torch.Tensor  # (B, Hmax, Wmax, 3) f32 — normalized bitmap pixels
    atlas_size: torch.Tensor  # (B, 2) i32 — (height, width) per bitmap
    packed: torch.Tensor  # (K, 12) f32 — type ca(3) cb(3) scalar bid h w pad


@dataclass
class LightTable(_Tensors):
    position: torch.Tensor  # (L, 3) f32
    intensity: torch.Tensor  # (L,) f32
    n_lights: int


@dataclass
class DeviceScene(_Tensors):
    geometry: Geometry
    materials: MaterialTable
    textures: TextureTable
    lights: LightTable
    background_color: torch.Tensor  # (3,) f32
    has_specular: bool = False  # any material carries a Blinn-Phong term
    has_textures: bool = False  # the scene declares textures
    has_refractive: bool = False  # any REFRACTIVE material exists


def _t(x) -> torch.Tensor:
    """numpy -> CPU tensor with the same dtype and bits."""
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Flattening (numpy, copied from the JAX package)
# ---------------------------------------------------------------------------


def _np_spread_bits_10(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _np_morton_order(v0, e1, e2):
    """Z-curve order of triangle centroids (numpy, scene-build time)."""
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    c = (lo + hi) * 0.5
    smin = lo.min(axis=0)
    ext = np.maximum(hi.max(axis=0) - smin, 1e-12)
    q = np.clip((c - smin) / ext * 1024.0, 0.0, 1023.0).astype(np.int32)
    code = (
        (_np_spread_bits_10(q[:, 0]) << 2)
        | (_np_spread_bits_10(q[:, 1]) << 1)
        | _np_spread_bits_10(q[:, 2])
    )
    return np.argsort(code, kind="stable").astype(np.int32)


def _woop_transforms(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """Per-triangle 3x4 affine maps W = [A^-1 | -A^-1 v0] with A = [e1 e2 n]
    (columns), n = cross(e1, e2).  A ray (o, d) maps to o' = W @ (o, 1),
    d' = W[:, :3] @ d, and intersects at t = -o'_z / d'_z with barycentrics
    u = o'_x + t d'_x, v = o'_y + t d'_y."""
    n = np.cross(e1, e2)
    a = np.stack([e1, e2, n], axis=-1)  # (T, 3, 3) columns
    det = np.linalg.det(a)
    ok = np.abs(det) > 1e-30
    a_safe = np.where(ok[:, None, None], a, np.eye(3, dtype=np.float32))
    inv = np.linalg.inv(a_safe).astype(np.float32)
    trans = -np.einsum("tij,tj->ti", inv, v0).astype(np.float32)
    woop = np.concatenate([inv, trans[:, :, None]], axis=-1)  # (T, 3, 4)
    # Degenerate sentinel: zero linear part, -1e30 translation => t = +inf.
    bad = np.zeros((3, 4), dtype=np.float32)
    bad[:, 3] = -1e30
    woop = np.where(ok[:, None, None], woop, bad)
    return woop


CLUSTER_K = 128  # treelet leaf capacity == BVH cluster width (bvh/clustered.py)


def _np_treelet_leaves(v0, e1, e2, k=CLUSTER_K):
    """Recursive binned-SAH split of triangle centroids into leaves of
    <= k triangles.  Returns a list of index arrays.

    Why not fixed k-runs of the Morton curve (round 1): a run can straddle
    a large spatial jump — the bench scene's 2-triangle ground plane fuses
    into a sphere's cluster, giving that cluster an AABB covering half the
    scene, which every tile's frustum then overlaps.  Spatially-split
    leaves are tight at the same dense-matmul width; the unfilled slots
    carry degenerate sentinel rows (e1 = e2 = 0 => guaranteed-miss Woop,
    anchor v0 inside the leaf box so cluster AABBs stay tight).

    Two refinements over round 2's longest-axis median split, both aimed
    at tested-pairs/ray (the kernel's dominant cost):
    * split COUNTS round to multiples of k: pure halving leaves leaves
      ~76% full on average and sentinel padding is tested like real
      triangles — full leaves cover the same geometry with ~25% fewer
      tested pairs;
    * the split plane minimizes a binned SAH-style cost (sum of child
      AABB half-areas weighted by child counts, 16 bins over each axis)
      instead of blindly halving at the longest-axis median — fewer
      scheduled pairs on the 100k bench scene.
    """
    p1, p2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    cent = (lo + hi) * 0.5
    nbins = 16
    leaves = []
    stack = [np.arange(len(v0), dtype=np.int64)]
    while stack:
        s = stack.pop()
        n = len(s)
        if n <= k:
            leaves.append(s)
            continue
        c = cent[s]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        ext = c_hi - c_lo
        best = None  # (cost, axis, m)
        for ax in range(3):
            if ext[ax] <= 0:
                continue
            order = np.argsort(c[:, ax], kind="stable")
            slo, shi = lo[s][order], hi[s][order]
            # prefix/suffix AABB half-areas in triangle-count order
            pre_lo = np.minimum.accumulate(slo, axis=0)
            pre_hi = np.maximum.accumulate(shi, axis=0)
            suf_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]

            def area(alo, ahi):
                d = np.maximum(ahi - alo, 0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            # candidate left counts: multiples of k (full left leaves)
            ms = np.arange(k, n, k)
            if len(ms) == 0:
                ms = np.array([n // 2])
            a_l = area(pre_lo[ms - 1], pre_hi[ms - 1])
            a_r = area(suf_lo[ms], suf_hi[ms])
            # SAH-ish: children cost ~ area x ceil(count/k) cluster visits
            cost = a_l * np.ceil(ms / k) + a_r * np.ceil((n - ms) / k)
            i = int(np.argmin(cost))
            if best is None or cost[i] < best[0]:
                best = (cost[i], ax, int(ms[i]), order)
        if best is None:  # all centroids identical: arbitrary full split
            m = min(k, n - 1)
            leaves.append(s[:m])
            stack.append(s[m:])
            continue
        _, ax, m, order = best
        stack.append(s[order[m:]])
        stack.append(s[order[:m]])
    return leaves


def _pad(arr: np.ndarray, total: int, fill=0) -> np.ndarray:
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr
    width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width, constant_values=fill)


def build_geometry(meshes: list[Mesh], tri_pad: int = TRI_PAD,
                   mat_rows=None) -> Geometry:
    v0s, e1s, e2s, fns = [], [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mat_ids, mesh_ids, local_ids = [], [], []

    for mesh_idx, mesh in enumerate(meshes):
        if mesh.num_triangles == 0:
            continue
        if mesh.normals is None:
            mesh.calculate_vertex_normals()
        tri = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
        verts = np.asarray(mesh.vertices, np.float32)
        a, b, c = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        fns.append(face_normals(verts, mesh.indices))
        nrm = mesh.normals
        n0s.append(nrm[tri[:, 0]])
        n1s.append(nrm[tri[:, 1]])
        n2s.append(nrm[tri[:, 2]])
        if len(mesh.uvs):
            uvs = np.asarray(mesh.uvs, np.float32)
            uv0s.append(uvs[tri[:, 0]])
            uv1s.append(uvs[tri[:, 1]])
            uv2s.append(uvs[tri[:, 2]])
        else:
            z = np.zeros((len(tri), 3), np.float32)
            uv0s.append(z)
            uv1s.append(z)
            uv2s.append(z)
        mat_ids.append(np.full(len(tri), mesh.material_index, np.int32))
        mesh_ids.append(np.full(len(tri), mesh_idx, np.int32))
        local_ids.append(np.arange(len(tri), dtype=np.int32))

    if not v0s:  # empty scene: one sentinel triangle
        v0s = [np.zeros((1, 3), np.float32)]
        e1s = [np.zeros((1, 3), np.float32)]
        e2s = [np.zeros((1, 3), np.float32)]
        fns = [np.zeros((1, 3), np.float32)]
        n0s = n1s = n2s = [np.zeros((1, 3), np.float32)]
        uv0s = uv1s = uv2s = [np.zeros((1, 3), np.float32)]
        mat_ids = [np.full(1, -1, np.int32)]
        mesh_ids = [np.zeros(1, np.int32)]
        local_ids = [np.zeros(1, np.int32)]
        n_true = 0
    else:
        n_true = sum(len(x) for x in v0s)

    cat = lambda xs: np.concatenate(xs, axis=0)
    v0, e1, e2 = cat(v0s), cat(e1s), cat(e2s)
    fn_arr, n0_arr, n1_arr, n2_arr = cat(fns), cat(n0s), cat(n1s), cat(n2s)
    uv0_arr, uv1_arr, uv2_arr = cat(uv0s), cat(uv1s), cat(uv2s)
    mat_arr, mesh_arr, local_arr = cat(mat_ids), cat(mesh_ids), cat(local_ids)

    if n_true > 0:
        # Store triangles in treelet order: spatially tight leaves of
        # <= CLUSTER_K, each padded IN PLACE to exactly CLUSTER_K slots so
        # the BVH's fixed-width clusters align with leaf boundaries and
        # slot == device triangle id holds (no per-frame remap gather).
        leaves = _np_treelet_leaves(v0, e1, e2)
        n_slots = len(leaves) * CLUSTER_K
        slot_src = np.full(n_slots, -1, np.int64)
        anchor = np.zeros(n_slots, np.int64)
        out = 0
        for leaf in leaves:
            slot_src[out : out + len(leaf)] = leaf
            anchor[out : out + CLUSTER_K] = leaf[0]
            out += CLUSTER_K
        pad_mask = slot_src < 0
        take = np.where(pad_mask, anchor, slot_src)

        def grab(x, pad_value=0):
            y = x[take].copy()
            y[pad_mask] = pad_value
            return y

        # v0 pads to the leaf's anchor vertex: with e1 = e2 = 0 the slot is
        # a guaranteed-miss point INSIDE the leaf's AABB (doesn't bloat it).
        v0 = v0[take]
        e1, e2 = grab(e1), grab(e2)
        fn_arr = grab(fn_arr)
        n0_arr, n1_arr, n2_arr = grab(n0_arr), grab(n1_arr), grab(n2_arr)
        uv0_arr, uv1_arr, uv2_arr = grab(uv0_arr), grab(uv1_arr), grab(uv2_arr)
        mat_arr = grab(mat_arr, pad_value=-1)
        mesh_arr = grab(mesh_arr, pad_value=-1)
        local_arr = grab(local_arr, pad_value=-1)

    woop = _woop_transforms(v0, e1, e2)
    p1, p2 = v0 + e1, v0 + e2
    scene_lo = np.minimum(np.minimum(v0, p1), p2).min(axis=0).astype(np.float32)
    scene_hi = np.maximum(np.maximum(v0, p1), p2).max(axis=0).astype(np.float32)

    total = max(tri_pad, -(-len(v0) // tri_pad) * tri_pad)
    bad_woop = np.zeros((3, 4), np.float32)
    bad_woop[:, 3] = -1e30
    woop = _pad(woop, total)
    woop[len(v0):] = bad_woop

    pv0 = _pad(v0, total)
    pe1 = _pad(e1, total)
    pe2 = _pad(e2, total)
    pfn = _pad(fn_arr, total)
    pn0, pn1, pn2 = _pad(n0_arr, total), _pad(n1_arr, total), _pad(n2_arr, total)
    puv0, puv1, puv2 = _pad(uv0_arr, total), _pad(uv1_arr, total), _pad(uv2_arr, total)
    pmat = _pad(mat_arr, total, fill=-1)
    pmesh = _pad(mesh_arr, total, fill=-1)
    plocal = _pad(local_arr, total, fill=-1)

    packed = np.zeros((total, 40), np.float32)
    packed[:, 0:3] = pv0
    packed[:, 3:6] = pe1
    packed[:, 6:9] = pe2
    packed[:, 9] = plocal.view(np.float32)
    packed[:, 10] = pmesh.view(np.float32)
    packed[:, 11] = pmat.view(np.float32)
    packed[:, 12:15] = pn0
    packed[:, 15:18] = pn1
    packed[:, 18:21] = pn2
    packed[:, 21:24] = pfn
    packed[:, 24:26] = puv0[:, :2]
    packed[:, 26:28] = puv1[:, :2]
    packed[:, 28:30] = puv2[:, :2]
    if mat_rows is not None:
        # Denormalize the material row per triangle (mat tables are tiny;
        # the per-ray material gather this removes costs a full row-gather
        # pass). Padding/invalid ids use row 0 — misses are masked anyway.
        packed[:, 30:39] = mat_rows[np.maximum(pmat, 0) % len(mat_rows)]

    geo = Geometry(
        v0=_t(pv0),
        e1=_t(pe1),
        e2=_t(pe2),
        woop=_t(woop),
        face_normal=_t(pfn),
        n0=_t(pn0),
        n1=_t(pn1),
        n2=_t(pn2),
        uv0=_t(puv0),
        uv1=_t(puv1),
        uv2=_t(puv2),
        mat_id=_t(pmat),
        mesh_id=_t(pmesh),
        local_id=_t(plocal),
        packed=_t(packed),
        scene_lo=_t(scene_lo),
        scene_hi=_t(scene_hi),
        n_tris=len(v0) if n_true > 0 else 0,
        n_real_tris=n_true,
        morton_sorted=True,
    )
    return geo


def build_material_table(scene: Scene) -> MaterialTable:
    mats = scene.materials or [Material()]
    m = len(mats)
    mtype = np.zeros(m, np.int32)
    albedo = np.zeros((m, 3), np.float32)
    ior = np.ones(m, np.float32)
    smooth = np.zeros(m, bool)
    tex_id = np.full(m, -1, np.int32)
    specular = np.zeros(m, np.float32)
    shininess = np.full(m, 32.0, np.float32)
    tex_index = {t.name: i for i, t in enumerate(scene.textures)}
    for i, mat in enumerate(mats):
        mtype[i] = int(mat.type)
        albedo[i] = mat.albedo
        ior[i] = mat.ior
        smooth[i] = mat.smooth_shading
        specular[i] = getattr(mat, "specular", 0.0)
        shininess[i] = getattr(mat, "shininess", 32.0)
        if mat.is_texture():
            tex_id[i] = tex_index.get(mat.texture_name, -1)
    packed = np.zeros((m, 12), np.float32)
    packed[:, 0] = mtype.astype(np.float32)
    packed[:, 1:4] = albedo
    packed[:, 4] = ior
    packed[:, 5] = smooth.astype(np.float32)
    packed[:, 6] = tex_id.astype(np.float32)
    packed[:, 7] = specular
    packed[:, 8] = shininess
    return MaterialTable(mtype=_t(mtype), albedo=_t(albedo), ior=_t(ior),
                         smooth=_t(smooth), tex_id=_t(tex_id), packed=_t(packed))


def build_texture_table(scene: Scene, base_dir: str = ".") -> TextureTable:
    texs = scene.textures or [Texture()]
    k = len(texs)
    ttype = np.zeros(k, np.int32)
    color_a = np.zeros((k, 3), np.float32)
    color_b = np.zeros((k, 3), np.float32)
    scalar = np.ones(k, np.float32)
    bitmap_id = np.full(k, -1, np.int32)

    images = []
    for i, tex in enumerate(texs):
        ttype[i] = int(tex.type)
        color_a[i] = tex.color_a
        color_b[i] = tex.color_b
        scalar[i] = tex.scalar if tex.scalar else 1.0
        if tex.type == TextureType.BITMAP:
            tex.load(base_dir)
            bitmap_id[i] = len(images)
            images.append(tex.image)

    if images:
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        atlas = np.zeros((len(images), hmax, wmax, 3), np.float32)
        sizes = np.zeros((len(images), 2), np.int32)
        for b, im in enumerate(images):
            h, w, c = im.shape
            rgb = np.zeros((h, w, 3), np.float32)
            rgb[:, :, 0] = im[:, :, 0]
            if c > 1:
                rgb[:, :, 1] = im[:, :, 1]
            if c > 2:
                rgb[:, :, 2] = im[:, :, 2]
            atlas[b, :h, :w] = rgb / 255.0
            sizes[b] = (h, w)
    else:
        atlas = np.zeros((1, 1, 1, 3), np.float32)
        sizes = np.ones((1, 2), np.int32)

    packed = np.zeros((k, 12), np.float32)
    packed[:, 0] = ttype.astype(np.float32)
    packed[:, 1:4] = color_a
    packed[:, 4:7] = color_b
    packed[:, 7] = scalar
    packed[:, 8] = bitmap_id.astype(np.float32)
    packed[:, 9] = sizes[np.clip(bitmap_id, 0, len(sizes) - 1), 0].astype(np.float32)
    packed[:, 10] = sizes[np.clip(bitmap_id, 0, len(sizes) - 1), 1].astype(np.float32)
    return TextureTable(
        ttype=_t(ttype), color_a=_t(color_a), color_b=_t(color_b),
        scalar=_t(scalar), bitmap_id=_t(bitmap_id), atlas=_t(atlas),
        atlas_size=_t(sizes), packed=_t(packed),
    )


def build_light_table(scene: Scene) -> LightTable:
    lights = scene.lights
    n = len(lights)
    pos = np.zeros((max(n, 1), 3), np.float32)
    inten = np.zeros(max(n, 1), np.float32)
    for i, l in enumerate(lights):
        pos[i] = l.position
        inten[i] = l.intensity
    return LightTable(position=_t(pos), intensity=_t(inten), n_lights=n)


def build_device_scene(scene: Scene, device="cpu", base_dir: str = ".",
                       tri_pad: int = TRI_PAD) -> DeviceScene:
    """Flatten a host Scene into device tensors — the analog of the one-time
    geometry upload at DXRTRenderer.cpp:302-453.  The buffers are built on
    the host with numpy and copied to ``device`` once."""
    materials = build_material_table(scene)
    dscene = DeviceScene(
        geometry=build_geometry(scene.meshes, tri_pad,
                                mat_rows=materials.packed.numpy()[:, :9]),
        materials=materials,
        textures=build_texture_table(scene, base_dir),
        lights=build_light_table(scene),
        background_color=_t(np.asarray(scene.settings.background_color,
                                       np.float32)),
        has_specular=any(
            getattr(m, "specular", 0.0) > 0.0 for m in scene.materials
        ),
        has_textures=bool(scene.textures),
        has_refractive=any(
            m.type == MaterialType.REFRACTIVE for m in scene.materials
        ),
    )
    return dscene.to(device)


_SUBTABLES = {"geometry": Geometry, "materials": MaterialTable,
              "textures": TextureTable, "lights": LightTable}


def scene_from_numpy(fields: dict, device="cpu") -> DeviceScene:
    """A DeviceScene from the JAX package's DeviceScene leaves.

    ``fields`` maps the JAX field paths (``"geometry.v0"``,
    ``"materials.packed"``, ``"lights.n_lights"``, ``"background_color"``,
    ``"has_specular"``, ...) to numpy arrays or Python scalars.  Arrays keep
    their dtype and bits; scalar fields (counts, flags) become Python
    ints/bools.  Keys the port has no field for (the JAX-only
    ``geometry.accel``) are not read.
    """
    def value(key, f):
        x = fields[key]
        if f.type == "int":
            return int(x)
        if f.type == "bool":
            return bool(x)
        return _t(np.array(x))  # a writable copy of the handed-over buffer

    parts = {}
    for name, cls in _SUBTABLES.items():
        parts[name] = cls(**{f.name: value(f"{name}.{f.name}", f)
                             for f in dataclasses.fields(cls)})
    flags = {f.name: value(f.name, f) for f in dataclasses.fields(DeviceScene)
             if f.name not in _SUBTABLES}
    return DeviceScene(**parts, **flags).to(device)
