"""Material evaluation: texture sampling, direct lighting, reflection and
refraction.

Counterpart of ``directx_raytracer_tpu/ops/shading.py`` (``FOUR_PI``,
``SHADOW_BIAS``, ``RAY_BIAS``, ``sample_textures``, ``hit_attributes``,
``_morton_key_points``, ``direct_lighting``, ``reflect``,
``refract_fresnel``), as plain torch with the same float-op order, on the
device of the tensors it is given.  The shadow batch's sort keys and rays
(``shadow_keys``, ``shadow_rays``) are one launch each of
``csrc/shadow_batch.cu`` on the card, where XLA fuses their chains under
``jit`` and eager torch would launch every op; their plain versions
(``shadow_keys_plain``, ``shadow_rays_plain``) run on the CPU.

This is the Whitted feature set the reference *declares* (parsed
materials/lights/textures, CRTSceneParser.cpp:152-405) but never uploads to
the GPU or executes (SURVEY.md fact 2).  Semantics follow the Chaos Ray
Tracing course model the `.crtscene` format comes from:

* point light contribution = ``intensity / (4 pi r^2) * max(0, n . l)``,
  attenuated to zero by an any-hit shadow ray;
* DIFFUSE  — albedo * sum(light contributions);
* CONSTANT — flat albedo (no lights, no bounce);
* REFLECTIVE — perfect mirror, throughput *= albedo;
* REFRACTIVE — Fresnel-weighted (Schlick) reflection + refraction with total
  internal reflection, albedo forced to (1,1,1) by the parser
  (CRTSceneParser.cpp:360-370);
* textures by type per CRTTexture* formulas (see models/texture.py): EDGES
  samples *barycentric* (u, v); CHECKER / BITMAP sample interpolated mesh UVs.

Everything is batched over ray arrays; per-material dispatch is vectorized
selects, not branches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import check_tensor, launch
from ..models.material import MaterialType
from ..models.scene import DeviceScene, TextureTable
from ..models.texture import TextureType
from ..utils.trace import span
from ..utils.vecmath import normalize

FOUR_PI = 4.0 * np.pi
SHADOW_BIAS = 1e-3
RAY_BIAS = 1e-3


def sample_textures(tex: TextureTable, tex_id, uv, bary_uv):
    """Batched texture lookup.

    Args:
      tex: texture table.
      tex_id: (N,) i32 — texture index per ray (>= 0).
      uv: (N, 2) f32 — interpolated mesh UVs (checker / bitmap).
      bary_uv: (N, 2) f32 — barycentric (u, v) (edges).
    Returns (N, 3) f32 colors.
    """
    rec = tex.packed[tex_id.clamp(min=0).long()]  # one wide row gather
    ttype = rec[:, 0].to(torch.int32)
    color_a = rec[:, 1:4]
    color_b = rec[:, 4:7]
    scalar = rec[:, 7]

    # EDGES (CRTTextureEdges.cpp:9-15) — barycentric space.
    bu, bv = bary_uv[:, 0], bary_uv[:, 1]
    is_edge = (bu < scalar) | (bv < scalar) | (1.0 - bu - bv < scalar)
    edges_color = torch.where(is_edge[:, None], color_a, color_b)

    # CHECKER (CRTTextureChecker.cpp:9-20) — width truncated toward zero;
    # the parity is a floor modulo, as Python's (and jnp's) %.
    width = (1.0 / scalar).to(torch.int32).to(torch.float32)
    u2 = torch.floor(uv[:, 0] * width).to(torch.int32)
    v2 = torch.floor(uv[:, 1] * width).to(torch.int32)
    even = torch.remainder(u2 + v2, 2) == 0
    checker_color = torch.where(even[:, None], color_a, color_b)

    # BITMAP (CRTTextureBitmap.cpp:13-36) — clamp, v-flip, nearest.  The
    # indices are clamped into the atlas as a JAX gather clamps them: torch
    # raises (CPU) or faults (CUDA) on an index out of range, which a
    # non-finite uv of a lane that is masked later would give.
    _, a_h, a_w, _ = tex.atlas.shape
    bid = rec[:, 8].to(torch.int32).clamp(0, tex.atlas.shape[0] - 1)
    h = rec[:, 9]
    w = rec[:, 10]
    cu = uv[:, 0].clamp(0.0, 1.0)
    cv = uv[:, 1].clamp(0.0, 1.0)
    row = ((1.0 - cv) * (h - 1.0)).to(torch.int32).clamp(0, a_h - 1)
    col = (cu * (w - 1.0)).to(torch.int32).clamp(0, a_w - 1)
    bitmap_color = tex.atlas[bid.long(), row.long(), col.long()]

    out = color_a  # ALBEDO (CRTTextureAlbedo.cpp:8-11)
    out = torch.where((ttype == TextureType.EDGES)[:, None], edges_color, out)
    out = torch.where((ttype == TextureType.CHECKER)[:, None], checker_color, out)
    out = torch.where((ttype == TextureType.BITMAP)[:, None], bitmap_color, out)
    return out


def hit_attributes(dscene: DeviceScene, origins, dirs, hit, rec):
    """Per-ray surface attributes for shading, sliced from the fused record
    already gathered by ops.intersect.hit_record (the texture table lookup
    is the only further gather, skipped for texture-free scenes).

    Args:
      rec: (N, 40) fused rows from hit_record (Geometry.packed layout).

    Returns dict with point, normal (smooth/flat per material), geometric
    normal, albedo (texture-resolved), and material fields.
    """
    u = hit.u[:, None]
    v = hit.v[:, None]
    w = 1.0 - u - v

    n_geom = rec[:, 21:24]
    uv0, uv1, uv2 = rec[:, 24:26], rec[:, 26:28], rec[:, 28:30]

    point = origins + dirs * hit.t[:, None]
    uw, vw, ww = hit.u, hit.v, 1.0 - hit.u - hit.v
    nsx = ww * rec[:, 12] + uw * rec[:, 15] + vw * rec[:, 18]
    nsy = ww * rec[:, 13] + uw * rec[:, 16] + vw * rec[:, 19]
    nsz = ww * rec[:, 14] + uw * rec[:, 17] + vw * rec[:, 20]
    nlen = torch.sqrt(nsx * nsx + nsy * nsy + nsz * nsz).clamp(min=1e-12)
    n_smooth = torch.stack([nsx / nlen, nsy / nlen, nsz / nlen], dim=-1)

    mtype = rec[:, 30].to(torch.int32)
    albedo = rec[:, 31:34]
    ior = rec[:, 34]
    smooth = rec[:, 35] > 0.5
    tex_id = rec[:, 36].to(torch.int32)
    specular = rec[:, 37]
    shininess = rec[:, 38]
    normal = torch.where(smooth[:, None], n_smooth, n_geom)

    if dscene.has_textures:  # texture-free scenes skip the gather
        uv = w * uv0 + u * uv1 + v * uv2
        bary_uv = torch.stack([hit.u, hit.v], dim=1)
        tex_color = sample_textures(dscene.textures, tex_id, uv, bary_uv)
        albedo = torch.where((tex_id >= 0)[:, None], tex_color, albedo)

    return {
        "point": point,
        "normal": normal,
        "n_geom": n_geom,
        "albedo": albedo,
        "mtype": mtype,
        "ior": ior,
        "specular": specular,
        "shininess": shininess,
    }


def _morton_key_points(p, lo, hi, armed):
    """30-bit Morton cell of each point (int32); disarmed rays sort last."""
    ext = (hi - lo).clamp(min=1e-12)
    cell = ((p - lo) / ext * 1024.0).clamp(0.0, 1023.0).to(torch.int32)
    key = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    for bit in range(10):
        for ax in range(3):
            key = key | (((cell[:, ax] >> bit) & 1) << (3 * bit + ax))
    return torch.where(armed, key, 2**31 - 1)


# ---------------------------------------------------------------------------
# The shadow batch: its sort keys and its rays
# ---------------------------------------------------------------------------


def shadow_keys_plain(points, normals, mask, lo, hi):
    """The shadow sort's keys as torch chains: (N,) i32 30-bit Morton key
    of each point in the box (lo, hi), 2**31 - 1 for a disarmed point, and
    (N,) f32 armed (1 or 0): ``mask`` (all when None) where the point and
    its normal are finite."""
    armed = (mask if mask is not None
             else torch.ones((points.shape[0],), dtype=torch.bool,
                             device=points.device))
    armed = (armed & torch.isfinite(points).all(dim=-1)
             & torch.isfinite(normals).all(dim=-1))
    return _morton_key_points(points, lo, hi, armed), armed.to(torch.float32)


def shadow_rays_plain(points, normals, mask, lxd, lyd, lzd, dist, cos,
                      park_masked):
    """The occluder's light-major batch as torch chains, from the (L, N)
    unit light directions ``lxd``, ``lyd``, ``lzd``, distances ``dist`` and
    clamped cosines ``cos`` of the N points: origins (L*N, 3), dirs
    (L*N, 3) and t_max (L*N,).  ``park_masked``: the batch is Morton-sorted,
    so masked-out rays are parked too."""
    n_l, n = lxd.shape
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    sox = px + normals[:, 0] * SHADOW_BIAS  # (N,) each
    soy = py + normals[:, 1] * SHADOW_BIAS
    soz = pz + normals[:, 2] * SHADOW_BIAS
    # Parked/degenerate wavefront slots carry non-finite points; give them a
    # strictly-positive far ray so their tiles bin to nothing.  Masked-but-
    # live rays keep their true geometry — replacing it would blow up the
    # conservative box of any tile mixing masked and unmasked rays — and
    # are disarmed via t_max = 0 instead.
    finite = torch.isfinite(sox) & torch.isfinite(soy) & torch.isfinite(soz)
    live = finite
    if park_masked and mask is not None:
        # Sorted mode: disarmed rays are segregated to the tail, so parking
        # them cannot blow up an armed tile's box.
        live = finite & mask
    sox = torch.where(live, sox, 1e30)
    soy = torch.where(live, soy, 1e30)
    soz = torch.where(live, soz, 1e30)
    ok_l = (live[None, :] & torch.isfinite(lxd) & torch.isfinite(lyd)
            & torch.isfinite(lzd))
    # A back-facing lane's diffuse and specular terms are zero whatever the
    # occlusion, so disarming it (t_max = 0) is exact and costs the kernel
    # nothing.
    t_shadow = torch.where(cos > 0.0, dist - 2.0 * SHADOW_BIAS, 0.0)
    if mask is not None:
        t_shadow = torch.where((mask & finite)[None, :], t_shadow, 0.0)
    origins = torch.stack([sox.expand(n_l, n), soy.expand(n_l, n),
                           soz.expand(n_l, n)], dim=-1)
    dirs = torch.stack([torch.where(ok_l, lxd, 1.0),
                        torch.where(ok_l, lyd, 1.0),
                        torch.where(ok_l, lzd, 1.0)], dim=-1)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3), t_shadow.reshape(-1)


def _check_surface(points, normals, mask) -> None:
    """The kernels' surface operands: points and normals (n, 3) f32 rows
    of 3 adjacent floats at a row stride of at least 3 (the sorted
    gather's packed columns, or contiguous tensors), mask None or (n,)
    bool."""
    n, device = points.shape[0], points.device
    for name, x in (("points", points), ("normals", normals)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {x.dtype}, expected torch.float32")
        if x.device != device or tuple(x.shape) != (n, 3):
            raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                             f"expected {(n, 3)} on {device}")
        if x.stride(1) != 1 or x.stride(0) < 3:
            raise ValueError(f"{name}: strides {x.stride()}, expected rows "
                             f"of 3 adjacent floats")
    if mask is not None:
        check_tensor("mask", mask, torch.bool, (n,), device)


def shadow_keys(points, normals, mask, lo, hi):
    """``shadow_keys_plain``'s (key, armed): for CUDA tensors one launch of
    ``csrc/shadow_batch.cu``'s key kernel, counted as
    ``launch.shadow_keys``; for CPU tensors the plain chains."""
    if points.device.type == "cpu":
        return shadow_keys_plain(points, normals, mask, lo, hi)
    n, device = points.shape[0], points.device
    _check_surface(points, normals, mask)
    check_tensor("lo", lo, torch.float32, (3,), device)
    check_tensor("hi", hi, torch.float32, (3,), device)
    key = torch.empty((n,), dtype=torch.int32, device=device)
    armed = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return key, armed
    launch("shadow_keys", "dxrt_shadow_keys", device, points.data_ptr(),
           points.stride(0), normals.data_ptr(), normals.stride(0),
           None if mask is None else mask.data_ptr(), lo.data_ptr(),
           hi.data_ptr(), n, key.data_ptr(), armed.data_ptr())
    return key, armed


def shadow_rays(points, normals, mask, lxd, lyd, lzd, dist, cos,
                park_masked):
    """``shadow_rays_plain``'s (origins, dirs, t_max): for CUDA tensors one
    launch of ``csrc/shadow_batch.cu``'s ray kernel, counted as
    ``launch.shadow_rays``; for CPU tensors the plain chains."""
    if points.device.type == "cpu":
        return shadow_rays_plain(points, normals, mask, lxd, lyd, lzd, dist,
                                 cos, park_masked)
    n, n_l, device = points.shape[0], lxd.shape[0], points.device
    _check_surface(points, normals, mask)
    for name, x in (("lxd", lxd), ("lyd", lyd), ("lzd", lzd), ("dist", dist),
                    ("cos", cos)):
        check_tensor(name, x, torch.float32, (n_l, n), device)
    origins = torch.empty((n_l * n, 3), dtype=torch.float32, device=device)
    dirs = torch.empty((n_l * n, 3), dtype=torch.float32, device=device)
    t_max = torch.empty((n_l * n,), dtype=torch.float32, device=device)
    if n_l * n == 0:
        return origins, dirs, t_max
    launch("shadow_rays", "dxrt_shadow_rays", device, points.data_ptr(),
           points.stride(0), normals.data_ptr(), normals.stride(0),
           None if mask is None else mask.data_ptr(), lxd.data_ptr(),
           lyd.data_ptr(), lzd.data_ptr(), dist.data_ptr(), cos.data_ptr(),
           n_l, n, int(park_masked), SHADOW_BIAS, 2.0 * SHADOW_BIAS,
           origins.data_ptr(), dirs.data_ptr(), t_max.data_ptr())
    return origins, dirs, t_max


def direct_lighting(points, normals, lights, occluder_fn, mask=None,
                    view=None, shininess=None, sort_bounds=None):
    """Lambert-weighted point-light sum with shadow rays (+ optional
    Blinn-Phong specular, BASELINE.json config 3).

    All L lights' shadow rays go to the occluder as ONE (L*N,) batch,
    light-major: each occluder call pays fixed binning costs and a host
    sync, and every tile's rays still aim at a single light.

    Args:
      points, normals: (N, 3).
      lights: LightTable.
      occluder_fn: (origins, dirs, max_t) -> (M,) bool any-hit test, or None
        to disable shadows.
      mask: optional (N,) bool — rays that actually need shadows; the rest
        are disarmed (t_max = 0).
      view: optional (N, 3) incident ray directions (pointing AT the
        surface).  When given, also returns the Blinn-Phong specular sum
        ``Σ_l intensity/(4πr²) · max(0, n·h)^shininess`` with
        h = normalize(l - view), shadow-gated like the diffuse term.
      shininess: (N,) f32 Blinn-Phong exponent (required with ``view``).
      sort_bounds: optional (scene_lo, scene_hi).  When given, the shadow
        work is done in Morton-sorted surface-point order (a stable sort of
        the 30-bit keys, undone by a scatter at the end): shadow tiles then
        hold spatially tight groups of armed rays (pixel-order tiles mix
        fore- and background points at silhouettes and bin many more
        clusters), and disarmed rays, sorted last and parked (origin 1e30,
        direction 1), fill tiles that bin nothing.

    The shadow batch's sort (its keys: ``shadow_keys``), its rays
    (``shadow_rays``) and the occluder call, and the unsort are
    ``dxrt.occluder`` spans; the lighting between them is the caller's
    (``dxrt.shade``).

    Returns (N, 1) un-albedo'd irradiance factor, or a tuple
    ((N, 1) diffuse, (N, 1) specular) when ``view`` is given.
    """
    n = points.shape[0]
    n_lights = lights.n_lights
    if n_lights == 0:
        zero = points.new_zeros((n, 1))
        return (zero, zero) if view is not None else zero
    n_l = min(n_lights, lights.position.shape[0])
    lpos = lights.position[:n_l]  # (L, 3)
    linten = lights.intensity[:n_l]  # (L,)

    unsort = None
    if sort_bounds is not None and occluder_fn is not None:
        with span("dxrt.occluder"):
            key, armed = shadow_keys(points, normals, mask, *sort_bounds)
            perm = torch.sort(key, stable=True).indices
            cols = [points, normals, armed[:, None]]
            if view is not None:
                cols += [view, shininess[:, None]]
            packed = torch.cat(cols, dim=1)[perm]  # one wide gather
            points, normals = packed[:, 0:3], packed[:, 3:6]
            mask = packed[:, 6] > 0.5
            if view is not None:
                view, shininess = packed[:, 7:10], packed[:, 10]
            unsort = perm

    # Componentwise (L, N) math throughout.
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    nxc, nyc, nzc = normals[:, 0], normals[:, 1], normals[:, 2]
    tx = lpos[:, 0:1] - px[None, :]  # (L, N)
    ty = lpos[:, 1:2] - py[None, :]
    tz = lpos[:, 2:3] - pz[None, :]
    d2 = tx * tx + ty * ty + tz * tz
    dist = torch.sqrt(d2)  # (L, N)
    inv_d = 1.0 / dist.clamp(min=1e-12)
    lxd, lyd, lzd = tx * inv_d, ty * inv_d, tz * inv_d
    cos = (nxc[None, :] * lxd + nyc[None, :] * lyd
           + nzc[None, :] * lzd).clamp(min=0.0)
    irrad = linten[:, None] / (FOUR_PI * dist.clamp(min=1e-12) ** 2)  # (L, N)
    contrib = irrad * cos
    spec = None
    if view is not None:
        # half = normalize(ldir - view); n.h == n.(ldir - view) / |ldir - view|
        hx = lxd - view[None, :, 0]
        hy = lyd - view[None, :, 1]
        hz = lzd - view[None, :, 2]
        hinv = 1.0 / torch.sqrt(hx * hx + hy * hy + hz * hz).clamp(min=1e-12)
        ndoth = ((nxc[None, :] * hx + nyc[None, :] * hy + nzc[None, :] * hz)
                 * hinv).clamp(min=0.0)
        # Gate on the diffuse cosine so back-facing lights never highlight.
        spec = irrad * torch.where(cos > 0.0, ndoth ** shininess[None, :], 0.0)

    if occluder_fn is not None:
        with span("dxrt.occluder"):
            origins, dirs_occ, t_shadow = shadow_rays(
                points, normals, mask, lxd, lyd, lzd, dist, cos,
                park_masked=unsort is not None)
            blocked = occluder_fn(origins, dirs_occ,
                                  t_shadow).reshape(n_l, n)
            contrib = torch.where(blocked, 0.0, contrib)
            if spec is not None:
                spec = torch.where(blocked, 0.0, spec)
    if mask is not None:
        contrib = torch.where(mask[None, :], contrib, 0.0)
        if spec is not None:
            spec = torch.where(mask[None, :], spec, 0.0)
    diffuse = contrib.sum(dim=0)[:, None]
    spec_sum = None if spec is None else spec.sum(dim=0)[:, None]
    if unsort is not None:  # scatter sorted results back to ray order
        with span("dxrt.occluder"):
            diffuse = torch.zeros_like(diffuse).index_copy_(0, unsort,
                                                            diffuse)
            if spec_sum is not None:
                spec_sum = torch.zeros_like(spec_sum).index_copy_(
                    0, unsort, spec_sum)
    if spec_sum is None:
        return diffuse
    return diffuse, spec_sum


def reflect(d, n):
    """Mirror direction: d - 2 (d.n) n."""
    return d - 2.0 * (d * n).sum(dim=-1, keepdim=True) * n


def refract_fresnel(d, n, ior):
    """Dielectric interaction for unit incident d, outward surface normal n.

    Handles rays entering (d.n < 0) and exiting (d.n > 0) the medium, total
    internal reflection, and Schlick's Fresnel approximation.

    Returns (refr_dir (N,3), refl_dir (N,3), fresnel_r (N,), tir (N,)):
      fresnel_r is the reflection weight; refraction weight = 1 - fresnel_r
      (forced to 1 on TIR).
    """
    cos_i = (d * n).sum(dim=-1)  # negative when entering
    entering = cos_i < 0.0
    n_oriented = torch.where(entering[:, None], n, -n)
    cos_i = cos_i.abs()
    eta = torch.where(entering, 1.0 / ior, ior)  # n1/n2

    sin2_t = eta * eta * (1.0 - cos_i * cos_i).clamp(min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt((1.0 - sin2_t).clamp(min=0.0))

    refr = eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n_oriented
    refr = normalize(refr, eps=1e-12)
    refl = reflect(d, n_oriented)

    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    # Use the grazing-side cosine (cos_i when entering denser, else cos_t).
    cos_x = torch.where(eta < 1.0, cos_i, cos_t)
    fres = r0 + (1.0 - r0) * (1.0 - cos_x) ** 5
    fres = torch.where(tir, 1.0, fres)
    return refr, refl, fres, tir
