"""The supersampled Whitted frame of single pixels, with refraction.

The shading model of ``whitted.py`` (misses, DIFFUSE direct lighting with
its shadow rays, CONSTANT, REFLECTIVE mirrors, specular hits shaded as
DIFFUSE on the last of ``max_depth`` passes), as the program states it,
and a REFRACTIVE surface as the program's ``refract_fresnel`` states it:

* the shading normal n (smooth or geometric by the material) is oriented
  against the ray: entering when ``d . n < 0``, and then n, else -n;
* eta = 1 / ior entering, ior leaving; ``sin^2 t = eta^2 (1 - cos_i^2)``,
  and total internal reflection (TIR) when ``sin^2 t > 1``;
* the transmitted direction is Snell's, ``eta d + (eta cos_i - cos_t) n``,
  normalised;
* Schlick's weight ``F = r0 + (1 - r0) (1 - cos_x)^5``, ``r0 = ((eta - 1) /
  (eta + 1))^2``, on the grazing side's cosine: cos_i entering the denser
  medium (eta < 1), cos_t leaving it; F = 1 under TIR;
* the transmission continues with throughput x (1 - F), unless TIR, from
  ``p + sign(d . n_g) n_g 1e-3`` (the side of the geometric normal n_g it
  travels to); the reflection ``d - 2 (d . n) n`` continues with
  throughput x F (x 1 under TIR) from ``p - sign(d . n_g) n_g 1e-3``;
* each continuation (mirror, transmission, reflection) is kept only while
  its peak throughput channel is above 1e-3;
* shadow rays test every triangle: glass is opaque to them;
* a pixel is the mean of its samples at the rotated-grid sub-pixel offsets
  ``RGSS`` (spp 4; spp 1 is the pixel's centre), each sample starting with
  throughput 1 / spp (the program's framebuffer weight, which the kill
  threshold sees).

Where it departs from a recursive tracer, as the program does:

* depth counts passes, not bounces of one path: a hit on pass
  ``max_depth - 1`` of a mirror or glass surface is shaded as DIFFUSE
  (direct lighting, albedo (1, 1, 1) for glass) and not followed, where a
  recursive tracer would return black or keep going;
* a glass hit spawns both branches on the same pass, so one pixel's rays
  double at each glass surface and every branch ends at the same depth;
* the kill threshold applies to the sample's weighted throughput, so a
  branch below 4e-3 of a pixel at spp 4 ends (a recursive tracer that
  kills on the unweighted one keeps it);
* glass attenuates nothing (Beer's law is absent) and casts full shadows;
* the light sum runs in ``whitted.direct_light``'s order.

Departures from the program, each on purpose: the arithmetic is float64
(float32 with TF32 products in the control), the closest hit and the
shadow rays test every triangle (``geometry.py``), vertex normals come
from the scene data, and no queue bounds the rows: the program must drop
none for the two to agree.
"""

from __future__ import annotations

import torch

from benchmark.reference.pathtrace import jittered_rays
from benchmark.reference.whitted import direct_light

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RAY_BIAS = 1e-3
MIN_THROUGHPUT = 1e-3
RGSS = ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875))


def sample_offsets(spp: int):
    """The sub-pixel offsets of ``spp`` samples: the centre, or RGSS."""
    if spp == 1:
        return ((0.5, 0.5),)
    if spp == 4:
        return RGSS
    raise ValueError(f"the reference renders spp 1 or 4, not {spp}")


def _materials(data, dtype, device):
    types = [m["type"] for m in data["materials"]]
    albedo = torch.tensor([list(map(float, m["albedo"])) for m in data["materials"]],
                          dtype=dtype, device=device)
    smooth = torch.tensor([bool(m.get("smooth", False)) for m in data["materials"]],
                          device=device)
    ior = torch.tensor([float(m.get("ior", 1.0)) for m in data["materials"]],
                       dtype=dtype, device=device)
    kind = {name: torch.tensor([t == name for t in types], device=device)
            for name in ("diffuse", "reflective", "refractive", "constant")}
    return albedo, smooth, ior, kind


def reflect(d, n):
    return d - 2.0 * (d * n).sum(1, keepdim=True) * n


def refract_fresnel(d, n, ior):
    """(transmitted direction, reflected direction, F, TIR) of unit rays d
    at surfaces of outward normal n and index ``ior`` (N,)."""
    cos_i = (d * n).sum(1)
    entering = cos_i < 0.0
    n_o = torch.where(entering[:, None], n, -n)
    cos_i = cos_i.abs()
    eta = torch.where(entering, 1.0 / ior, ior)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i).clamp(min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt((1.0 - sin2_t).clamp(min=0.0))
    refr = eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n_o
    refr = refr / torch.linalg.vector_norm(refr, dim=1, keepdim=True).clamp(min=1e-12)
    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    cos_x = torch.where(eta < 1.0, cos_i, cos_t)
    fres = torch.where(tir, torch.ones_like(r0), r0 + (1.0 - r0) * (1.0 - cos_x) ** 5)
    return refr, reflect(d, n_o), fres, tir


def render_pixels(tris, data: dict, pose, px, py, args: dict):
    """(N, 3) linear colours of pixels (px, py) at ``pose``: depth
    ``args["max_depth"]``, ``args.get("spp", 1)`` samples a pixel."""
    max_depth = int(args["max_depth"])
    offsets = sample_offsets(int(args.get("spp", 1)))
    dt, dev = tris.dtype, px.device
    w, h, n_pix = data["width"], data["height"], px.shape[0]
    albedo_of, smooth_of, ior_of, kind = _materials(data, dt, dev)
    background = torch.as_tensor(data["background"], device=dev).to(dt)
    # Every sample of every pixel in one batch: row s * N + i is sample s
    # of pixel i.
    rays = [jittered_rays(pose, w, h, px, py, off, dt) for off in offsets]
    o = torch.cat([r[0] for r in rays])
    d = torch.cat([r[1] for r in rays])
    pixel = torch.arange(n_pix, device=dev).repeat(len(offsets))
    thpt = torch.full((o.shape[0], 3), 1.0 / len(offsets), dtype=dt, device=dev)
    color = torch.zeros((n_pix, 3), dtype=dt, device=dev)
    for depth in range(max_depth):
        if pixel.numel() == 0:
            break
        last = depth == max_depth - 1
        t, tri, u, v = tris.closest(o, d)
        hit = tri >= 0
        miss = ~hit
        color.index_add_(0, pixel[miss], thpt[miss] * background)
        o, d, t, tri, u, v = o[hit], d[hit], t[hit], tri[hit], u[hit], v[hit]
        pixel, thpt = pixel[hit], thpt[hit]
        mat = tris.material[tri]
        p = o + d * t[:, None]
        cn = tris.corner_normals[tri]
        ns = (1.0 - u - v)[:, None] * cn[:, 0] + u[:, None] * cn[:, 1] + v[:, None] * cn[:, 2]
        ns = ns / torch.linalg.vector_norm(ns, dim=1, keepdim=True).clamp(min=1e-12)
        ng = tris.face_normal[tri]
        n = torch.where(smooth_of[mat][:, None], ns, ng)
        albedo = albedo_of[mat]
        mirror, glass = kind["reflective"][mat], kind["refractive"][mat]
        diffuse = kind["diffuse"][mat] | ((mirror | glass) if last
                                          else torch.zeros_like(mirror))
        if diffuse.any():
            i = diffuse.nonzero()[:, 0]
            light = direct_light(tris, data, p[i], n[i])
            color.index_add_(0, pixel[i], thpt[i] * albedo[i] * light[:, None])
        const = kind["constant"][mat]
        color.index_add_(0, pixel[const], thpt[const] * albedo[const])
        if last:
            break
        side = torch.sign((d * ng).sum(1, keepdim=True))
        refr, refl, fres, tir = refract_fresnel(d, n, ior_of[mat])
        out, into = p - side * ng * RAY_BIAS, p + side * ng * RAY_BIAS
        transmit = glass & ~tir
        # The continuations: mirror bounces, transmissions, reflections.
        branches = ((mirror, out, reflect(d, n), thpt * albedo),
                    (transmit, into, refr, thpt * (1.0 - fres)[:, None]),
                    (glass, out, refl, thpt * fres[:, None]))
        go = [m & (th.amax(dim=1) > MIN_THROUGHPUT) for m, _, _, th in branches]
        o = torch.cat([b[1][g] for b, g in zip(branches, go)])
        d = torch.cat([b[2][g] for b, g in zip(branches, go)])
        thpt = torch.cat([b[3][g] for b, g in zip(branches, go)])
        pixel = torch.cat([pixel[g] for g in go])
    return color
