"""The Whitted frame of single pixels, path by path.

The shading model of the Chaos ray-tracing course that the ``.crtscene``
format comes from, as the program states it:

* a ray that misses adds throughput x the scene's background colour;
* a DIFFUSE hit adds throughput x albedo x the sum over point lights of
  ``intensity / (4 pi r^2) x max(0, n . l)``, each term kept only if the
  shadow ray from ``p + 1e-3 n`` towards the light meets nothing in
  ``(1e-3, r - 2e-3)`` (n: the shading normal, smooth or geometric by the
  material; l and r from the hit point itself);
* a CONSTANT hit adds throughput x albedo;
* a REFLECTIVE hit continues as the mirror ray ``d - 2 (d . n) n`` from
  ``p - sign(d . n_g) n_g 1e-3`` with throughput x albedo, while its peak
  throughput stays above 1e-3;
* on the last of ``max_depth`` passes a specular hit is shaded as DIFFUSE;
* the pixel is the sum of its path's contributions, one ray a pixel at the
  pixel's centre (spp 1).

Refraction is not reproduced: no configuration has a refractive material.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.camera import primary_rays

SHADOW_BIAS = 1e-3
RAY_BIAS = 1e-3
MIN_THROUGHPUT = 1e-3


def _materials(data, dtype, device):
    types = [m["type"] for m in data["materials"]]
    if "refractive" in types:
        raise ValueError("the plain Whitted reference has no refraction")
    albedo = torch.tensor([list(map(float, m["albedo"])) for m in data["materials"]],
                          dtype=dtype, device=device)
    smooth = torch.tensor([bool(m.get("smooth", False)) for m in data["materials"]],
                          device=device)
    kind = {name: torch.tensor([t == name for t in types], device=device)
            for name in ("diffuse", "reflective", "constant")}
    return albedo, smooth, kind


def direct_light(tris, data, p, n):
    """(N,) unoccluded sum of the point lights' irradiance x cosine."""
    total = torch.zeros_like(p[:, 0])
    for light in data["lights"]:
        lp = torch.as_tensor(light["position"], device=p.device).to(p.dtype)
        to = lp - p
        dist = torch.linalg.vector_norm(to, dim=1)
        ldir = to / dist.clamp(min=1e-12)[:, None]
        cos = (n * ldir).sum(1).clamp(min=0.0)
        term = float(light["intensity"]) / (4.0 * math.pi * dist.clamp(min=1e-12) ** 2) * cos
        lit = cos > 0
        blocked = torch.zeros_like(lit)
        if lit.any():
            idx = lit.nonzero()[:, 0]
            so = p[idx] + n[idx] * SHADOW_BIAS
            blocked[idx] = tris.occluded(so, ldir[idx], dist[idx] - 2.0 * SHADOW_BIAS)
        total = total + torch.where(blocked, torch.zeros_like(term), term)
    return total


def render_pixels(tris, data: dict, pose, px, py, args: dict):
    """(N, 3) linear colours of pixels (px, py) at ``pose``."""
    max_depth = int(args["max_depth"])
    dt, dev = tris.dtype, px.device
    albedo_of, smooth_of, kind = _materials(data, dt, dev)
    background = torch.as_tensor(data["background"], device=dev).to(dt)
    o, d = primary_rays(pose, data["width"], data["height"], px, py, dt)
    pixel = torch.arange(px.shape[0], device=dev)
    thpt = torch.ones((px.shape[0], 3), dtype=dt, device=dev)
    color = torch.zeros((px.shape[0], 3), dtype=dt, device=dev)
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
        reflective = kind["reflective"][mat]
        diffuse = kind["diffuse"][mat] | (reflective if last else torch.zeros_like(reflective))
        if diffuse.any():
            i = diffuse.nonzero()[:, 0]
            light = direct_light(tris, data, p[i], n[i])
            color.index_add_(0, pixel[i], thpt[i] * albedo[i] * light[:, None])
        const = kind["constant"][mat]
        color.index_add_(0, pixel[const], thpt[const] * albedo[const])
        if last:
            break
        side = torch.sign((d * ng).sum(1, keepdim=True))
        o = p - side * ng * RAY_BIAS
        d = d - 2.0 * (d * n).sum(1, keepdim=True) * n
        thpt = thpt * albedo
        go = reflective & (thpt.amax(dim=1) > MIN_THROUGHPUT)
        o, d, thpt, pixel = o[go], d[go], thpt[go], pixel[go]
    return color
