"""Batched ray-triangle intersection: the oracles every kernel is held to.

Counterpart of ``directx_raytracer_tpu/ops/intersect.py`` (``Hit``,
``intersect_block``, ``intersect_bruteforce``, ``hit_record``,
``refine_hit``), as plain torch with the same float-op order.

Each triangle carries a precomputed Woop unit-triangle transform
(models/scene.py), so testing R rays against T triangles is two dense f32
matmuls —

    o' = [O | 1] @ W^T      (R, 4) @ (4, 3T)
    d' =  D      @ Wl^T     (R, 3) @ (3, 3T)

followed by elementwise work: t = -o'_z / d'_z, u = o'_x + t d'_x,
v = o'_y + t d'_y, and a masked running min over triangle blocks.  The
barycentric convention matches DXR's BuiltInTriangleIntersectionAttributes:
(u, v) weight vertices 1 and 2; the hit point is v0 + u e1 + v e2.

The matmuls run in full f32: TF32 keeps 10 mantissa bits, the error class
that loses sliver-edge hits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .rays import T_MAX, T_MIN

INF = float("inf")


def full_f32_matmuls() -> None:
    """Turn TF32 off for matmuls and convolutions on the card; the oracles
    and the plain kernel versions call this before any matmul."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class Hit:
    """SoA hit record for a batch of rays. tri == -1 means miss."""

    t: torch.Tensor  # (N,) f32 — hit distance (inf on miss)
    tri: torch.Tensor  # (N,) i32 — global triangle index, -1 on miss
    u: torch.Tensor  # (N,) f32 — barycentric weight of vertex 1
    v: torch.Tensor  # (N,) f32 — barycentric weight of vertex 2

    @property
    def mask(self) -> torch.Tensor:
        return self.tri >= 0


def intersect_block(origins, dirs, woop, t_min=T_MIN, t_max=T_MAX):
    """Dense R x T intersection via the Woop matmul formulation.

    Args:
      origins, dirs: (R, 3) f32.
      woop: (T, 3, 4) f32.
    Returns:
      (t, u, v, valid): each (R, T); t is inf where invalid.
    """
    full_f32_matmuls()
    r = origins.shape[0]
    t = woop.shape[0]
    w4 = woop.reshape(t * 3, 4).T  # (4, 3T), triangle-major columns
    o4 = torch.cat([origins, origins.new_ones((r, 1))], dim=1)
    op = (o4 @ w4).reshape(r, t, 3)
    dp = (dirs @ w4[:3]).reshape(r, t, 3)

    tt = -op[..., 2] / dp[..., 2]
    u = op[..., 0] + tt * dp[..., 0]
    v = op[..., 1] + tt * dp[..., 1]
    valid = (tt > t_min) & (tt < t_max) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(valid, tt, INF), u, v, valid


def _pad_woop(woop, tri_block: int):
    """Pad the triangle axis to a multiple of ``tri_block`` with guaranteed-
    miss sentinels (zero linear part, -1e30 translation => t folds to inf)."""
    rem = (-woop.shape[0]) % tri_block
    if not rem:
        return woop
    bad = woop.new_zeros((rem, 3, 4))
    bad[:, :, 3] = -1e30
    return torch.cat([woop, bad], dim=0)


def intersect_bruteforce(origins, dirs, woop, t_min=T_MIN, t_max=T_MAX,
                         ray_block: int = 16384, tri_block: int = 512) -> Hit:
    """Closest hit of every ray against every triangle.

    Rays go in blocks of ``ray_block`` and triangles in blocks of
    ``tri_block`` with a running min, bounding the (R_blk, 3*T_blk) matmul
    outputs.  Among equal t, the lowest triangle index wins.
    """
    n = origins.shape[0]
    tri_block = min(tri_block, woop.shape[0])
    woop = _pad_woop(woop, tri_block)
    dev = origins.device
    best_t = torch.full((n,), INF, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    for r0 in range(0, n, ray_block):
        o, d = origins[r0:r0 + ray_block], dirs[r0:r0 + ray_block]
        bt, btri = best_t[r0:r0 + ray_block], best_tri[r0:r0 + ray_block]
        bu, bv = best_u[r0:r0 + ray_block], best_v[r0:r0 + ray_block]
        for base in range(0, woop.shape[0], tri_block):
            tt, u, v, _ = intersect_block(o, d, woop[base:base + tri_block],
                                          t_min, t_max)
            blk_t, blk_idx = torch.min(tt, dim=1)
            closer = blk_t < bt
            bt.copy_(torch.where(closer, blk_t, bt))
            btri.copy_(torch.where(closer, (blk_idx + base).to(torch.int32), btri))
            bu.copy_(torch.where(closer, u.gather(1, blk_idx[:, None])[:, 0], bu))
            bv.copy_(torch.where(closer, v.gather(1, blk_idx[:, None])[:, 0], bv))
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def hit_record(origins, dirs, packed, hit: Hit):
    """THE per-hit gather: one fused (N, 40) row -> exact (t, u, v),
    per-triangle ids, and the raw record for attribute slicing.

    Re-evaluates Möller-Trumbore exactly for each ray's winning triangle,
    componentwise on (N,) columns.  The ids are int32 bit patterns in the
    record's f32 slots 9-11, read by a bit view of a contiguous copy — no
    float arithmetic touches them.

    Returns (refined Hit, local_id, mesh_id, mat_id, rec) — ids are 0 for
    misses.
    """
    rec = packed[hit.tri.clamp(min=0).long()]  # (N, 40) — THE gather
    ids = rec[:, 9:12].contiguous().view(torch.int32)
    local_id, mesh_id, mat_id = ids[:, 0], ids[:, 1], ids[:, 2]

    v0x, v0y, v0z = rec[:, 0], rec[:, 1], rec[:, 2]
    e1x, e1y, e1z = rec[:, 3], rec[:, 4], rec[:, 5]
    e2x, e2y, e2z = rec[:, 6], rec[:, 7], rec[:, 8]
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(det != 0, 1.0 / det, 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = hit.mask
    refined = Hit(
        t=torch.where(ok, t, hit.t),
        tri=hit.tri,
        u=torch.where(ok, u, hit.u),
        v=torch.where(ok, v, hit.v),
    )
    zero = torch.zeros((), dtype=torch.int32, device=ok.device)
    return (refined, torch.where(ok, local_id, zero),
            torch.where(ok, mesh_id, zero),
            torch.where(ok, mat_id.clamp(min=0), zero), rec)


def refine_hit(origins, dirs, v0, e1, e2, hit: Hit) -> Hit:
    """Re-evaluate (t, u, v) exactly for each ray's winning triangle with
    one batched Möller-Trumbore evaluation; the hit/miss decision is kept."""
    tri = hit.tri.clamp(min=0).long()
    a, b, c = v0[tri], e1[tri], e2[tri]
    p = torch.linalg.cross(dirs, c)
    det = (b * p).sum(-1)
    inv_det = torch.where(det != 0, 1.0 / det, 0.0)
    s = origins - a
    u = (s * p).sum(-1) * inv_det
    q = torch.linalg.cross(s, b)
    v = (dirs * q).sum(-1) * inv_det
    t = (c * q).sum(-1) * inv_det
    ok = hit.mask
    return Hit(
        t=torch.where(ok, t, hit.t),
        tri=hit.tri,
        u=torch.where(ok, u, hit.u),
        v=torch.where(ok, v, hit.v),
    )
