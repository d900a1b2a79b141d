"""Stackless LBVH traversal — the replacement for the hardware ``TraceRay``
intrinsic (HLSL/ray_tracing_shaders.hlsl:57-66), kept as a correctness
oracle for the cluster kernels.

Counterpart of ``directx_raytracer_tpu/bvh/traverse.py``
(``traverse_closest``, ``traverse_occluded``), as plain torch.

Skip-pointer ("rope") walk: per-ray state is just (current node id, best
hit) — no stack arrays.  Internal node hit -> descend to first child; miss
(or leaf, after its Möller-Trumbore test) -> follow the skip pointer.  A
block of rays walks in lockstep under a ``live`` mask: every step gathers
the live lanes' nodes and updates them with ``torch.where``, until no lane
is live (one flag read per step).  Blocks bound that divergence domain.

The box test prunes against the ray's *current best t*, so near-to-far isn't
required for correctness; Morton order gives approximate front-to-back
locality anyway.
"""

from __future__ import annotations

import torch

from ..ops.intersect import Hit
from ..ops.rays import T_MAX, T_MIN
from .lbvh import LBVH, SENTINEL

INF = float("inf")


def _safe_inv(d):
    tiny = 1e-12
    return 1.0 / torch.where(d.abs() < tiny,
                             torch.where(d < 0, -tiny, tiny).to(d.dtype), d)


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _traverse_block(o, d, t_max_ray, bvh: LBVH, t_min, any_hit: bool):
    """Walk the threaded tree for one block of rays in lockstep.  Returns
    (best_t, best_k, best_u, best_v), best_k the winning leaf (-1: none)."""
    n, dev = o.shape[0], o.device
    leaf_base = bvh.leaf_base
    inv_d = _safe_inv(d)

    cur = torch.full((n,), bvh.root, dtype=torch.int32, device=dev)
    best_t = torch.full((n,), INF, device=dev)
    best_k = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    while True:
        live = cur != SENTINEL
        if any_hit:
            live = live & (best_t == INF)
        if not bool(live.any()):
            break
        node = cur.clamp(min=0).long()  # dead lanes read node 0, masked below
        t0 = (bvh.aabb_min[node] - o) * inv_d
        t1 = (bvh.aabb_max[node] - o) * inv_d
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        limit = torch.minimum(best_t, t_max_ray)
        box_hit = (tn <= tf) & (tf >= t_min) & (tn <= limit)

        is_leaf = cur >= leaf_base
        k = (cur - leaf_base).clamp(min=0)
        kl = k.long()
        # Möller-Trumbore on the leaf triangle.
        e1, e2 = bvh.e1[kl], bvh.e2[kl]
        p = _cross(d, e2)
        det = (e1 * p).sum(dim=1)
        inv_det = torch.where(det != 0, 1.0 / det, 0.0)
        s = o - bvh.v0[kl]
        u = (s * p).sum(dim=1) * inv_det
        q = _cross(s, e1)
        v = (d * q).sum(dim=1) * inv_det
        tt = (e2 * q).sum(dim=1) * inv_det
        tri_hit = (live & is_leaf & (det != 0) & (u >= 0) & (v >= 0)
                   & (u + v <= 1) & (tt > t_min) & (tt < limit))

        best_t = torch.where(tri_hit, tt, best_t)
        best_k = torch.where(tri_hit, k, best_k)
        best_u = torch.where(tri_hit, u, best_u)
        best_v = torch.where(tri_hit, v, best_v)

        descend = ~is_leaf & box_hit
        nxt = torch.where(descend, bvh.left[node], bvh.skip[node])
        cur = torch.where(live, nxt, cur)
    return best_t, best_k, best_u, best_v


def _blocks(origins, dirs, t_max, block: int):
    """Ray blocks of at most ``block`` rays, as (origins, dirs, t_max); the
    last may be shorter, so no padding rays are needed."""
    return zip(origins.split(block), dirs.split(block), t_max.split(block))


def traverse_closest(origins, dirs, bvh: LBVH, t_max=None, t_min=T_MIN,
                     block: int = 65536) -> Hit:
    """Closest hit of each ray via the threaded LBVH.

    Returns a Hit whose ``tri`` holds ORIGINAL triangle ids (mapped back
    through the Morton sort), matching ``intersect_bruteforce``.
    """
    n = origins.shape[0]
    if t_max is None:
        t_max = origins.new_full((n,), T_MAX)
    parts = [_traverse_block(o, d, tm, bvh, t_min, any_hit=False)
             for o, d, tm in _blocks(origins, dirs, t_max, block)]
    if not parts:
        empty = origins.new_zeros((0,))
        return Hit(t=empty, tri=empty.to(torch.int32), u=empty, v=empty)
    best_t, best_k, best_u, best_v = (torch.cat(x) for x in zip(*parts))
    tri = torch.where(best_k >= 0, bvh.order[best_k.clamp(min=0).long()], -1)
    return Hit(t=best_t, tri=tri, u=best_u, v=best_v)


def traverse_occluded(origins, dirs, bvh: LBVH, t_max, t_min=T_MIN,
                      block: int = 65536):
    """Any-hit shadow query: True where something lies in (t_min, t_max[i])."""
    parts = [_traverse_block(o, d, tm, bvh, t_min, any_hit=True)[0] < INF
             for o, d, tm in _blocks(origins, dirs, t_max, block)]
    if not parts:
        return torch.zeros((0,), dtype=torch.bool, device=origins.device)
    return torch.cat(parts)
