"""Treelet clusters: the BVH level the kernels bin and walk, and the
plain clustered walker.

Counterpart of ``directx_raytracer_tpu/bvh/clustered.py`` (``ClusterSet``,
``build_clusters``, ``_cluster_slabs``, ``_closest_block``,
``_occluded_block``, ``intersect_clustered``, ``occluded_clustered``).
``build_geometry`` stores triangles in treelet order (models/scene.py), so
for a scene built by this package ``identity_order`` holds and a cluster
slot IS the device triangle id; geometry in any other order is sorted along
the Morton curve here (``order`` then maps slots back to triangle ids).
``clusters_from_numpy`` takes the JAX package's ClusterSet buffers, so both
packages can run on identical inputs.

Each cluster is K contiguous triangle slots with an AABB (sentinel slots
excluded) and a (K, 3, 4) Woop-transform block; ``valid`` is False for
clusters made only of sentinels, which bin to nothing.

The walker (``intersect_clustered``/``occluded_clustered``) is the plain
torch route of the BVH (``make_bvh_intersect_fn(use_kernels=False)``): rays
go in blocks of B.  Phase 1 slab-tests all B rays against all C cluster
AABBs.  Phase 2 sorts the clusters any ray of the block overlaps near to
far by the block's least entry t and walks them, folding a dense B x K
Woop test into the running closest hit; the walk stops once the next
cluster's entry t exceeds every ray's current best (one flag read per
step).  The worst case degrades to brute force over the block.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import Geometry, _Tensors
from ..ops.intersect import Hit, _closest_in_block, intersect_block
from ..ops.rays import T_MAX, T_MIN
from .lbvh import morton_codes
from .traverse import _blocks, _safe_inv

INF = float("inf")


@dataclass
class ClusterSet(_Tensors):
    """Treelet-ordered triangle clusters (SoA, padded with miss sentinels)."""

    woop: torch.Tensor  # (C, K, 3, 4) f32 — per-cluster Woop blocks
    aabb_min: torch.Tensor  # (C, 3) f32
    aabb_max: torch.Tensor  # (C, 3) f32
    valid: torch.Tensor  # (C,) bool — False for all-sentinel clusters
    order: torch.Tensor  # (C*K,) i32 — sorted slot -> tri id (-1 pad)
    v0: torch.Tensor  # (C*K, 3) f32 — sorted geometry (exact MT re-evaluation)
    e1: torch.Tensor
    e2: torch.Tensor
    n_tris: int
    k: int
    identity_order: bool  # geometry already sorted: slot == tri id


def build_clusters(geometry: Geometry, k: int = 128) -> ClusterSet:
    """Clusters of ``k`` consecutive slots, on the geometry's device: of
    the geometry as stored when it is in treelet order
    (``geometry.morton_sorted``), else of its triangles sorted along the
    Morton curve of their centroids (a stable sort of ``lbvh.morton_codes``,
    the order ``build_lbvh`` takes)."""
    t = geometry.n_tris
    if t == 0:
        raise ValueError("cannot build clusters over an empty scene")
    presorted = bool(geometry.morton_sorted)
    v0, e1, e2 = geometry.v0[:t], geometry.e1[:t], geometry.e2[:t]
    woop = geometry.woop[:t]
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_min = torch.minimum(torch.minimum(p0, p1), p2)
    tri_max = torch.maximum(torch.maximum(p0, p1), p2)
    order = torch.arange(t, dtype=torch.int32, device=v0.device)
    if not presorted:
        centroid = (tri_min + tri_max) * 0.5
        codes = morton_codes(centroid, tri_min.amin(dim=0), tri_max.amax(dim=0))
        perm = torch.sort(codes, stable=True).indices
        order = perm.to(torch.int32)
        v0, e1, e2, woop = v0[perm], e1[perm], e2[perm], woop[perm]
        tri_min, tri_max = tri_min[perm], tri_max[perm]

    c = -(-t // k)
    pad = c * k - t

    def padded(x, fill):
        if not pad:
            return x
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    sent_woop = woop.new_zeros((3, 4))
    sent_woop[:, 3] = -1e30
    s_woop = padded(woop, 0.0)
    s_woop[t:] = sent_woop
    # Sentinel (degenerate) rows must not bloat cluster AABBs, and clusters
    # made ONLY of sentinels must not bin at all.
    real = (e1.abs().amax(dim=1) > 0) | (e2.abs().amax(dim=1) > 0)
    real_s = padded(real, False)
    inf = float("inf")
    s_min = torch.where(real_s[:, None], padded(tri_min, inf), inf)
    s_max = torch.where(real_s[:, None], padded(tri_max, -inf), -inf)
    return ClusterSet(
        woop=s_woop.reshape(c, k, 3, 4),
        aabb_min=s_min.reshape(c, k, 3).amin(dim=1),
        aabb_max=s_max.reshape(c, k, 3).amax(dim=1),
        valid=real_s.reshape(c, k).any(dim=1),
        order=padded(order, -1),
        v0=padded(v0, 0.0),
        e1=padded(e1, 0.0),
        e2=padded(e2, 0.0),
        n_tris=t,
        k=k,
        identity_order=presorted,
    )


def clusters_from_numpy(fields: dict, device="cuda") -> ClusterSet:
    """A ClusterSet from the JAX package's ClusterSet leaves, handed over
    as numpy arrays (and Python scalars for ``n_tris``/``k``/
    ``identity_order``) keyed by the JAX field names.  Arrays keep their
    dtype and bits."""
    vals = {}
    for f in dataclasses.fields(ClusterSet):
        x = fields[f.name]
        if f.type == "int":
            vals[f.name] = int(x)
        elif f.type == "bool":
            vals[f.name] = bool(x)
        else:
            vals[f.name] = torch.from_numpy(np.array(x))  # writable copy
    return ClusterSet(**vals).to(device)


# ---------------------------------------------------------------------------
# The plain clustered walker
# ---------------------------------------------------------------------------


def _cluster_slabs(o, d, cs: ClusterSet, t_min):
    """Entry/exit t of every ray against every cluster AABB.

    Returns (tn, tf): each (B, C); a ray overlaps cluster c iff
    tn <= tf and tf >= t_min.  Computed per-axis to avoid a (B, C, 3)
    intermediate.
    """
    inv = _safe_inv(d)
    shape = (o.shape[0], cs.aabb_min.shape[0])
    tn = o.new_full(shape, -INF)
    tf = o.new_full(shape, INF)
    for ax in range(3):
        a = (cs.aabb_min[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        b = (cs.aabb_max[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    return tn, tf


def _closest_block(o, d, cs: ClusterSet, t_min, t_max):
    """Closest hit for one coherent ray block (B rays): (best_t, best_slot,
    best_u, best_v), best_t = inf and best_slot = -1 on a miss."""
    b = o.shape[0]
    tn, tf = _cluster_slabs(o, d, cs, t_min)
    overlap = (tn <= tf) & (tf >= t_min) & (tn <= t_max[:, None])  # (B, C)
    needed = overlap.any(dim=0)  # (C,)
    # Near-to-far over the block: key = min entry t over overlapping rays.
    entry = torch.where(overlap, tn.clamp(min=t_min), INF)
    key = torch.where(needed, entry.amin(dim=0), INF)
    key_sorted, cluster_ids = torch.sort(key, stable=True)
    n_needed = int(needed.sum())

    carry = (
        torch.minimum(o.new_full((b,), INF), t_max),
        torch.full((b,), -1, dtype=torch.int32, device=o.device),
        o.new_zeros((b,)),
        o.new_zeros((b,)),
    )
    key_sorted, cluster_ids = key_sorted.tolist(), cluster_ids.tolist()
    for i in range(n_needed):
        # The early-out: every later cluster starts past every ray's best.
        if not key_sorted[i] <= float(carry[0].max()):
            break
        c = cluster_ids[i]
        carry = _closest_in_block(o, d, cs.woop[c], c * cs.k, carry, t_min,
                                  T_MAX)
    best_t, best_slot, best_u, best_v = carry
    hit = best_slot >= 0
    return torch.where(hit, best_t, INF), best_slot, best_u, best_v


def _occluded_block(o, d, cs: ClusterSet, t_min, t_max):
    """Any-hit for one ray block: True where something lies in (t_min, t_max)."""
    tn, tf = _cluster_slabs(o, d, cs, t_min)
    overlap = (tn <= tf) & (tf >= t_min) & (tn <= t_max[:, None])
    needed = overlap.any(dim=0)
    key = torch.where(needed, torch.where(overlap, tn, INF).amin(dim=0), INF)
    cluster_ids = torch.sort(key, stable=True).indices.tolist()
    n_needed = int(needed.sum())

    blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    disarmed = t_max <= t_min
    for i in range(n_needed):
        if bool((blocked | disarmed).all()):
            break
        tt, _, _, _ = intersect_block(o, d, cs.woop[cluster_ids[i]], t_min,
                                      T_MAX)
        blocked = blocked | (tt < t_max[:, None]).any(dim=1)
    return blocked


def intersect_clustered(origins, dirs, cs: ClusterSet, t_max=None, t_min=T_MIN,
                        block: int = 8192) -> Hit:
    """Closest hit via per-block cluster binning, in plain torch; ``tri`` in
    ORIGINAL triangle ids."""
    n = origins.shape[0]
    if t_max is None:
        t_max = origins.new_full((n,), T_MAX)
    parts = [_closest_block(o, d, cs, t_min, tm)
             for o, d, tm in _blocks(origins, dirs, t_max, block)]
    if not parts:
        empty = origins.new_zeros((0,))
        return Hit(t=empty, tri=empty.to(torch.int32), u=empty, v=empty)
    best_t, k, best_u, best_v = (torch.cat(x) for x in zip(*parts))
    if cs.identity_order:
        tri = k  # slot == triangle id
    else:
        tri = torch.where(k >= 0, cs.order[k.clamp(min=0).long()], -1)
    return Hit(t=best_t, tri=tri, u=best_u, v=best_v)


def occluded_clustered(origins, dirs, cs: ClusterSet, t_max, t_min=T_MIN,
                       block: int = 8192):
    """Any hit via per-block cluster binning, in plain torch: (N,) bool."""
    parts = [_occluded_block(o, d, cs, t_min, tm)
             for o, d, tm in _blocks(origins, dirs, t_max, block)]
    if not parts:
        return torch.zeros((0,), dtype=torch.bool, device=origins.device)
    return torch.cat(parts)
