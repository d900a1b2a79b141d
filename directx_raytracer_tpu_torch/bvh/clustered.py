"""Treelet clusters: the BVH level the kernels bin and walk.

Counterpart of ``directx_raytracer_tpu/bvh/clustered.py`` (``ClusterSet``,
``build_clusters``), presorted path only: ``build_geometry`` always stores
triangles in treelet order (models/scene.py), so ``identity_order`` holds
and a cluster slot IS the device triangle id.  ``clusters_from_numpy``
takes the JAX package's ClusterSet buffers, so both packages can run on
identical inputs.

Each cluster is K contiguous triangle slots with an AABB (sentinel slots
excluded) and a (K, 3, 4) Woop-transform block; ``valid`` is False for
clusters made only of sentinels, which bin to nothing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import Geometry, _Tensors


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
    """Clusters of ``k`` consecutive slots of treelet-ordered geometry, on
    the geometry's device."""
    t = geometry.n_tris
    if t == 0:
        raise ValueError("cannot build clusters over an empty scene")
    if not geometry.morton_sorted:
        raise ValueError("geometry must be stored in treelet order")
    v0, e1, e2 = geometry.v0[:t], geometry.e1[:t], geometry.e2[:t]
    woop = geometry.woop[:t]
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_min = torch.minimum(torch.minimum(p0, p1), p2)
    tri_max = torch.maximum(torch.maximum(p0, p1), p2)

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
        order=padded(torch.arange(t, dtype=torch.int32, device=v0.device), -1),
        v0=padded(v0, 0.0),
        e1=padded(e1, 0.0),
        e2=padded(e2, 0.0),
        n_tris=t,
        k=k,
        identity_order=True,
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
