"""Acceleration structure: treelet clusters + the Woop rows the closest-hit
kernel stages.

Counterpart of ``directx_raytracer_tpu/bvh/__init__.py`` (``BVH``,
``build_bvh``, ``make_bvh_intersect_fn``).  ``build_bvh`` /
``make_bvh_intersect_fn`` are the renderer-facing API (drop-in for the
brute-force default of render/debug.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .clustered import ClusterSet, build_clusters, clusters_from_numpy
from .cuda_intersect import TILE_R, intersect_fused, woop_rows


@dataclass
class BVH:
    """Clusters plus their (C, 12, K) Woop rows (``woop_rows``), the
    kernel-friendly copy made once per build."""

    clusters: ClusterSet
    wrows: torch.Tensor


def build_bvh(geometry, k: int = 128) -> BVH:
    """Clusters of ``k`` treelet slots (k = 128 matches the scene's treelet
    leaves, so clusters align with leaf boundaries), on the geometry's
    device."""
    cs = build_clusters(geometry, k=k)
    return BVH(cs, woop_rows(cs))


def make_bvh_intersect_fn(bvh: BVH):
    """``intersect(origins, dirs, geometry, tile_r=None) -> Hit`` over a
    prebuilt BVH; ``tile_r=None`` takes ``TILE_R``-ray tiles.  Renderers
    pass their primary schedule's chunk (ops.rays.pick_schedule)."""

    def intersect(origins, dirs, geometry, tile_r=None):
        return intersect_fused(origins, dirs, bvh.clusters, bvh.wrows,
                               tile_r=tile_r or TILE_R)

    return intersect


__all__ = [
    "BVH",
    "ClusterSet",
    "build_bvh",
    "build_clusters",
    "clusters_from_numpy",
    "intersect_fused",
    "make_bvh_intersect_fn",
]
