"""Acceleration structures: treelet clusters + the rows the kernels stage,
and the LBVH with its stackless traversal (the correctness oracle).

Counterpart of ``directx_raytracer_tpu/bvh/__init__.py`` (``BVH``,
``build_bvh``, ``make_bvh_intersect_fn``, ``make_bvh_occluder_factory``).
``make_bvh_intersect_fn`` / ``make_bvh_occluder_factory`` are the
renderer-facing API (drop-ins for the brute-force defaults of
render/debug.py and render/whitted.py); ``use_kernels`` is the JAX
package's ``use_pallas``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .clustered import (
    ClusterSet,
    build_clusters,
    clusters_from_numpy,
    intersect_clustered,
    occluded_clustered,
)
from .cuda_intersect import (
    TILE_R,
    cluster_rows,
    cull_rows,
    intersect_fused,
    occluded_fused,
    super_rows,
    woop_rows,
)
from .lbvh import LBVH, build_lbvh, lbvh_from_numpy
from .traverse import traverse_closest, traverse_occluded


@dataclass
class BVH:
    """Clusters plus the kernel operands made once per build: their
    (C, K, 12) triangle-major Woop rows (``woop_rows``: the clusters' Woop
    blocks as they are, read by the closest-hit and any-hit walks), (8, S)
    superblock hull rows (``super_rows``, read by the superblock binner)
    and (C, 8) cull boxes (``cull_rows``, read by the closest-hit walk)."""

    clusters: ClusterSet
    wrows: torch.Tensor
    srows: torch.Tensor
    crows: torch.Tensor


def build_bvh(geometry, k: int = 128) -> BVH:
    """Clusters of ``k`` treelet slots (k = 128 matches the scene's treelet
    leaves, so clusters align with leaf boundaries), on the geometry's
    device."""
    cs = build_clusters(geometry, k=k)
    wrows = woop_rows(cs)
    return BVH(cs, wrows, super_rows(cluster_rows(cs)), cull_rows(wrows))


def make_bvh_intersect_fn(bvh: BVH, use_kernels: bool = True,
                          block: int = 1536):
    """``intersect(origins, dirs, geometry, tile_r=None) -> Hit`` over a
    prebuilt BVH; ``tile_r=None`` takes ``TILE_R``-ray tiles.  Renderers
    pass their primary schedule's chunk (ops.rays.pick_schedule).

    ``use_kernels=True`` is the fused query (``intersect_fused``: the
    binning and closest-hit kernels on CUDA tensors).  ``use_kernels=False``
    selects the plain clustered walker (``intersect_clustered`` over blocks
    of ``block`` rays): plain torch on any device, slower."""
    if use_kernels:
        def intersect(origins, dirs, geometry, tile_r=None):
            return intersect_fused(origins, dirs, bvh.clusters, bvh.wrows,
                                   tile_r=tile_r or TILE_R, srows=bvh.srows,
                                   crows=bvh.crows)
    else:
        def intersect(origins, dirs, geometry, tile_r=None):
            return intersect_clustered(origins, dirs, bvh.clusters, block=block)

    return intersect


def make_bvh_occluder_factory(bvh: BVH, use_kernels: bool = True,
                              block: int = 1536):
    """``factory(geometry) -> occluded(origins, dirs, max_t) -> (N,) bool``
    over a prebuilt BVH, for shadow rays: the fused query
    (``occluded_fused``, ``TILE_R``-ray tiles) or, with
    ``use_kernels=False``, the plain clustered walker
    (``occluded_clustered``)."""

    def factory(geometry):
        if use_kernels:
            def occluded(origins, dirs, max_t):
                return occluded_fused(origins, dirs, bvh.clusters, bvh.wrows,
                                      max_t, srows=bvh.srows)
        else:
            def occluded(origins, dirs, max_t):
                return occluded_clustered(origins, dirs, bvh.clusters, max_t,
                                          block=block)

        return occluded

    return factory


__all__ = [
    "BVH",
    "LBVH",
    "ClusterSet",
    "build_bvh",
    "build_clusters",
    "build_lbvh",
    "clusters_from_numpy",
    "intersect_clustered",
    "intersect_fused",
    "lbvh_from_numpy",
    "make_bvh_intersect_fn",
    "make_bvh_occluder_factory",
    "occluded_clustered",
    "occluded_fused",
    "traverse_closest",
    "traverse_occluded",
]
