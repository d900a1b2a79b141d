"""TEST ORACLE binning — the sorted near-to-far binner, derived apart from
the production binning kernel.

Counterpart of ``directx_raytracer_tpu/bvh/binning_oracle.py``
(``bin_clusters``).  ``bin_clusters`` is NOT called by any render path:
the renderers bin through ``cuda_intersect.bin_lists`` (the fused kernel,
or its plain twin ``bin_lists_plain``).  This module shares no code with
either: it works on the tiled rays and the ClusterSet themselves, not on
the kernel's packed ``tile_params``/``cluster_rows`` operands, so the tests
can check that both schedule the SAME (tile, cluster) visit sets and the
production path cannot drift silently.

Not carried from the JAX module: ``build_visit_groups`` (the fixed-budget
grouped visit grid of the TPU kernels' launches: a CTA walks its tile's
ragged list itself) and the ``bounds=`` argument (the analytic
``tile_frustum_bounds`` path, which the port does not have).

Reference parity: this is the explicit counterpart of the traversal
ordering the reference never sees (DXRTRenderer.cpp:548-806 delegates it
to Direct3D 12).
"""

from __future__ import annotations

import torch

from ..ops.rays import T_MIN
from .clustered import ClusterSet

INF = float("inf")
BIG = 1e30


def _interval_inv(d_lo, d_hi):
    """Interval reciprocal; spans of zero go conservatively infinite."""
    same_sign = (d_lo > 0) | (d_hi < 0)
    i_lo = torch.where(same_sign, 1.0 / d_hi, -BIG)
    i_hi = torch.where(same_sign, 1.0 / d_lo, BIG)
    return i_lo, i_hi


def bin_clusters(origins, dirs, cs: ClusterSet, t_min=T_MIN):
    """Per-tile cluster lists via interval-arithmetic frustum culling.

    Args:
      origins, dirs: (T, R, 3) tiled rays.
    Returns (ids (T, C) i32 near-to-far then misses, entry (T, C) f32 sorted
    conservative entry distances (inf for misses), counts (T,) i32).
    """
    o_lo = origins.amin(dim=1)  # (T, 3)
    o_hi = origins.amax(dim=1)
    d_lo = dirs.amin(dim=1)
    d_hi = dirs.amax(dim=1)

    entry = origins.new_full((origins.shape[0], cs.aabb_min.shape[0]), -BIG)
    exit_ = torch.full_like(entry, BIG)
    for ax in range(3):
        n_lo = cs.aabb_min[None, :, ax] - o_hi[:, None, ax]  # (T, C)
        n_hi = cs.aabb_max[None, :, ax] - o_lo[:, None, ax]
        i_lo, i_hi = _interval_inv(d_lo[:, None, ax], d_hi[:, None, ax])
        prods = torch.stack(
            [n_lo * i_lo, n_lo * i_hi, n_hi * i_lo, n_hi * i_hi], dim=0
        ).clamp(-BIG, BIG)
        entry = torch.maximum(entry, prods.amin(dim=0))
        exit_ = torch.minimum(exit_, prods.amax(dim=0))

    overlap = (entry <= exit_) & (exit_ >= t_min) & cs.valid[None, :]
    key = torch.where(overlap, entry.clamp(min=t_min), INF)
    key_sorted, ids = torch.sort(key, dim=1, stable=True)
    counts = overlap.sum(dim=1, dtype=torch.int32)
    return ids.to(torch.int32), key_sorted, counts
