"""LBVH construction — the from-scratch replacement for Direct3D 12's
opaque acceleration-structure build (``BuildRaytracingAccelerationStructure``,
DXRTRenderer.cpp:672/791; SURVEY.md fact 3).

Counterpart of ``directx_raytracer_tpu/bvh/lbvh.py`` (``LBVH``,
``morton_codes``, ``_karras_ranges``, ``build_lbvh``), as plain torch on
the geometry's device.  The tree is the correctness oracle of the
production cluster path (bvh/cuda_intersect.py): ``bvh/traverse.py`` walks
it.  ``lbvh_from_numpy`` takes the JAX package's LBVH leaves, so both
packages can walk the same tree.

Fully vectorized, int32 throughout:

1. triangle centroids -> 30-bit Morton codes over the scene AABB (10 bits
   per axis, magic-number bit spreading);
2. a stable sort orders triangles along the Z-curve (equal codes keep
   index order, which the index tiebreak below relies on);
3. Karras-2012 internal-node topology: each of the T-1 internal nodes finds
   its leaf range and split with fixed-trip-count binary searches over the
   common-prefix metric delta(i, j) = clz(key_i ^ key_j) (index-XOR tiebreak
   for duplicate codes, so no 64-bit keys needed);
4. skip-pointer ("rope") threading for stackless traversal, computed by a
   top-down sweep: skip(left child) = right sibling, skip(right child) =
   skip(parent), repeated until nothing changes (the tree's depth in
   sweeps; each sweep reads one flag back to the host);
5. AABB refit bottom-up by the same kind of sweeps, internal nodes starting
   at the *scene* AABB.

``max_depth`` bounds both kinds of sweeps.  The 62-bit virtual keys are
distinct, so a tree is at most 62 deep and the default of 64 always
converges.  A smaller bound that cuts the threading short would leave
ropes unset, and a walk over them ends early and misses hits (the JAX
package's docstring says such a tree stays correct; it does not), so
``build_lbvh`` raises instead of returning that tree.

Node id encoding: 0..T-2 are internal (0 = root), T-1+k is leaf k (the k-th
triangle in Morton order).  A single-triangle scene has no internal nodes
and root = leaf 0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import Geometry, _Tensors

SENTINEL = -1


@dataclass
class LBVH(_Tensors):
    """Threaded LBVH over Morton-sorted triangles."""

    # Unified node arrays, size 2T-1 (internal 0..T-2, leaf k at T-1+k).
    aabb_min: torch.Tensor  # (2T-1, 3) f32
    aabb_max: torch.Tensor  # (2T-1, 3) f32
    left: torch.Tensor  # (2T-1,) i32 — first child (internal only; SENTINEL else)
    skip: torch.Tensor  # (2T-1,) i32 — next node when skipping this subtree
    # Morton-sorted geometry (leaf k = sorted triangle k).
    order: torch.Tensor  # (T,) i32 — sorted position -> original triangle id
    v0: torch.Tensor  # (T, 3) f32
    e1: torch.Tensor  # (T, 3) f32
    e2: torch.Tensor  # (T, 3) f32
    n_tris: int

    @property
    def n_internal(self) -> int:
        return self.n_tris - 1

    @property
    def root(self) -> int:
        return 0 if self.n_tris > 1 else self.leaf_base

    @property
    def leaf_base(self) -> int:
        return max(self.n_tris - 1, 0)


def lbvh_from_numpy(fields: dict, device="cuda") -> LBVH:
    """An LBVH from the JAX package's LBVH leaves, handed over as numpy
    arrays (and a Python int for ``n_tris``) keyed by the JAX field names.
    Arrays keep their dtype and bits."""
    vals = {}
    for f in dataclasses.fields(LBVH):
        x = fields[f.name]
        vals[f.name] = (int(x) if f.type == "int"
                        else torch.from_numpy(np.array(x)))  # writable copy
    return LBVH(**vals).to(device)


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------


def _spread_bits_10(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids, lo, hi):
    """30-bit Morton codes (int32) of points quantized to a 1024^3 grid
    over [lo, hi]."""
    extent = (hi - lo).clamp(min=1e-12)
    q = (((centroids - lo) / extent) * 1024.0).clamp(0.0, 1023.0).to(torch.int32)
    return (
        (_spread_bits_10(q[:, 0]) << 2)
        | (_spread_bits_10(q[:, 1]) << 1)
        | _spread_bits_10(q[:, 2])
    )


# ---------------------------------------------------------------------------
# Karras topology
# ---------------------------------------------------------------------------


def _clz32(x):
    """Leading zeros of each int32 as a 32-bit pattern (32 for 0, 0 for a
    negative value): a 5-step binary search on the logical right shifts,
    exact for every input (a float-exponent trick is not above 2^24)."""
    x = x.to(torch.int32)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        # Logical shift of a two's-complement int: arithmetic shift, then
        # clear the sign bits it dragged in.
        high = (x >> (32 - s)) & ((1 << s) - 1)
        empty = high == 0
        n = torch.where(empty, n + s, n)
        x = torch.where(empty, x << s, x)
    return torch.where(x == 0, n + 1, n)


def _delta_fn(keys, n):
    """delta(i, j): common-prefix length of keys i and j in a 62-bit virtual
    key (30-bit Morton ++ 32-bit index tiebreak); -1 outside [0, n)."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        kx = keys[i.long()] ^ keys[jc.long()]  # stays int32
        ix = i ^ jc
        d = torch.where(kx == 0, 32 + _clz32(ix), _clz32(kx))
        return torch.where(valid, d, -1)

    return delta


def _karras_ranges(keys):
    """Children of every internal node (vectorized Karras 2012).

    Returns (left_child, right_child) as unified node ids, each (T-1,) i32.
    """
    n = keys.shape[0]
    n_int = n - 1
    leaf_base = n_int
    i = torch.arange(n_int, dtype=torch.int32, device=keys.device)
    delta = _delta_fn(keys, n)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1)).to(torch.int32)
    delta_min = delta(i, i - d)

    # Range length: largest l with delta(i, i + l*d) > delta_min (delta is
    # monotone non-increasing away from i on sorted keys).
    bits = max((n - 1).bit_length(), 1)
    l = torch.zeros_like(i)
    for p in reversed(range(bits)):
        t = l + (1 << p)
        cond = delta(i, i + t * d) > delta_min
        l = torch.where(cond, t, l)
    j = i + l * d

    # Split: largest s < l with delta(i, i + s*d) > delta(i, j).
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    for p in reversed(range(bits)):
        t = s + (1 << p)
        cond = (t < l) & (delta(i, i + t * d) > delta_node)
        s = torch.where(cond, t, s)
    gamma = i + s * d + d.clamp(max=0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, leaf_base + gamma, gamma)
    right = torch.where(hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return left, right


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _build(v0, e1, e2, n_tris: int, max_depth: int) -> LBVH:
    t = n_tris
    dev = v0.device
    p0 = v0
    p1 = v0 + e1
    p2 = v0 + e2
    tri_min = torch.minimum(torch.minimum(p0, p1), p2)
    tri_max = torch.maximum(torch.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5
    scene_lo = tri_min.amin(dim=0)
    scene_hi = tri_max.amax(dim=0)

    codes = morton_codes(centroid, scene_lo, scene_hi)
    codes, order = torch.sort(codes, stable=True)
    order32 = order.to(torch.int32)

    sv0, se1, se2 = v0[order], e1[order], e2[order]
    s_min, s_max = tri_min[order], tri_max[order]

    n_int = t - 1
    leaf_base = n_int
    n_nodes = 2 * t - 1

    if t == 1:
        none = torch.full((1,), SENTINEL, dtype=torch.int32, device=dev)
        return LBVH(aabb_min=s_min, aabb_max=s_max, left=none,
                    skip=none.clone(), order=order32, v0=sv0, e1=se1, e2=se2,
                    n_tris=1)

    left, right = _karras_ranges(codes)
    left_l, right_l = left.long(), right.long()

    left_arr = torch.full((n_nodes,), SENTINEL, dtype=torch.int32, device=dev)
    left_arr[:n_int] = left

    # Skip threading: left children point at their sibling immediately; right
    # children inherit the parent's skip.  Each sweep pushes skips one level
    # deeper, so the fixed point arrives after ``tree depth`` sweeps;
    # max_depth stays as a safety bound.
    skip = torch.full((n_nodes,), SENTINEL, dtype=torch.int32, device=dev)
    skip[left_l] = right
    for _ in range(max_depth + 1):
        new = skip[:n_int]  # each internal node's skip, for its right child
        if not bool((skip[right_l] != new).any()):
            break
        skip = skip.clone()
        skip[right_l] = new
    else:
        raise ValueError(f"the tree is deeper than max_depth={max_depth}: "
                         "its skip pointers are not threaded")

    # AABB refit: leaves exact; internals start at the scene box
    # (conservative), tighten bottom-up until the sweep is a no-op.
    amin = scene_lo.expand(n_nodes, 3).clone()
    amax = scene_hi.expand(n_nodes, 3).clone()
    amin[leaf_base:] = s_min
    amax[leaf_base:] = s_max
    for _ in range(max_depth):
        new_mn = torch.minimum(amin[left_l], amin[right_l])
        new_mx = torch.maximum(amax[left_l], amax[right_l])
        changed = bool((new_mn != amin[:n_int]).any()
                       | (new_mx != amax[:n_int]).any())
        amin[:n_int] = new_mn
        amax[:n_int] = new_mx
        if not changed:
            break

    return LBVH(aabb_min=amin, aabb_max=amax, left=left_arr, skip=skip,
                order=order32, v0=sv0, e1=se1, e2=se2, n_tris=t)


def build_lbvh(geometry: Geometry, max_depth: int = 64) -> LBVH:
    """Build the LBVH over a scene's triangle slots, on the geometry's
    device.

    ``max_depth`` bounds the skip/refit propagation sweeps; a tree deeper
    than it raises ``ValueError`` (see module doc).
    """
    t = geometry.n_tris
    if t == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    return _build(geometry.v0[:t], geometry.e1[:t], geometry.e2[:t], t,
                  max_depth)
