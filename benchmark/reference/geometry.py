"""Plain ray-triangle queries over every triangle of a scene: the reference
the program's frames are judged by.

Plain PyTorch, in float64 by default.  It reads the benchmark's scene data
(vertices and indices as the scene generator made them) and works out all it
needs itself: triangle corners, unit face normals, vertex normals (the sum
of the adjacent unit face normals, normalised: the reference application's
``CRTMesh::calculateVertexNormals``), materials.

The test is Moller-Trumbore's, rewritten so that a block of rays against a
block of triangles is one matrix product: with the ray's features
``[o x d, d, o, 1]`` (10 columns), the determinant ``d . (e2 x e1)`` and the
numerators of u, v and t (``e2 . (o x d) - d . (e2 x v0)``,
``-e1 . (o x d) - d . (v0 x e1)``, ``o . (e1 x e2) - e2 . (v0 x e1)``) are
linear in them.  A hit is ``det != 0``, ``u >= 0``, ``v >= 0``,
``u + v <= 1`` and ``t_min < t < t_max``; the closest hit takes the least t
(the lowest triangle among equals).

``precision``: ``"float64"`` for the reference, ``"tf32"`` for the control
(float32 tensors whose matrix products round their operands to TF32's
10-bit mantissa, as the card's TF32 path does, and accumulate in float32;
the rounding is explicit, so the control reads the same on any device).
"""

from __future__ import annotations

import torch

T_MIN = 1e-3
T_MAX = 1e4
RAY_BLOCK = 4096
TRI_BLOCK = 8192


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0, n, torch.ones_like(n))


class Triangles:
    """Every triangle of the scene data, on ``device``: corners, unit face
    normals, per-corner vertex normals, material index, and the blocks of
    the matrix the test multiplies by."""

    def __init__(self, data: dict, device, precision: str = "float64"):
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        f64 = torch.float64
        v0s, v1s, v2s, fns, ns, mats = [], [], [], [], [], []
        for m in data["meshes"]:
            verts = torch.as_tensor(m["vertices"], device=device).to(f64)
            tri = torch.as_tensor(m["indices"], device=device).long().reshape(-1, 3)
            a, b, c = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
            fn = _unit(torch.linalg.cross(b - a, c - a))
            acc = torch.zeros_like(verts)
            for corner in range(3):
                acc.index_add_(0, tri[:, corner], fn)
            vn = _unit(acc)
            v0s.append(a); v1s.append(b); v2s.append(c); fns.append(fn)
            ns.append(torch.stack([vn[tri[:, k]] for k in range(3)], dim=1))
            mats.append(torch.full((len(tri),), int(m["material"]), device=device))
        dt = self.dtype
        self.v0 = torch.cat(v0s).to(dt)
        self.e1 = (torch.cat(v1s) - torch.cat(v0s)).to(dt)
        self.e2 = (torch.cat(v2s) - torch.cat(v0s)).to(dt)
        self.face_normal = torch.cat(fns).to(dt)
        self.corner_normals = torch.cat(ns).to(dt)  # (T, 3 corners, 3)
        self.material = torch.cat(mats)
        self.n = self.v0.shape[0]
        self.blocks = [self._block(s, min(s + TRI_BLOCK, self.n))
                       for s in range(0, self.n, TRI_BLOCK)]

    def _block(self, s: int, e: int):
        """(10, 4 B) matrix of triangles [s, e): columns det | u | v | t."""
        v0, e1, e2 = (x[s:e].to(torch.float64) for x in (self.v0, self.e1, self.e2))
        cross = torch.linalg.cross
        zero = torch.zeros_like(v0)
        e2xv0, v0xe1 = cross(e2, v0), cross(v0, e1)
        rows_oxd = torch.stack([zero, e2, -e1, zero], dim=1)  # (B, 4, 3)
        rows_d = torch.stack([cross(e2, e1), -e2xv0, -v0xe1, zero], dim=1)
        rows_o = torch.stack([zero, zero, zero, cross(e1, e2)], dim=1)
        const = torch.zeros((e - s, 4, 1), dtype=torch.float64, device=v0.device)
        const[:, 3, 0] = -(e2 * v0xe1).sum(-1)
        m = torch.cat([rows_oxd, rows_d, rows_o, const], dim=2)  # (B, 4, 10)
        m = m.permute(2, 1, 0).reshape(10, -1).to(self.dtype)  # (10, 4 B)
        return s, e, m.contiguous()

    def _features(self, o, d):
        one = torch.ones_like(o[:, :1])
        return torch.cat([torch.linalg.cross(o, d), d, o, one], dim=1)

    def _tests(self, feats, block, t_min, t_max):
        """(t, u, v, hit) of the rays against one triangle block, (R, B)."""
        s, e, m = block
        if self.precision == "tf32":
            out = round_tf32(feats) @ round_tf32(m)
        else:
            out = feats @ m
        out = out.view(feats.shape[0], 4, e - s)
        det, un, vn, tn = out.unbind(1)
        ok = det != 0
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        u, v, t = un * inv, vn * inv, tn * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
        return t, u, v, hit

    def closest(self, o, d, t_min=T_MIN, t_max=T_MAX):
        """Closest hit of each ray: (t, triangle or -1, u, v)."""
        o, d = o.to(self.dtype), d.to(self.dtype)
        n = o.shape[0]
        best_t = torch.full((n,), float("inf"), dtype=self.dtype, device=o.device)
        best_i = torch.full((n,), -1, dtype=torch.long, device=o.device)
        best_u = torch.zeros_like(best_t)
        best_v = torch.zeros_like(best_t)
        for r in range(0, n, RAY_BLOCK):
            feats = self._features(o[r:r + RAY_BLOCK], d[r:r + RAY_BLOCK])
            sl = slice(r, r + RAY_BLOCK)
            for block in self.blocks:
                t, u, v, hit = self._tests(feats, block, t_min, t_max)
                t = torch.where(hit, t, float("inf"))
                bt, bi = t.min(dim=1)
                closer = bt < best_t[sl]
                best_t[sl] = torch.where(closer, bt, best_t[sl])
                best_i[sl] = torch.where(closer, bi + block[0], best_i[sl])
                best_u[sl] = torch.where(closer, u.gather(1, bi[:, None])[:, 0], best_u[sl])
                best_v[sl] = torch.where(closer, v.gather(1, bi[:, None])[:, 0], best_v[sl])
        return best_t, best_i, best_u, best_v

    def occluded(self, o, d, t_max, t_min=T_MIN):
        """Whether some triangle lies at t_min < t < t_max[i] along ray i."""
        o, d, t_max = o.to(self.dtype), d.to(self.dtype), t_max.to(self.dtype)
        n = o.shape[0]
        blocked = torch.zeros((n,), dtype=torch.bool, device=o.device)
        for r in range(0, n, RAY_BLOCK):
            feats = self._features(o[r:r + RAY_BLOCK], d[r:r + RAY_BLOCK])
            tm = t_max[r:r + RAY_BLOCK, None]
            for block in self.blocks:
                t, _, _, hit = self._tests(feats, block, t_min, T_MAX)
                blocked[r:r + RAY_BLOCK] |= (hit & (t < tm)).any(dim=1)
        return blocked
