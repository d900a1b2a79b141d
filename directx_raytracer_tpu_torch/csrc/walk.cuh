// walk.cuh: what the closest-hit and any-hit walks (closest_hit.cu,
// any_hit.cu) share: the asynchronous staging of a cluster's Woop rows and
// cull box into shared memory, the cull's (ray, box) slab test, and the
// (ray, triangle) Woop test.
//
// Operands: Woop rows (C, K, 12) f32, triangle-major (the cluster set's
// (C, K, 3, 4) blocks as they are): triangle kk of a cluster is 48 bytes,
// three float4 rows u = W[0][0..3], v = W[1][0..3], z = W[2][0..3].  A
// cluster is 3K float4 pieces, copied by cp.async (16 bytes a thread) into
// one buffer of a two-buffer ring; every thread of a CTA then reads the same
// triangle at the same time (three broadcast 16-byte shared loads).  Cull
// boxes (C, 8) f32 [lo xyz, hi xyz, f, 0] (cuda_intersect.cull_rows): two
// float4 pieces a cluster, staged after its rows in the same buffer and the
// same commit group.  A walk slab-tests each warp's rays against the box
// (needs_box) and runs the cluster's triangle tests only for a warp one of
// whose rays can still take a hit there (__any_sync).
//
// The pair test: o' = W (o, 1), d' = W3 d, t = -o'_z / d'_z by an exact
// IEEE divide, u = o'_x + t d'_x, v = o'_y + t d'_y, accept u >= 0 &&
// v >= 0 && 1 - u - v >= 0 && t >= t_min (NaN fails every compare).  An
// approximate reciprocal in front of it (rcp.approx.f32, the pair dropped
// only where a margin of 2^-16 |t d'_{x,y}| shows the exact test must
// refuse it, the rest rechecked exactly) was measured and is slower on the
// H100: the filter costs about as many instructions as the divide it
// skips, and a warp runs the exact path whenever one of its lanes passes
// (PERF.md §6).
//
// Built without --use_fast_math: t needs an exact divide, and denormals
// must not be flushed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dxrt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Start copying one cluster's 3K float4 pieces into dst; one commit group.
__device__ __forceinline__ void stage_cluster(float4* dst, const float4* src,
                                              int pieces) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int e = threadIdx.x; e < pieces; e += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * static_cast<uint32_t>(e)),
                 "l"(src + e)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies; a block barrier must follow before any
// thread reads what another copied.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying one cluster's cull box (two float4 pieces) beside its
// rows; the next stage_cluster commits it.
__device__ __forceinline__ void stage_box(float4* dst, const float4* src) {
  if (threadIdx.x < 2) {
    const uint32_t d = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + threadIdx.x));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + threadIdx.x)
                 : "memory");
  }
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* origins,
                                        const float* dirs, size_t i) {
  return Ray{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
             dirs[3 * i],    dirs[3 * i + 1],    dirs[3 * i + 2]};
}

// Whether a ray can take a hit at t in [t_min, best] in the cluster of box
// `box`: its slab test against the box grown by f * |o|_inf.  A zero
// direction component gives an infinite reciprocal, so (l - o) * inv is
// +-inf or, for a ray in a face's plane, NaN; fmaxf/fminf drop a NaN,
// which keeps the ray (the plane lies in the closed box).  best = -inf
// never needs a cluster.
__device__ __forceinline__ bool needs_box(const float4* box, const Ray& r,
                                          float best, float t_min) {
  const float4 b0 = box[0], b1 = box[1];
  const float po =
      b1.z * fmaxf(fabsf(r.ox), fmaxf(fabsf(r.oy), fabsf(r.oz)));
  float entry = t_min, exit = best;
  const float lo[3] = {b0.x, b0.y, b0.z}, hi[3] = {b0.w, b1.x, b1.y};
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = __frcp_rn(d[a]);
    const float tl = (lo[a] - po - o[a]) * inv;
    const float th = (hi[a] + po - o[a]) * inv;
    const bool neg = signbit(d[a]);
    entry = fmaxf(entry, neg ? th : tl);
    exit = fminf(exit, neg ? tl : th);
  }
  return entry <= exit;
}

// The pair test of one ray against one triangle (rows a = u, b = v,
// c = z): whether it accepts, with its t in t_out.
__device__ __forceinline__ bool woop_test(const float4& a, const float4& b,
                                          const float4& c, const Ray& r,
                                          float t_min, float& t_out) {
  const float ozp = c.x * r.ox + c.y * r.oy + c.z * r.oz + c.w;
  const float dzp = c.x * r.dx + c.y * r.dy + c.z * r.dz;
  const float t = -ozp / dzp;
  const float u = (a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w) +
                  t * (a.x * r.dx + a.y * r.dy + a.z * r.dz);
  const float v = (b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w) +
                  t * (b.x * r.dx + b.y * r.dy + b.z * r.dz);
  t_out = t;
  return u >= 0.f && v >= 0.f && 1.f - u - v >= 0.f && t >= t_min;
}

}  // namespace dxrt
