// any_hit: whether some triangle lies in [t_min, t_max) along each shadow
// ray, walking its tile's near-to-far cluster list.
//
// Replaces the TPU any-hit kernel _make_anyhit_kernel
// (directx_raytracer_tpu/bvh/pallas_intersect.py:1001-1071, launched by
// _launch_anyhit :1109 from _search_anyhit :1159).  What it computes is the
// same: each ray carries a blocked flag; a tile visits its binned clusters
// in order of conservative entry distance and stops once the next entry
// exceeds its gate, the largest t_max over its still-UNBLOCKED rays
// (-BIG once every ray is blocked, so the tile then stops at once); each
// visit tests the cluster's K triangles through their Woop transforms,
// o' = W (o, 1), d' = W3 d, t = -o'_z / d'_z, u = o'_x + t d'_x,
// v = o'_y + t d'_y, and blocks a ray on the first triangle with
// min(u, v, 1-u-v) >= 0 and t_min <= t < t_max.  Rays with t_max <= t_min
// are never blocked.  Differences from the TPU kernel, all because the card
// does not need them: f32 FMA instead of a bf16x3 split matmul, and CTAs
// that walk chunks of each tile's ragged list instead of a fixed-budget
// visit grid.  The
// divide is exact IEEE, never an approximate reciprocal: the JAX package's
// default bary6r scheme feeds occlusion verdicts from an approximate
// reciprocal with no exact recheck, which this kernel does not copy.
//
// Layout: rays (N, 3) f32 origins/dirs and (N,) t_max, tile-major,
// N = T * tile_r.  Woop rows (C, 12, K) f32: row 4*a + j holds W[a][j] of
// each of the K triangles.  Visit list (T, L) i32 cluster ids sorted by
// entry, with entries (T, L) f32 and per-tile counts (T,) i32; work items
// (W,) i32 tile ids and first list positions.  Output: blocked (N,) u8,
// zeroed by the caller.
//
// What bounds it on the card: load balance, then arithmetic.  A visit
// reads 6 KB of L2-resident Woop rows and spends ~25 FMAs and an IEEE
// divide per (ray, triangle) pair; most shadow tiles visit a few clusters
// or none (fully disarmed tiles bin nothing), but a few dozen tiles of a
// Morton-sorted 1080p shadow batch bin hundreds (a Z-curve jump inside a
// tile widens its box).  Walked by one CTA, such a list takes ~28 us a
// visit while the rest of the card idles.  Occlusion is an OR over
// clusters, so each tile's list is cut into work items of `chunk`
// positions, one CTA each, all in parallel; a CTA ORs its rays' flags
// into the output (plain stores of 1 into a zeroed array: every writer
// writes the same value).  Within a CTA: 256 threads, one ray per thread
// in registers; the cluster's rows staged in shared memory once per visit
// and read by broadcast; a blocked thread (or a lane past the tile) skips
// the pair loop, and a ray leaves it at its first accepted triangle; the
// per-visit cost outside the pair loop is one block-wide max and two
// barriers.  The early-out gate is per work item (its own blocked flags),
// so a later item of a tile may redo work an earlier one made moot, never
// the other way round.
//
// Built without --use_fast_math: t needs an exact divide, and denormals
// must not be flushed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ origins,
               const float* __restrict__ dirs,
               const float* __restrict__ t_max,
               const float* __restrict__ wrows,
               const int* __restrict__ visit,
               const float* __restrict__ ventry,
               const int* __restrict__ counts,
               const int* __restrict__ work_tile,
               const int* __restrict__ work_start,
               uint8_t* __restrict__ blocked_out, int tile_r, int list_len,
               int k, float t_min, int chunk) {
  extern __shared__ float s_w[];  // 12 * k floats: the staged cluster
  __shared__ float s_gate[kWarps];
  const int tile = work_tile[blockIdx.x];
  const int start = work_start[blockIdx.x];
  const int tid = threadIdx.x;
  const bool live = tid < tile_r;
  const size_t ray = static_cast<size_t>(tile) * tile_r + (live ? tid : 0);
  const float ox = origins[3 * ray], oy = origins[3 * ray + 1],
              oz = origins[3 * ray + 2];
  const float dx = dirs[3 * ray], dy = dirs[3 * ray + 1],
              dz = dirs[3 * ray + 2];
  const float tm = t_max[ray];
  // A lane past the tile counts as blocked: it never raises the gate.
  bool blocked = !live;

  const int end = min(start + chunk, counts[tile]);
  const int* vlist = visit + static_cast<size_t>(tile) * list_len;
  const float* elist = ventry + static_cast<size_t>(tile) * list_len;
  for (int i = start; i < end; ++i) {
    float g = blocked ? -kBig : tm;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, off));
    if ((tid & 31) == 0) s_gate[tid >> 5] = g;

    const int cluster = vlist[i];
    const float* w = wrows + static_cast<size_t>(cluster) * 12 * k;
    for (int e = tid; e < 12 * k; e += kThreads) s_w[e] = w[e];
    __syncthreads();

    float gate = s_gate[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) gate = fmaxf(gate, s_gate[q]);
    // Every thread reads the same two values: the break is block-uniform.
    if (elist[i] > gate) break;

    if (!blocked) {
      for (int kk = 0; kk < k; ++kk) {
        const float w0 = s_w[kk], w1 = s_w[k + kk], w2 = s_w[2 * k + kk],
                    w3 = s_w[3 * k + kk];
        const float w4 = s_w[4 * k + kk], w5 = s_w[5 * k + kk],
                    w6 = s_w[6 * k + kk], w7 = s_w[7 * k + kk];
        const float w8 = s_w[8 * k + kk], w9 = s_w[9 * k + kk],
                    w10 = s_w[10 * k + kk], w11 = s_w[11 * k + kk];
        const float ozp = w8 * ox + w9 * oy + w10 * oz + w11;
        const float dzp = w8 * dx + w9 * dy + w10 * dz;
        const float t = -ozp / dzp;
        const float u = (w0 * ox + w1 * oy + w2 * oz + w3) +
                        t * (w0 * dx + w1 * dy + w2 * dz);
        const float v = (w4 * ox + w5 * oy + w6 * oz + w7) +
                        t * (w4 * dx + w5 * dy + w6 * dz);
        // NaN t or barycentrics fail every compare.
        if (u >= 0.f && v >= 0.f && 1.f - u - v >= 0.f && t >= t_min &&
            t < tm) {
          blocked = true;
          break;
        }
      }
    }
    __syncthreads();  // s_w and s_gate are rewritten by the next visit
  }

  if (live && blocked) blocked_out[ray] = 1;
}

}  // namespace

// tile_r must lie in [1, 256]: a thread owns one ray.  One CTA per work
// item.
extern "C" int dxrt_any_hit(const float* origins, const float* dirs,
                            const float* t_max, const float* wrows,
                            const int* visit, const float* ventry,
                            const int* counts, const int* work_tile,
                            const int* work_start, uint8_t* blocked,
                            int n_items, int tile_r, int list_len, int k,
                            float t_min, int chunk, cudaStream_t stream) {
  if (tile_r < 1 || tile_r > kThreads || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 12 * k;
  any_hit_kernel<<<n_items, kThreads, smem, stream>>>(
      origins, dirs, t_max, wrows, visit, ventry, counts, work_tile,
      work_start, blocked, tile_r, list_len, k, t_min, chunk);
  return static_cast<int>(cudaGetLastError());
}
