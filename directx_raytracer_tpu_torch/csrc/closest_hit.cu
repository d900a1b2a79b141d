// closest_hit: the closest triangle of every ray, walking its tile's
// near-to-far cluster list.
//
// Replaces the TPU closest-hit kernel _make_kernel
// (directx_raytracer_tpu/bvh/pallas_intersect.py:762-894, launched by
// _launch :924 from _search :1318).  What it computes is the same: each ray
// starts from its seed best t; a tile visits its binned clusters in order of
// conservative entry distance and stops once the next entry exceeds the
// largest best t over the tile; each visit tests the cluster's K triangles
// through their Woop transforms, o' = W (o, 1), d' = W3 d, t = -o'_z / d'_z,
// u = o'_x + t d'_x, v = o'_y + t d'_y, accepting min(u, v, 1-u-v) >= 0 and
// t >= t_min, and keeps (best t, best slot).  Differences from the TPU
// kernel, all because the card does not need them: f32 FMA instead of a
// bf16x3 split matmul, an exact IEEE divide, (t, slot) held in registers
// instead of packed into one int, and a CTA that walks its own ragged list
// instead of a fixed-budget visit grid.  Ties in t go to the lower slot, so
// the result does not depend on visit order.
//
// Layout: rays (N, 3) f32 origins/dirs and (N,) seeds, tile-major, N = T *
// tile_r.  Woop rows (C, 12, K) f32: row 4*a + j holds W[a][j] of each of
// the K triangles.  Visit list (T, L) i32 cluster ids sorted by entry, with
// entries (T, L) f32 and per-tile counts (T,) i32.
//
// What bounds it on the card: arithmetic.  A visit reads 6 KB of Woop rows
// (L2-resident, the 100k-triangle scene's rows are ~4.8 MB) and then spends
// ~30 FMAs and an IEEE divide on each of tile_r x K (ray, triangle) pairs.
// So: one CTA of 256 threads per tile, each thread owning up to 3 rays in
// registers (768-ray tiles); the cluster's rows are staged in shared memory
// once per visit and read by broadcast (every thread reads the same
// triangle at the same time, so there are no bank conflicts); the per-visit
// cost outside the pair loop is one block-wide max and two barriers.
//
// Built without --use_fast_math: t needs an exact divide, and denormals
// must not be flushed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kRaysPerThread>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const float* __restrict__ init_t,
                   const float* __restrict__ wrows,
                   const int* __restrict__ visit,
                   const float* __restrict__ ventry,
                   const int* __restrict__ counts,
                   float* __restrict__ best_t_out,
                   int* __restrict__ best_slot_out, int tile_r, int list_len,
                   int k, float t_min) {
  extern __shared__ float s_w[];  // 12 * k floats: the staged cluster
  __shared__ float s_max[kWarps];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;

  float ox[kRaysPerThread], oy[kRaysPerThread], oz[kRaysPerThread];
  float dx[kRaysPerThread], dy[kRaysPerThread], dz[kRaysPerThread];
  float bt[kRaysPerThread];
  int bs[kRaysPerThread];
#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j) {
    const int r = tid + j * kThreads;
    const bool live = r < tile_r;
    const size_t ray = static_cast<size_t>(tile) * tile_r + (live ? r : 0);
    ox[j] = origins[3 * ray];
    oy[j] = origins[3 * ray + 1];
    oz[j] = origins[3 * ray + 2];
    dx[j] = dirs[3 * ray];
    dy[j] = dirs[3 * ray + 1];
    dz[j] = dirs[3 * ray + 2];
    // A lane past the tile holds -inf: it never wins and never raises the
    // tile's max.
    bt[j] = live ? init_t[ray] : -INFINITY;
    bs[j] = -1;
  }

  const int count = counts[tile];
  const int* vlist = visit + static_cast<size_t>(tile) * list_len;
  const float* elist = ventry + static_cast<size_t>(tile) * list_len;
  for (int i = 0; i < count; ++i) {
    float m = bt[0];
#pragma unroll
    for (int j = 1; j < kRaysPerThread; ++j) m = fmaxf(m, bt[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) s_max[tid >> 5] = m;

    const int cluster = vlist[i];
    const float* w = wrows + static_cast<size_t>(cluster) * 12 * k;
    for (int e = tid; e < 12 * k; e += kThreads) s_w[e] = w[e];
    __syncthreads();

    float tile_max = s_max[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) tile_max = fmaxf(tile_max, s_max[q]);
    // Every thread reads the same two values: the break is block-uniform.
    if (elist[i] > tile_max) break;

    const int slot0 = cluster * k;
    for (int kk = 0; kk < k; ++kk) {
      const float w0 = s_w[kk], w1 = s_w[k + kk], w2 = s_w[2 * k + kk],
                  w3 = s_w[3 * k + kk];
      const float w4 = s_w[4 * k + kk], w5 = s_w[5 * k + kk],
                  w6 = s_w[6 * k + kk], w7 = s_w[7 * k + kk];
      const float w8 = s_w[8 * k + kk], w9 = s_w[9 * k + kk],
                  w10 = s_w[10 * k + kk], w11 = s_w[11 * k + kk];
      const int slot = slot0 + kk;
#pragma unroll
      for (int j = 0; j < kRaysPerThread; ++j) {
        const float ozp = w8 * ox[j] + w9 * oy[j] + w10 * oz[j] + w11;
        const float dzp = w8 * dx[j] + w9 * dy[j] + w10 * dz[j];
        const float t = -ozp / dzp;
        const float u = (w0 * ox[j] + w1 * oy[j] + w2 * oz[j] + w3) +
                        t * (w0 * dx[j] + w1 * dy[j] + w2 * dz[j]);
        const float v = (w4 * ox[j] + w5 * oy[j] + w6 * oz[j] + w7) +
                        t * (w4 * dx[j] + w5 * dy[j] + w6 * dz[j]);
        // NaN t or barycentrics fail every compare.
        const bool accept = u >= 0.f && v >= 0.f && 1.f - u - v >= 0.f &&
                            t >= t_min &&
                            (t < bt[j] || (t == bt[j] && slot < bs[j]));
        if (accept) {
          bt[j] = t;
          bs[j] = slot;
        }
      }
    }
    __syncthreads();  // s_w and s_max are rewritten by the next visit
  }

#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j) {
    const int r = tid + j * kThreads;
    if (r < tile_r) {
      const size_t ray = static_cast<size_t>(tile) * tile_r + r;
      best_t_out[ray] = bt[j];
      best_slot_out[ray] = bs[j];
    }
  }
}

template <int kRaysPerThread>
void launch(const float* origins, const float* dirs, const float* init_t,
            const float* wrows, const int* visit, const float* ventry,
            const int* counts, float* best_t, int* best_slot, int n_tiles,
            int tile_r, int list_len, int k, float t_min,
            cudaStream_t stream) {
  const size_t smem = sizeof(float) * 12 * k;
  closest_hit_kernel<kRaysPerThread><<<n_tiles, kThreads, smem, stream>>>(
      origins, dirs, init_t, wrows, visit, ventry, counts, best_t, best_slot,
      tile_r, list_len, k, t_min);
}

}  // namespace

// tile_r must lie in [1, 768]: a thread owns at most 3 rays.
extern "C" int dxrt_closest_hit(const float* origins, const float* dirs,
                                const float* init_t, const float* wrows,
                                const int* visit, const float* ventry,
                                const int* counts, float* best_t,
                                int* best_slot, int n_tiles, int tile_r,
                                int list_len, int k, float t_min,
                                cudaStream_t stream) {
  switch ((tile_r + kThreads - 1) / kThreads) {
    case 1:
      launch<1>(origins, dirs, init_t, wrows, visit, ventry, counts, best_t,
                best_slot, n_tiles, tile_r, list_len, k, t_min, stream);
      break;
    case 2:
      launch<2>(origins, dirs, init_t, wrows, visit, ventry, counts, best_t,
                best_slot, n_tiles, tile_r, list_len, k, t_min, stream);
      break;
    case 3:
      launch<3>(origins, dirs, init_t, wrows, visit, ventry, counts, best_t,
                best_slot, n_tiles, tile_r, list_len, k, t_min, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
