// bin_clusters: conservative slab test of every ray tile against every
// cluster AABB.
//
// Replaces the TPU binning kernel _bin_kernel_body
// (directx_raytracer_tpu/bvh/pallas_intersect.py:307, math in _slab_block
// :333-364).  Same arithmetic, op for op: per axis, the interval of the
// tile's origins [o_lo, o_hi] and directions [d_lo, d_hi] against the
// cluster slab gives four products clipped to +-BIG; entry is the max over
// axes of their min, exit the min of their max.  Then entry = max(entry,
// t_min), overlap = entry <= exit && exit >= t_min && valid && entry <=
// t_cap, and entry is divided by len_hi.  min/max propagate NaN, as
// torch.minimum/maximum (and jnp) do.
//
// Per-tile params (T, 16) f32: [o_lo xyz | o_hi xyz | d_lo xyz | d_hi xyz |
// len_hi | t_min | t_cap | pad].  Cluster rows (8, C) f32: [lo xyz | hi xyz
// | valid | pad].  Outputs: entry (T, C) f32 and overlap (T, C) u8.
//
// What bounds it on the card: memory.  Each (tile, cluster) pair reads 7
// floats (L2/L1-resident: the cluster rows are 8*C floats, shared by every
// tile) and writes 5 bytes; the ~40 flops between are far below the
// H100's ratio of flops to HBM bytes.  So the design is one thread per
// pair with coalesced row reads and writes, and the tile's 16 params in
// shared memory, read once per block.  Tiles run on grid.x (no 65535 cap),
// cluster chunks of 256 on grid.y.
//
// Built without --use_fast_math: the divides must be IEEE, as in the plain
// version, and denormals must survive.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

// NaN-propagating min/max (torch.minimum / torch.maximum semantics).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float clip_big(float x) {
  return nan_min(nan_max(x, -kBig), kBig);
}

__global__ void __launch_bounds__(kThreads)
bin_clusters_kernel(const float* __restrict__ tp, const float* __restrict__ cb,
                    float* __restrict__ entry_out,
                    uint8_t* __restrict__ ovl_out, int n_clusters) {
  __shared__ float p[16];
  const int tile = blockIdx.x;
  if (threadIdx.x < 16) p[threadIdx.x] = tp[tile * 16 + threadIdx.x];
  __syncthreads();
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= n_clusters) return;

  float entry = -kBig;
  float exit_ = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float n_lo = cb[ax * n_clusters + c] - p[3 + ax];
    const float n_hi = cb[(3 + ax) * n_clusters + c] - p[ax];
    const float d_lo = p[6 + ax];
    const float d_hi = p[9 + ax];
    const bool same = (d_lo > 0.f) || (d_hi < 0.f);
    const float i_lo = same ? 1.0f / d_hi : -kBig;
    const float i_hi = same ? 1.0f / d_lo : kBig;
    const float a = clip_big(n_lo * i_lo);
    const float b = clip_big(n_lo * i_hi);
    const float cc = clip_big(n_hi * i_lo);
    const float d2 = clip_big(n_hi * i_hi);
    entry = nan_max(entry, nan_min(nan_min(a, b), nan_min(cc, d2)));
    exit_ = nan_min(exit_, nan_max(nan_max(a, b), nan_max(cc, d2)));
  }
  const float t_min = p[13];
  entry = nan_max(entry, t_min);
  const bool ovl = (entry <= exit_) && (exit_ >= t_min) &&
                   (cb[6 * n_clusters + c] > 0.5f) && (entry <= p[14]);
  const size_t out = static_cast<size_t>(tile) * n_clusters + c;
  entry_out[out] = entry / p[12];
  ovl_out[out] = ovl ? 1 : 0;
}

}  // namespace

extern "C" int dxrt_bin_clusters(const float* tp, const float* cb,
                                 float* entry, uint8_t* ovl, int n_tiles,
                                 int n_clusters, cudaStream_t stream) {
  const dim3 grid(n_tiles, (n_clusters + kThreads - 1) / kThreads);
  bin_clusters_kernel<<<grid, kThreads, 0, stream>>>(tp, cb, entry, ovl,
                                                     n_clusters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dxrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
