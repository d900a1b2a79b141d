// bin_clusters: conservative slab test of every ray tile against every
// cluster AABB; bin_clusters_super: the same result, testing only the
// clusters of superblocks whose hull the tile overlaps.
//
// Replaces the TPU binning kernels _bin_kernel_body
// (directx_raytracer_tpu/bvh/pallas_intersect.py:307) and
// _bin_kernel_super_body (:367), math in _slab_block (:333-364).  Same
// arithmetic, op for op: per axis, the interval of the
// tile's origins [o_lo, o_hi] and directions [d_lo, d_hi] against the
// cluster slab gives four products clipped to +-BIG; entry is the max over
// axes of their min, exit the min of their max.  Then entry = max(entry,
// t_min), overlap = entry <= exit && exit >= t_min && valid && entry <=
// t_cap, and entry is divided by len_hi.  min/max propagate NaN, as
// torch.minimum/maximum (and jnp) do.
//
// Per-tile params (T, 16) f32: [o_lo xyz | o_hi xyz | d_lo xyz | d_hi xyz |
// len_hi | t_min | t_cap | pad].  Cluster rows (8, C) f32: [lo xyz | hi xyz
// | valid | pad]; superblock hull rows (8, S) f32 in the same layout, hull
// s covering clusters [s * block, (s + 1) * block).  Outputs: entry (T, C)
// f32 and overlap (T, C) u8.
//
// What bounds the dense kernel on the card: memory.  Each (tile, cluster) pair reads 7
// floats (L2/L1-resident: the cluster rows are 8*C floats, shared by every
// tile) and writes 5 bytes; the ~40 flops between are far below the
// H100's ratio of flops to HBM bytes.  So the design is one thread per
// pair with coalesced row reads and writes, and the tile's 16 params in
// shared memory, read once per block.  Tiles run on grid.x (no 65535 cap),
// cluster chunks of 256 on grid.y.
//
// The superblock kernel serves large scenes (C >= 2048: 1M triangles give
// 7,807 clusters), where most of a tile's (tile, cluster) pairs lie in
// superblocks it misses.  Its outputs are the same T x C bytes, so memory
// still bounds it; what it saves is the reads of the cluster rows and the
// slab math of skipped superblocks.  One CTA per tile: the 16 params and
// one flag per superblock hull in shared memory (S = C / 128 hull tests,
// done once per tile), then a block-stride loop over the clusters that
// runs the slab test only where the cluster's superblock flag is set and
// writes entry = BIG, overlap = 0 elsewhere.  Both kernels share one slab
// routine, so their overlaps and entries agree bit for bit.
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

// The slab test of one box (column c of the (8, n) rows) against the tile
// params p: entry (already divided by len_hi) and the overlap flag.
__device__ __forceinline__ void slab(const float* __restrict__ p,
                                     const float* __restrict__ rows, int n,
                                     int c, float* entry_out, bool* ovl_out) {
  float entry = -kBig;
  float exit_ = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float n_lo = rows[ax * n + c] - p[3 + ax];
    const float n_hi = rows[(3 + ax) * n + c] - p[ax];
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
  *ovl_out = (entry <= exit_) && (exit_ >= t_min) &&
             (rows[6 * n + c] > 0.5f) && (entry <= p[14]);
  *entry_out = entry / p[12];
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
  float entry;
  bool ovl;
  slab(p, cb, n_clusters, c, &entry, &ovl);
  const size_t out = static_cast<size_t>(tile) * n_clusters + c;
  entry_out[out] = entry;
  ovl_out[out] = ovl ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
bin_clusters_super_kernel(const float* __restrict__ tp,
                          const float* __restrict__ cb,
                          const float* __restrict__ sb,
                          float* __restrict__ entry_out,
                          uint8_t* __restrict__ ovl_out, int n_clusters,
                          int n_super, int block) {
  extern __shared__ uint8_t s_flag[];  // n_super hull flags
  __shared__ float p[16];
  const int tile = blockIdx.x;
  if (threadIdx.x < 16) p[threadIdx.x] = tp[tile * 16 + threadIdx.x];
  __syncthreads();
  for (int s = threadIdx.x; s < n_super; s += kThreads) {
    float e;
    bool o;
    slab(p, sb, n_super, s, &e, &o);
    s_flag[s] = o ? 1 : 0;
  }
  __syncthreads();
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  for (int c = threadIdx.x; c < n_clusters; c += kThreads) {
    float entry = kBig;
    bool ovl = false;
    if (s_flag[c / block]) slab(p, cb, n_clusters, c, &entry, &ovl);
    entry_out[row + c] = entry;
    ovl_out[row + c] = ovl ? 1 : 0;
  }
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

// sb must hold n_super = ceil(n_clusters / block) hull columns.
extern "C" int dxrt_bin_clusters_super(const float* tp, const float* cb,
                                       const float* sb, float* entry,
                                       uint8_t* ovl, int n_tiles,
                                       int n_clusters, int n_super, int block,
                                       cudaStream_t stream) {
  if (block < 1 || n_super != (n_clusters + block - 1) / block)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_super);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_clusters_super_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_clusters_super_kernel<<<n_tiles, kThreads, smem, stream>>>(
      tp, cb, sb, entry, ovl, n_clusters, n_super, block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dxrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
