// bin_lists: the fused binning kernel.  For each ray tile it slab-tests
// the cluster AABBs, compacts the clusters the tile overlaps and sorts them
// near to far: the tile's visit list, its count, and the largest count.
//
// Replaces the TPU binning kernels _bin_kernel_body
// (directx_raytracer_tpu/bvh/pallas_intersect.py:307, dense mode) and
// _bin_kernel_super_body (:367, superblock mode), math in _slab_block
// (:333-364), launched by _bin_pallas (:396, :423).  Those write entry and
// overlap for every (tile, cluster) pair; the lists are built from them
// afterwards.  Here no (T, C) array exists: each tile's list is built where
// its overlaps are found.
//
// The slab test is the plain version's (bin_clusters_plain), bit-equal to
// it on every output: per axis, the interval of the tile's origins [o_lo,
// o_hi] and directions [d_lo, d_hi] against the cluster slab gives four
// products clipped to +-BIG; entry is the max over axes of their min, exit
// the min of their max.  Then entry = max(entry, t_min), overlap = entry
// <= exit && exit >= t_min && valid && entry <= t_cap, and an overlapping
// entry is divided by len_hi.  min/max propagate NaN, as
// torch.minimum/maximum (and jnp) do (here by the min.NaN/max.NaN
// instructions), and the clip is applied once to each axis's min and max
// of the four products (clipping is monotone).
// The per-axis reciprocals (1 / d_hi, 1 / d_lo where the span keeps its
// sign, -+BIG where it does not) are tile constants, computed once per tile
// with the same IEEE divides, so the results are bit-equal to a per-pair
// evaluation.
//
// Layout.  Tile params (T, 16) f32: [o_lo xyz | o_hi xyz | d_lo xyz | d_hi
// xyz | len_hi | t_min | t_cap | pad].  Cluster rows (8, C) f32: [lo xyz |
// hi xyz | valid | pad]; superblock hull rows (8, S) f32 in the same
// layout, hull s covering clusters [s * block, (s + 1) * block).  Outputs:
// visit (T, cap) i32 cluster ids and ventry (T, cap) f32 entries, of which
// row t holds its first counts[t] positions (the rest is never written),
// near to far, ties to the lower cluster id; meta (T + 1,) i32 = counts
// (T,) and the largest count (zeroed by the launcher).  t_min must be > 0,
// so that every listed entry is positive and its bits order as the float
// does.
//
// Design.  One CTA of 256 threads per tile.  (A persistent grid, as many
// CTAs as fit on the card each taking every grid-th tile, was measured
// slower at every batch.)
// 1. Each thread loads the tile's 16 params (broadcast loads); lanes 0-2
//    of each warp divide out the 6 reciprocals and shuffle them to the
//    rest: no shared staging and no barrier.
// 2. Threads stride over the clusters (coalesced reads of the (8, C) rows,
//    which stay in L1/L2, shared by every tile).  In superblock mode the
//    CTA first tests the S hulls and lists the overlapping superblocks in
//    shared memory, then tests only their clusters, `block` consecutive
//    clusters per superblock: a skipped superblock costs nothing.
// 3. Compaction: each overlapping cluster becomes the key (bits(entry) <<
//    32) | cluster; a warp ballot, one shared atomicAdd per warp and a
//    popcount place it in a shared buffer of kSharedKeys keys.  Positions
//    past it go straight to the tile's output rows.
// 4. The sort: ascending keys are the near-to-far order with ties to the
//    lower id, exactly a stable sort of the masked entries.  Up to 32 keys
//    warp 0 sorts them in registers (a bitonic network over shuffles); up
//    to kSharedKeys a bitonic network runs over shared memory, on the count
//    rounded up to a power of two (positions past the count act as +inf
//    and never move, so their compare-exchanges are skipped); beyond it the
//    same network runs over the tile's output rows in global memory (no
//    cluster is ever dropped, whatever the scene size).
// 5. Thread 0 writes the count and atomicMax-es the largest count: reading
//    it is the query's one host sync.
// One warp per tile (8 tiles a CTA, no barriers) was measured too: slower
// wherever a batch has few tiles (2,700 tiles fill 338 CTAs, each warp
// walks 25 steps serially, and lists over 32 wait for the block's sorts).
//
// What bounds it on the card: instruction issue.  The bytes are few (the
// params, the L1/L2-resident rows, the lists written: 2.7 MB at the
// 32,400-tile shadow batch); the slab tests are ~60 f32 instructions a
// pair, T x C pairs in dense mode, and a tile adds its prologue, its
// barriers and its sort.  Measured on the H100 (PERF.md §6): 0.16 ms for
// that batch's 25.1M pairs, 7-14% of the operations bound counted at the
// f32 FMA peak (which min/max and multiplies cannot reach).  The select
// form of the NaN-propagating min/max (compares and selects, ~200
// instructions a pair) took twice as long.
//
// Built without --use_fast_math: the divides must be IEEE, as in the plain
// version, and denormals must survive.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;  // 2048 threads: the SM's limit
constexpr float kBig = 1e30f;
constexpr int kSharedKeys = 2048;  // keys a tile sorts in shared memory

typedef unsigned long long u64;

// NaN-propagating min/max (torch.minimum / torch.maximum semantics), one
// instruction each (sm_80 and later).  Against the select form (a < b ||
// a != a) ? a : b they may differ only in a NaN's payload and a zero's
// sign, and neither reaches an output: a NaN entry or exit fails every
// overlap compare, and zeros compare equal and lie below t_min.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clip_big(float x) {
  return nan_min(nan_max(x, -kBig), kBig);
}

// One tile's slab operands, in registers.
struct TileSlab {
  float o_lo[3], o_hi[3], i_lo[3], i_hi[3];
  float len_hi, t_min, t_cap;
};

// Every thread loads its tile's row (one broadcast load per value); the
// reciprocals of axis a are divided out by lane a of each warp (lanes
// 3 and up repeat an axis: two divides a lane, not six) and shuffled to
// the rest.  No shared staging, no barrier; every lane must call it.
__device__ __forceinline__ TileSlab load_tile(const float* __restrict__ row) {
  TileSlab p;
  const int mine = (threadIdx.x & 31) % 3;
  const float d_lo = __ldg(row + 6 + mine), d_hi = __ldg(row + 9 + mine);
  const bool same = (d_lo > 0.f) || (d_hi < 0.f);
  const float i_lo = same ? 1.0f / d_hi : -kBig;
  const float i_hi = same ? 1.0f / d_lo : kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    p.o_lo[ax] = __ldg(row + ax);
    p.o_hi[ax] = __ldg(row + 3 + ax);
    p.i_lo[ax] = __shfl_sync(0xffffffffu, i_lo, ax);
    p.i_hi[ax] = __shfl_sync(0xffffffffu, i_hi, ax);
  }
  p.len_hi = __ldg(row + 12);
  p.t_min = __ldg(row + 13);
  p.t_cap = __ldg(row + 14);
  return p;
}

// The slab test of box c of the (8, n) rows: whether the tile overlaps it,
// with its entry (before the divide by len_hi) in entry_out.
__device__ __forceinline__ bool slab(const TileSlab& p,
                                     const float* __restrict__ rows, int n,
                                     int c, float* entry_out) {
  float entry = -kBig;
  float exit_ = kBig;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float n_lo = __ldg(rows + ax * n + c) - p.o_hi[ax];
    const float n_hi = __ldg(rows + (3 + ax) * n + c) - p.o_lo[ax];
    const float a = n_lo * p.i_lo[ax], b = n_lo * p.i_hi[ax];
    const float cc = n_hi * p.i_lo[ax], d2 = n_hi * p.i_hi[ax];
    // Clipping is monotone, so clipping the min (max) of the four products
    // equals the min (max) of the clipped products: 2 clips, not 4.
    entry = nan_max(entry,
                    clip_big(nan_min(nan_min(a, b), nan_min(cc, d2))));
    exit_ = nan_min(exit_,
                    clip_big(nan_max(nan_max(a, b), nan_max(cc, d2))));
  }
  entry = nan_max(entry, p.t_min);
  *entry_out = entry;
  return (entry <= exit_) && (exit_ >= p.t_min) &&
         (__ldg(rows + 6 * n + c) > 0.5f) && (entry <= p.t_cap);
}

__device__ __forceinline__ u64 make_key(float entry, int id) {
  return (static_cast<u64>(__float_as_uint(entry)) << 32) |
         static_cast<uint32_t>(id);
}

// Warp-uniform compaction slot: every lane of the warp calls it; a lane
// with `take` gets its position, counted from *s_n (one atomicAdd a warp).
__device__ __forceinline__ int warp_slot(bool take, int* s_n) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (mask == 0) return -1;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(s_n, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  return take ? base + __popc(mask & ((1u << lane) - 1u)) : -1;
}

// Keys in shared memory, or split over a tile's two output rows.
struct SharedKeys {
  u64* k;
  __device__ u64 get(int i) const { return k[i]; }
  __device__ void put(int i, u64 v) const { k[i] = v; }
};

struct RowKeys {
  int* vis;
  float* ent;
  __device__ u64 get(int i) const { return make_key(ent[i], vis[i]); }
  __device__ void put(int i, u64 v) const {
    ent[i] = __uint_as_float(static_cast<uint32_t>(v >> 32));
    vis[i] = static_cast<int>(static_cast<uint32_t>(v));
  }
};

// Ascending bitonic network over n keys, n rounded up to a power of two
// (the "flip" form: every compare-exchange puts the smaller key at the
// lower position).  Positions >= n act as +inf and never move, so pairs
// reaching them are skipped.  Every thread of the block calls it.
template <class Keys>
__device__ void bitonic_sort(const Keys& keys, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (size >> 1); q += kThreads) {
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int hi = (j == (k >> 1)) ? (lo ^ (k - 1)) : (lo | j);
        if (hi < n) {
          const u64 a = keys.get(lo), b = keys.get(hi);
          if (b < a) {
            keys.put(lo, b);
            keys.put(hi, a);
          }
        }
      }
      __syncthreads();
    }
  }
}

// The same network over one key per lane of a warp (32 keys).
__device__ __forceinline__ u64 warp_sort(u64 key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int partner = (j == (k >> 1)) ? (lane ^ (k - 1)) : (lane ^ j);
      const u64 other = __shfl_sync(0xffffffffu, key, partner);
      const bool keep_min = lane < partner;
      key = (keep_min == (other < key)) ? other : key;
    }
  }
  return key;
}

template <bool kSuper>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bin_lists_kernel(const float* __restrict__ tp, const float* __restrict__ cb,
                 const float* __restrict__ sb, int* visit, float* ventry,
                 int* meta, int n_tiles, int n_clusters, int n_super,
                 int block, int cap) {
  __shared__ u64 s_keys[kSharedKeys];
  __shared__ int s_n, s_ns;
  extern __shared__ int s_super[];  // overlapping superblocks (kSuper)
  const int tid = threadIdx.x;
  int* const counts = meta;
  int* const max_count = meta + n_tiles;

  const int tile = blockIdx.x;
  if (tid == 0) {
    s_n = 0;
    s_ns = 0;
  }
  __syncthreads();
  const TileSlab p = load_tile(tp + static_cast<size_t>(tile) * 16);
  int* const vis_row = visit + static_cast<size_t>(tile) * cap;
  float* const ent_row = ventry + static_cast<size_t>(tile) * cap;

  // Test cluster c (c >= n_clusters: no cluster) and place its key.
  auto push = [&](int c) {
    float entry = 0.f;
    const bool ovl = c < n_clusters && slab(p, cb, n_clusters, c, &entry);
    const int pos = warp_slot(ovl, &s_n);
    if (pos < 0) return;
    entry = entry / p.len_hi;
    if (pos < kSharedKeys) {
      s_keys[pos] = make_key(entry, c);
    } else {
      ent_row[pos] = entry;
      vis_row[pos] = c;
    }
  };

  if (kSuper) {
    for (int base = 0; base < n_super; base += kThreads) {
      const int s = base + tid;
      float unused;
      const bool ovl = s < n_super && slab(p, sb, n_super, s, &unused);
      const int pos = warp_slot(ovl, &s_ns);
      if (pos >= 0) s_super[pos] = s;
    }
    __syncthreads();
    const int total = s_ns * block;
    for (int base = 0; base < total; base += kThreads) {
      const int i = base + tid;
      push(i < total ? s_super[i / block] * block + i % block : n_clusters);
    }
  } else {
    for (int base = 0; base < n_clusters; base += kThreads) push(base + tid);
  }
  __syncthreads();

  const int n = s_n;
  if (tid == 0) {
    counts[tile] = n;
    if (n > 0) atomicMax(max_count, n);
  }
  const RowKeys row{vis_row, ent_row};
  if (n <= 32) {
    if (tid < 32) {
      u64 key = tid < n ? s_keys[tid] : ~0ull;
      if (n > 1) key = warp_sort(key);
      if (tid < n) row.put(tid, key);
    }
  } else if (n <= kSharedKeys) {
    bitonic_sort(SharedKeys{s_keys}, n);
    for (int i = tid; i < n; i += kThreads) row.put(i, s_keys[i]);
  } else {
    for (int i = tid; i < kSharedKeys; i += kThreads) row.put(i, s_keys[i]);
    __syncthreads();
    bitonic_sort(row, n);
  }
}

}  // namespace

// sb == nullptr: dense mode; else superblock mode, sb holding n_super =
// ceil(n_clusters / block) hull columns.  cap (the output row stride) must
// be >= n_clusters.  One CTA per tile.
extern "C" int dxrt_bin_lists(const float* tp, const float* cb,
                              const float* sb, int* visit, float* ventry,
                              int* meta, int n_tiles, int n_clusters,
                              int n_super, int block, int cap,
                              cudaStream_t stream) {
  if (n_tiles < 1 || n_clusters < 1 || cap < n_clusters)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sb && (block < 1 || n_super != (n_clusters + block - 1) / block))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(meta + n_tiles, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = sb ? bin_lists_kernel<true> : bin_lists_kernel<false>;
  const size_t smem = sb ? sizeof(int) * static_cast<size_t>(n_super) : 0;
  if (smem > 16 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_tiles, kThreads, smem, stream>>>(tp, cb, sb, visit, ventry,
                                              meta, n_tiles, n_clusters,
                                              n_super, block, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dxrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
