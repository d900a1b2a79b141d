// closest_hit: the closest triangle of every ray, walking its tile's
// near-to-far cluster list in work items that run in parallel and merge
// through a packed-key atomicMin.
//
// Replaces the TPU closest-hit kernel _make_kernel
// (directx_raytracer_tpu/bvh/pallas_intersect.py:762-894, launched by
// _launch :924 from _search :1318).  What it computes is the same: each ray
// starts from its seed best t; a tile visits its binned clusters in order of
// conservative entry distance and stops once the next entry exceeds the
// largest best t over the tile; each visit tests the cluster's K triangles
// through their Woop transforms (walk.cuh: t = -o'_z / d'_z by an exact
// IEEE divide, accept u, v, 1-u-v >= 0 and t >= t_min), and keeps the least
// (t, slot), ties to the lower slot.  Differences from the TPU kernel, all
// because the card does not need them: f32 FMA instead of a bf16x3 split
// matmul, an exact divide, and parallel work items instead of a
// fixed-budget visit grid.
//
// Layout: rays (N, 3) f32 origins/dirs, tile-major, N = T * tile_r; keys
// (N,) u64, seeded by the caller with (bits(init_t) << 32) | 0.  Woop rows
// (C, K, 12) f32 (walk.cuh); cull boxes (C, 8) f32 [lo xyz, hi xyz, f, 0]
// (cuda_intersect.cull_rows).  Visit list (T, L) i32 cluster ids sorted by
// entry, entries (T, L) f32, counts (T,) i32.  The schedule (order, offs):
// item q at depth j (offs[j] <= q < offs[j + 1]) is tile order[q -
// offs[j]].  Ray ownership: warp w, lane l holds tile rays w * 32 R + 32 j
// + l (R rays a thread, j < R), so a warp holds R * 32 consecutive rays:
// three 32-pixel rows of a 24 x 32 primary tile, 32 Morton-consecutive
// rays of a 256-ray bounce tile; each load of ray j is coalesced.
//
// What bounds it on the card.  Arithmetic, once the card is busy: a visit
// reads 6 KB of L2-resident rows and then spends ~45 f32 operations on
// each (ray, triangle) pair it tests.  Most pairs of a visit cannot hit:
// the tile's hull meets the cluster, but a ray passes its box only now and
// then.  So each warp first slab-tests its rays against the cluster's cull
// box (~40 operations a ray), up to the ray's best t (the lower of its own
// and its merged key), and runs the K tests of its j-th rays only if one
// of them needs the cluster (__any_sync: warp-uniform, nothing diverges in
// the loop); a warp none of whose rays needs it goes straight to the next
// barrier.  The box is the one the f32 Woop rows accept in, grown by a
// bound on the test's rounding (cull_rows), so a pair the test would
// accept at t <= best is never dropped: the results are those of testing
// every ray, bit for bit.  On the 1080p batches the cull skips 42% (100k
// primary), 51% (Whitted bounce), 61% (1M primary) and 90% (path-traced
// bounce: its tiles list most clusters, its rays need few) of the
// executed visits' 32-ray groups; the per-visit barrier, where a CTA waits
// for its slowest warp, and the staging now take a larger share.  A walk
// is serial, too, and a few tiles of a Morton-sorted bounce batch bin
// hundreds of clusters (one 1080p bounce tile bins 693): walked by one
// CTA, that tile held the launch open for ~12 ms while the card idled.
// So:
// * Work items.  Each list is cut into items of `chunk` positions (depth j
//   covers positions [j * chunk, (j + 1) * chunk)), numbered depth by
//   depth, tiles with the most items first within a depth.  CTA 0 builds
//   that numbering (a counting sort of the tiles by item count, in shared
//   memory) while the other CTAs wait on a flag, so the launch needs no
//   host sync and no torch ops; then a persistent grid (4 CTAs per SM)
//   takes the items in order from an atomic counter, so every tile's near
//   chunk is taken before any tile's next one.  (Scanning the (depth, tile)
//   index space in batches instead left one CTA walking every item of its
//   batch: 20x slower.)  A closest hit is a min over (t,
//   slot), so items merge exactly: each ray's result is the key
//   (bits(t) << 32) |
//   (slot + 1), and an item lowers it with one 64-bit atomicMin per ray it
//   improved.  t >= t_min > 0 and every seed is >= 0, so the bits of t
//   order as the floats do, and ties go to the lower slot whatever the
//   order of the items.  The seed's low word 0 refuses a hit at exactly
//   t = init_t, as the serial walk does.
// * The early-out gate of an item reads the tile's current keys (volatile
//   loads, issued one visit ahead) before each visit: keys only fall, so
//   the gate stays exact and tightens as the tile's near items finish.
// * The memory path: the next cluster's rows and cull box are copied by
//   cp.async into the other buffer of a two-buffer ring while this cluster
//   is tested; one block barrier per visit.  Rows are read as three
//   broadcast float4 loads per triangle, shared by the thread's rays, the
//   box as two.
// Within a CTA: 256 threads, each owning up to 3 rays (768-ray tiles) in
// registers, held to 64 registers so that 4 CTAs fit on an SM.
//
// The counting build (kCountExec, chosen at compile time: the production
// instantiation gains no instruction and no register) also writes, per
// tile, the list positions its items executed, i.e. passed the gate
// entry <= the tile's best t (the TPU kernel's count_exec build,
// pallas_intersect.py:788-795): one atomicAdd by thread 0 per item into
// executed (T,) i32, which the caller zeroes.  An item's gate is never
// tighter than the serial walk's at the same position, so per tile the
// plain walk's visits <= executed <= counts, equal with one item a tile.
// It also adds the 32-ray groups whose tests ran into tested (T,) i32 (one
// atomicAdd by lane 0 of each warp per item): at most executed x
// ceil(tile_r / 32).
//
// Built without --use_fast_math: t needs an exact divide, and denormals
// must not be flushed.

#include <algorithm>

#include "walk.cuh"

namespace {

using dxrt::kThreads;
using dxrt::kWarps;
using dxrt::Ray;

constexpr int kCtasPerSm = 4;

__device__ __forceinline__ float key_time(unsigned long long key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}

// Walk list positions [start, end) of one tile, merging into its keys (and
// with kCountExec adding the positions executed to executed[tile] and the
// 32-ray groups whose triangle loop ran to tested[tile]).
template <int kRaysPerThread, bool kCountExec>
__device__ __forceinline__ void walk_item(
    const float* origins, const float* dirs, const float4* wrows,
    const float4* crows, const int* vlist, const float* elist,
    unsigned long long* keys, int* executed, int* tested, float4* s_ring,
    float (*s_max)[kWarps], int tile, int start, int end, int tile_r, int k,
    float t_min) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // The ring buffer of one cluster: its 3k rows, then its two box pieces.
  const int pieces = 3 * k, stride = pieces + 2;
  // Warp w holds the tile's rays [w * 32 * R, (w + 1) * 32 * R), ray j of a
  // lane at r0 + 32 j: compact runs, so that a warp's rays tend to need
  // the same clusters.
  const int r0 = (tid >> 5) * 32 * kRaysPerThread + lane;
  volatile unsigned long long* tkeys = keys + static_cast<size_t>(tile) * tile_r;
  Ray ray[kRaysPerThread];
  float bt[kRaysPerThread], kt[kRaysPerThread];
  int bs[kRaysPerThread];
  bool improved[kRaysPerThread];
#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j) {
    const int r = r0 + 32 * j;
    const bool live = r < tile_r;
    ray[j] = dxrt::load_ray(origins, dirs,
                            static_cast<size_t>(tile) * tile_r + (live ? r : 0));
    // Start from the ray's merged key: the seed (slot -1, so a hit at
    // exactly init_t is refused) or a hit of another item.  A lane past
    // the tile holds -inf: it never wins and never raises the gate.
    const unsigned long long k0 = live ? tkeys[r] : 0ull;
    bt[j] = live ? key_time(k0) : -INFINITY;
    bs[j] = static_cast<int>(static_cast<uint32_t>(k0)) - 1;
    kt[j] = bt[j];
    improved[j] = false;
  }
  int n_tested = 0;

  // The box first: stage_cluster's commit group takes its copies too.
  dxrt::stage_box(s_ring + pieces,
                  crows + 2 * static_cast<size_t>(vlist[start]));
  dxrt::stage_cluster(s_ring, wrows + static_cast<size_t>(vlist[start]) * pieces,
                      pieces);
  int buf = 0;
  int i = start;
  for (; i < end; ++i, buf ^= 1) {
    // The gate: the largest best t over the tile's rays, each the lower of
    // this item's own and the tile's merged key.
    float m = fminf(bt[0], kt[0]);
#pragma unroll
    for (int j = 1; j < kRaysPerThread; ++j) m = fmaxf(m, fminf(bt[j], kt[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) s_max[buf][tid >> 5] = m;
    dxrt::wait_staged();
    // The one barrier of the visit: the staged rows and s_max are
    // complete, and every thread is done with the other ring buffer.
    __syncthreads();
    float gate = s_max[buf][0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) gate = fmaxf(gate, s_max[buf][q]);
    // Every thread reads the same values: the break is block-uniform.
    if (elist[i] > gate) break;
    if (i + 1 < end) {
      const int next = vlist[i + 1];
      float4* dst = s_ring + (buf ^ 1) * stride;
      dxrt::stage_box(dst + pieces, crows + 2 * static_cast<size_t>(next));
      dxrt::stage_cluster(dst, wrows + static_cast<size_t>(next) * pieces,
                          pieces);
    }
    const float4* w = s_ring + buf * stride;
    // The cull: ray j of the warp runs this cluster's tests iff one of the
    // warp's j-th rays can still take a hit in its box.  Warp-uniform, so
    // nothing diverges inside the loop.
    bool run[kRaysPerThread];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRaysPerThread; ++j) {
      run[j] = __any_sync(0xffffffffu,
                          dxrt::needs_box(w + pieces, ray[j],
                                          fminf(bt[j], kt[j]), t_min));
      any |= run[j];
      if constexpr (kCountExec) n_tested += run[j];
    }
    // The next gate's keys, loaded while this cluster is tested.
#pragma unroll
    for (int j = 0; j < kRaysPerThread; ++j)
      if (r0 + 32 * j < tile_r) kt[j] = key_time(tkeys[r0 + 32 * j]);
    if (!any) continue;

    const int slot0 = vlist[i] * k;
    for (int kk = 0; kk < k; ++kk) {
      const float4 a = w[3 * kk], b = w[3 * kk + 1], c = w[3 * kk + 2];
      const int slot = slot0 + kk;
#pragma unroll
      for (int j = 0; j < kRaysPerThread; ++j) {
        float t;
        if (run[j] && dxrt::woop_test(a, b, c, ray[j], t_min, t) &&
            (t < bt[j] || (t == bt[j] && slot < bs[j]))) {
          bt[j] = t;
          bs[j] = slot;
          improved[j] = true;
        }
      }
    }
  }
  // The break is block-uniform, so every thread holds the same i.
  if constexpr (kCountExec) {
    if (tid == 0 && i > start) atomicAdd(executed + tile, i - start);
    if (lane == 0 && n_tested > 0) atomicAdd(tested + tile, n_tested);
  }

#pragma unroll
  for (int j = 0; j < kRaysPerThread; ++j)
    if (improved[j])
      atomicMin(const_cast<unsigned long long*>(tkeys + r0 + 32 * j),
                (static_cast<unsigned long long>(__float_as_uint(bt[j])) << 32) |
                    static_cast<uint32_t>(bs[j] + 1));
}

// CTA 0's first task: the work-item schedule.  items_t = ceil(counts[t] /
// chunk) for every tile; offs[j] = the number of items at depths below j
// (offs[j + 1] - offs[j] = the tiles with items_t > j); order = the tiles
// with items_t > 0, most items first (a counting sort).  hist is scratch
// shared memory of n_depths + 1 ints.
__device__ void build_schedule(const int* counts, int n_tiles, int n_depths,
                               int chunk, int* hist, int* order, int* offs) {
  const int tid = threadIdx.x;
  for (int v = tid; v <= n_depths; v += kThreads) hist[v] = 0;
  __syncthreads();
  for (int t = tid; t < n_tiles; t += kThreads)
    atomicAdd(&hist[(counts[t] + chunk - 1) / chunk], 1);
  __syncthreads();
  if (tid == 0) {
    // hist[v] becomes the tiles with more than v items: where the tiles
    // with exactly v items start in order, and the items at depth v.
    int above = 0;
    for (int v = n_depths; v >= 0; --v) {
      const int h = hist[v];
      hist[v] = above;
      above += h;
    }
    offs[0] = 0;
    for (int j = 0; j < n_depths; ++j) offs[j + 1] = offs[j] + hist[j];
  }
  __syncthreads();
  for (int t = tid; t < n_tiles; t += kThreads) {
    const int v = (counts[t] + chunk - 1) / chunk;
    if (v > 0) order[atomicAdd(&hist[v], 1)] = t;
  }
}

template <int kRaysPerThread, bool kCountExec>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
closest_hit_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const float4* __restrict__ wrows,
                   const float4* __restrict__ crows,
                   const int* __restrict__ visit,
                   const float* __restrict__ ventry,
                   const int* __restrict__ counts, int* order, int* offs,
                   int* sched, unsigned long long* keys, int* executed,
                   int* tested, int n_tiles,
                   int n_depths, int tile_r, int list_len, int k, float t_min,
                   int chunk) {
  extern __shared__ float4 s_ring[];  // two buffers of 3 * k + 2 float4
  __shared__ float s_max[2][kWarps];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  // sched[0]: set once the schedule is built; sched[1]: the next item.
  volatile int* ready = sched;
  if (blockIdx.x == 0) {
    build_schedule(counts, n_tiles, n_depths, chunk,
                   reinterpret_cast<int*>(s_ring), order, offs);
    __threadfence();
    __syncthreads();
    if (tid == 0) *ready = 1;
  } else {
    // CTA 0 is dispatched first and never waits, so this wait ends; the
    // schedule is read after it, through L2 (__ldcg).
    if (tid == 0)
      while (*ready == 0) __nanosleep(256);
    __syncthreads();
    __threadfence();
  }
  const int n_items = __ldcg(offs + n_depths);
  int depth = 0;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(sched + 1, 1);
    __syncthreads();
    const int item = s_item;
    // Every thread has read s_item and left the previous item's walk (its
    // ring and s_max) before anyone writes them again.
    __syncthreads();
    if (item >= n_items) return;
    // Items are taken in increasing order, so a CTA's depth only grows.
    while (__ldcg(offs + depth + 1) <= item) ++depth;
    const int tile = __ldcg(order + item - __ldcg(offs + depth));
    const int start = depth * chunk;
    walk_item<kRaysPerThread, kCountExec>(
        origins, dirs, wrows, crows,
        visit + static_cast<size_t>(tile) * list_len,
        ventry + static_cast<size_t>(tile) * list_len, keys, executed, tested,
        s_ring, s_max, tile, start, min(start + chunk, counts[tile]), tile_r, k,
        t_min);
  }
}

// The launch's operands, as dxrt_closest_hit takes them.
struct Args {
  const float* origins;
  const float* dirs;
  const float* wrows;
  const float* crows;
  const int* visit;
  const float* ventry;
  const int* counts;
  int* order;
  int* offs;
  int* sched;
  unsigned long long* keys;
  int* executed;
  int* tested;
  int n_tiles, n_depths, tile_r, list_len, k;
  float t_min;
  int chunk;
};

template <int kRaysPerThread, bool kCountExec>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = closest_hit_kernel<kRaysPerThread, kCountExec>;
  const size_t smem = sizeof(float4) * 2 * (3 * a.k + 2);
  // The CTAs that fit on the card at once, asked once per device and k:
  // every CTA of the grid is resident, so none waits for an undispatched
  // CTA 0.
  static int cached_dev = -1, cached_k = -1, resident = 1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || a.k != cached_k) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    resident = std::max(1, sms * std::min(per_sm, kCtasPerSm));
    cached_dev = dev;
    cached_k = a.k;
  }
  const long long max_items = static_cast<long long>(a.n_tiles) * a.n_depths;
  const int grid =
      static_cast<int>(std::max(1LL, std::min<long long>(max_items, resident)));
  kernel<<<grid, kThreads, smem, stream>>>(
      a.origins, a.dirs, reinterpret_cast<const float4*>(a.wrows),
      reinterpret_cast<const float4*>(a.crows), a.visit, a.ventry, a.counts,
      a.order, a.offs, a.sched, a.keys, a.executed, a.tested, a.n_tiles,
      a.n_depths, a.tile_r, a.list_len, a.k, a.t_min, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCountExec>
int dispatch(const Args& a, cudaStream_t stream) {
  switch ((a.tile_r + kThreads - 1) / kThreads) {
    case 1:
      return launch<1, kCountExec>(a, stream);
    case 2:
      return launch<2, kCountExec>(a, stream);
    case 3:
      return launch<3, kCountExec>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tile_r must lie in [1, 768]: a thread owns at most 3 rays.  crows: (C, 8)
// f32 cull boxes (``cull_rows``), 16-byte aligned.  n_depths =
// ceil(list_len / chunk); CTA 0's counting sort takes n_depths + 1 ints of
// the ring's shared memory (at most 24 k); two buffers of a cluster's
// 3 * k + 2 float4 must fit the default 48 KB (k <= 256).  order (T,) and
// offs (n_depths + 1,) i32 are scratch; sched is two zeroed ints.
// executed and tested: nullptr for the production build, else (T,) zeroed
// i32 each for the counting build.
extern "C" int dxrt_closest_hit(const float* origins, const float* dirs,
                                const float* wrows, const float* crows,
                                const int* visit, const float* ventry,
                                const int* counts, int* order, int* offs,
                                int* sched, unsigned long long* keys,
                                int* executed, int* tested, int n_tiles,
                                int n_depths, int tile_r, int list_len, int k,
                                float t_min, int chunk, cudaStream_t stream) {
  if (chunk < 1 || k < 1 || k > 256 || n_depths < 0 ||
      n_depths + 1 > 24 * k || (executed == nullptr) != (tested == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{origins, dirs,     wrows,  crows,    visit,   ventry, counts,
               order,   offs,     sched,  keys,     executed, tested, n_tiles,
               n_depths, tile_r, list_len, k, t_min, chunk};
  return executed == nullptr ? dispatch<false>(a, stream)
                             : dispatch<true>(a, stream);
}
