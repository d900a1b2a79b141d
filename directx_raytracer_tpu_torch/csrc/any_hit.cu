// any_hit: whether some triangle lies in [t_min, t_max) along each shadow
// ray, walking its tile's near-to-far cluster list in work items.
//
// Replaces the TPU any-hit kernel _make_anyhit_kernel
// (directx_raytracer_tpu/bvh/pallas_intersect.py:1001-1071, launched by
// _launch_anyhit :1109 from _search_anyhit :1159).  What it computes is the
// same: each ray carries a blocked flag; a tile visits its binned clusters
// in order of conservative entry distance and stops once the next entry
// exceeds its gate, the largest t_max over its still-UNBLOCKED armed rays
// (-BIG once every armed ray is blocked, so the tile then stops at once;
// a disarmed ray, t_max <= t_min, can never be blocked); each visit
// tests the cluster's K triangles through their Woop transforms (walk.cuh:
// t = -o'_z / d'_z by an exact IEEE divide, accept u, v, 1-u-v >= 0 and
// t >= t_min) and blocks a ray on the first accepted triangle with
// t < t_max.  Rays with t_max <= t_min are never blocked.  Differences from
// the TPU kernel, all because the card does not need them: f32 FMA instead
// of a bf16x3 split matmul, and CTAs that walk chunks of each tile's ragged
// list instead of a fixed-budget visit grid.  The divide is exact IEEE,
// never an approximate reciprocal: the JAX package's default bary6r
// scheme feeds occlusion verdicts from an approximate reciprocal with no
// exact recheck, which this kernel does not copy.
//
// Layout: rays (N, 3) f32 origins/dirs and (N,) t_max, tile-major,
// N = T * tile_r.  Woop rows (C, K, 12) f32 and cull boxes (C, 8) f32
// (walk.cuh).  Visit list (T, L) i32 cluster ids sorted by entry, with
// entries (T, L) f32 and per-tile counts (T,) i32; work items (W,) i32 tile
// ids and first list positions.  Output: blocked (N,) u8, zeroed by the
// caller.
//
// What bounds it on the card: arithmetic, then load balance.  A visit
// spends ~45 f32 operations on each (ray, triangle) pair it tests, and
// most pairs of a visit cannot block: the tile's hull meets the cluster,
// but on incoherent shadow rays most 32-ray groups miss its box.  So each
// warp first slab-tests its open rays (live, armed and not yet blocked)
// against the cluster's cull box over [t_min, the ray's own t_max]
// (walk.cuh needs_box, ~40 operations a ray), and runs the K tests only if
// one of them can reach the box (__any_sync: warp-uniform); a done ray
// (blocked, disarmed, parked or past the tile) never votes.  The box holds
// every point at which the f32 test accepts, rounding included
// (cuda_intersect.cull_rows), so a pair that would block, t_min <= t <
// t_max, is never dropped: blocked is that of testing every open ray, bit
// for bit.  Most shadow tiles visit a few
// clusters or none (fully disarmed tiles bin nothing), but a few dozen
// tiles of a Morton-sorted 1080p shadow batch bin hundreds (a Z-curve jump
// inside a tile widens its box).  Occlusion is an OR over clusters, so each
// tile's list is cut into work items of `chunk` positions, one CTA each,
// all in parallel; a CTA ORs its rays' flags into the output (plain stores
// of 1 into a zeroed array: every writer writes the same value).  The
// early-out gate is per work item (its own blocked flags), so a later item
// of a tile may redo work an earlier one made moot, never the other way
// round.  Within a CTA: 256 threads, one ray per thread in registers (two
// rays per thread in 128 threads measured no faster: PERF.md §6), so warp
// w holds the tile's rays [32 w, 32 w + 32); the next cluster's rows and
// box are copied by cp.async into the other buffer of a two-buffer ring
// while this cluster is tested, with one block barrier per visit, and read
// as three broadcast float4 loads per triangle (the box as two); a done ray
// (blocked, disarmed, or a lane past the tile) skips the pair loop, and a
// ray leaves it at its first blocker.
//
// The counting build (kCountExec, chosen at compile time: the production
// instantiation gains no instruction) gives the same blocked and also adds,
// per tile, the 32-ray groups that held an open ray at an executed visit
// (what would have run the pair loop without the cull) into open_groups
// (T,) i32, and those whose pair loop ran into tested (T,) i32: one
// atomicAdd each by lane 0 of each warp per item; the caller zeroes both.
//
// Built without --use_fast_math: t needs an exact divide, and denormals
// must not be flushed.

#include "walk.cuh"

namespace {

using dxrt::kThreads;
using dxrt::kWarps;
constexpr float kBig = 1e30f;

template <bool kCountExec>
__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ origins,
               const float* __restrict__ dirs,
               const float* __restrict__ t_max,
               const float4* __restrict__ wrows,
               const float4* __restrict__ crows,
               const int* __restrict__ visit,
               const float* __restrict__ ventry,
               const int* __restrict__ counts,
               const int* __restrict__ work_tile,
               const int* __restrict__ work_start,
               uint8_t* __restrict__ blocked_out, int* open_out,
               int* tested_out, int tile_r, int list_len, int k, float t_min,
               int chunk) {
  extern __shared__ float4 s_ring[];  // two buffers of 3 * k + 2 float4
  __shared__ float s_gate[2][kWarps];
  const int tile = work_tile[blockIdx.x];
  const int start = work_start[blockIdx.x];
  const int tid = threadIdx.x;
  // The ring buffer of one cluster: its 3k rows, then its two box pieces.
  const int pieces = 3 * k, stride = pieces + 2;
  const bool live = tid < tile_r;
  const size_t ray_i = static_cast<size_t>(tile) * tile_r + (live ? tid : 0);
  const dxrt::Ray ray = dxrt::load_ray(origins, dirs, ray_i);
  const float tm = t_max[ray_i];
  // A lane is done once blocked.  A lane past the tile, or a disarmed ray
  // (t_max <= t_min: no t passes t_min <= t < t_max), starts done: it
  // skips the pair loop, never votes in the cull and never raises the
  // gate, and is never blocked.
  bool blocked = false;
  bool done = !live || !(tm > t_min);
  int n_open = 0, n_tested = 0;

  const int end = min(start + chunk, counts[tile]);
  const int* vlist = visit + static_cast<size_t>(tile) * list_len;
  const float* elist = ventry + static_cast<size_t>(tile) * list_len;
  // The box first: stage_cluster's commit group takes its copies too.
  dxrt::stage_box(s_ring + pieces,
                  crows + 2 * static_cast<size_t>(vlist[start]));
  dxrt::stage_cluster(
      s_ring, wrows + static_cast<size_t>(vlist[start]) * pieces, pieces);
  int buf = 0;
  for (int i = start; i < end; ++i, buf ^= 1) {
    float g = done ? -kBig : tm;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      g = fmaxf(g, __shfl_xor_sync(0xffffffffu, g, off));
    if ((tid & 31) == 0) s_gate[buf][tid >> 5] = g;
    dxrt::wait_staged();
    // The one barrier of the visit: the staged rows, box and s_gate are
    // complete, and every thread is done with the other ring buffer.
    __syncthreads();
    float gate = s_gate[buf][0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) gate = fmaxf(gate, s_gate[buf][q]);
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
    // The cull: the warp runs this cluster's tests iff one of its open rays
    // can reach the box before its t_max.  Warp-uniform.
    const bool run = __any_sync(
        0xffffffffu, !done && dxrt::needs_box(w + pieces, ray, tm, t_min));
    if constexpr (kCountExec) {
      n_open += __any_sync(0xffffffffu, !done);
      n_tested += run;
    }
    if (!run || done) continue;

    for (int kk = 0; kk < k; ++kk) {
      const float4 a = w[3 * kk], b = w[3 * kk + 1], c = w[3 * kk + 2];
      float t;
      if (dxrt::woop_test(a, b, c, ray, t_min, t) && t < tm) {
        blocked = done = true;
        break;
      }
    }
  }

  if (blocked) blocked_out[ray_i] = 1;
  if constexpr (kCountExec) {
    if ((tid & 31) == 0 && n_open > 0) atomicAdd(open_out + tile, n_open);
    if ((tid & 31) == 0 && n_tested > 0) atomicAdd(tested_out + tile, n_tested);
  }
}

}  // namespace

// tile_r must lie in [1, 256]: a thread owns one ray.  One CTA per work
// item.  crows: (C, 8) f32 cull boxes (``cull_rows``), 16-byte aligned.  Two
// buffers of a cluster's 3 * k + 2 float4 must fit the default 48 KB of
// shared memory (k <= 256).  open_groups and tested: nullptr for the
// production build, else (T,) zeroed i32 each for the counting build.
extern "C" int dxrt_any_hit(const float* origins, const float* dirs,
                            const float* t_max, const float* wrows,
                            const float* crows, const int* visit,
                            const float* ventry, const int* counts,
                            const int* work_tile, const int* work_start,
                            uint8_t* blocked, int* open_groups, int* tested,
                            int n_items, int tile_r, int list_len, int k,
                            float t_min, int chunk, cudaStream_t stream) {
  if (tile_r < 1 || tile_r > kThreads || chunk < 1 || k < 1 || k > 256 ||
      (open_groups == nullptr) != (tested == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float4) * 2 * (3 * k + 2);
  const auto kernel =
      open_groups == nullptr ? any_hit_kernel<false> : any_hit_kernel<true>;
  kernel<<<n_items, kThreads, smem, stream>>>(
      origins, dirs, t_max, reinterpret_cast<const float4*>(wrows),
      reinterpret_cast<const float4*>(crows), visit, ventry, counts, work_tile,
      work_start, blocked, open_groups, tested, tile_r, list_len, k, t_min,
      chunk);
  return static_cast<int>(cudaGetLastError());
}
