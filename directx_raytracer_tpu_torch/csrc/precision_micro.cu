// precision_micro: the Woop fold under three dot precisions, reduced to
// each ray's min packed t.
//
// Replaces the TPU micro-bench kernel _body (tools/precision_micro.py:32,
// launched by launch :71, pallas_call :83).  What it computes is the same,
// with a defined output: for each of S steps, each of K = 128 triangles and
// each of R = 256 rays, mm = w[s]^T @ rays (a (6K, R) product of depth 8),
// then tt = -mm[2K+k] / mm[5K+k], u = mm[k] + tt mm[3K+k],
// v = mm[K+k] + tt mm[4K+k], accept min(min(u, v), 1-u-v) >= 0 and
// tt > 1e-3, and per ray the min over every (step, triangle) of the
// accepted tt's int32 bits, or 2**31 - 2 where nothing is accepted.  The
// caller fills the output with 2**31 - 2 first; the TPU kernel never
// initialised its output block.  Variants of the product:
//   default (0): operands rounded to bf16, products summed in f32, on the
//                tensor cores (mma.sync m16n8k8 bf16 -> f32);
//   highest (1): full f32 FMA on the CUDA cores;
//   split3  (2): hi = bf16(x), lo = bf16(x - hi) of both operands, three
//                tensor-core products hi*hi + lo*hi + hi*lo chained through
//                one accumulator.
//
// The tail rounds each product and sum once, as the plain torch version
// does (no contraction into FMA), and divides with an IEEE divide.  The
// accept test is u >= 0 && v >= 0 && 1-u-v >= 0, which equals the
// reference's NaN-propagating min >= 0.  fminf would not: it drops a NaN
// operand, so a NaN u (inf * 0 with mm[5K+k] = 0) could let tt = +-inf
// through.
//
// Layout: w (S, 8, 6K) f32, rays (1, 8, R) f32, out (R,) i32.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32 on the
// CUDA cores, 989 TFLOP/s bf16 on the tensor cores), at S = 2048: the
// product is 2 * 8 * 768 * 256 * S = 6.44 GFLOP; the tail is 67.1M
// candidates at 14 f32 operations (negate, divide, two multiply-adds
// rounded apart, two subtracts, four compares, a select and a min), 0.94
// GFLOP on the CUDA cores; w is read once, 50.3 MB, 0.015 ms.  So highest
// is bound by its f32 arithmetic (7.38 GFLOP, 0.110 ms; 0.119 ms with the
// IEEE divide counted as the ten instructions of its fast path, and the
// tail's compares and selects run on the same ports as the FMAs);
// default by memory (its 0.0065 ms of tensor-core work and 0.014 ms of tail
// run on different units, both under 0.015 ms); split3 by its three
// tensor-core products (0.0195 ms).  The design:
//   * a persistent grid, each CTA walking steps blockIdx.x, + gridDim.x, ...
//     with the next step's slice of w on its way while the current one is
//     folded; each ray's running min stays in registers and one atomicMin
//     per (thread, ray) publishes it (the packed values are non-negative
//     ints, so the result does not depend on order);
//   * highest: what limits it is the rate of instructions, so each shared
//     load must feed many FMAs and each thread must carry independent chains.
//     A thread holds 4 rays (32 operands in registers); w[s] is copied as it
//     lies in device memory ([j][c K + k]) by cp.async into one of two
//     shared buffers, so one float4 read at [j][c K + k..k+3] is one weight
//     of 4 triangles and feeds 16 FMAs, every lane of a warp reading the
//     same address (a broadcast, no bank conflict, no transposing store).
//     The 24 dots of a block (6 rows x 4 triangles) times 4 rays are 96
//     independent chains, each summed j = 0..7 in order, and the 16 tails
//     that follow interleave, which covers the divide's latency.  A CTA is
//     128 threads: two groups of 64 that each hold all 256 rays and fold
//     one half of the step's triangles (the groups meet in the atomicMin),
//     with one barrier a step;
//   * default/split3: w[s] is converted once per step into bf16 A
//     fragments in shared memory (and lo fragments for split3); each warp
//     owns 32 rays (four n-tiles of 8, B fragments in registers for the
//     whole kernel) and, per 16-row m-tile, issues the six m-tiles at rows
//     m + j K, j = 0..5: a thread's six accumulators then hold all six mm
//     values of the same four (k, r) positions, and the tail runs in
//     registers.  mm is never written out.
// The tail, not the product, is what the tensor-core variants spend their
// time on; wgmma and TMA would not move it.
//
// Built without --use_fast_math: the divide must be IEEE and denormals
// must not be flushed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;               // triangles per step
constexpr int kRows = 6 * kK;         // rows of mm per step
constexpr int kRays = 256;            // rays
constexpr int kDepth = 8;             // contraction depth
constexpr int kStepFloats = kDepth * kRows;  // 6144 floats of w per step
constexpr int kThreads = 256;
constexpr int kPerThread = kStepFloats / kThreads;  // 24
constexpr int kMTiles = kK / 16;      // 8
constexpr int kFrags = kMTiles * 6;   // 48 A fragments per step
constexpr int kNTiles = 4;            // n-tiles of 8 rays per warp
constexpr int kSentinel = 0x7ffffffe;  // 2**31 - 2
constexpr float kTEps = 1e-3f;

static_assert(kThreads / 32 * kNTiles * 8 == kRays, "mma: 32 rays per warp");
static_assert(kFrags * 32 == kPerThread / 4 * kThreads,
              "mma: each thread stages 6 fragment entries of 4 values");

// The tail of one candidate: its packed t or the sentinel.
__device__ __forceinline__ int fold_tail(float m0, float m1, float m2,
                                         float m3, float m4, float m5) {
  const float tt = -m2 / m5;
  const float u = __fadd_rn(m0, __fmul_rn(tt, m3));
  const float v = __fadd_rn(m1, __fmul_rn(tt, m4));
  const float w = __fsub_rn(__fsub_rn(1.f, u), v);
  // NaN fails every compare, as it fails min(...) >= 0 in the reference.
  const bool ok = u >= 0.f && v >= 0.f && w >= 0.f && tt > kTEps;
  return ok ? __float_as_int(tt) : kSentinel;
}

// ---------------------------------------------------------------------------
// highest: f32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTriBlock = 4;  // triangles folded together (one float4 of w)
constexpr int kF32Rays = 4;       // rays a thread
constexpr int kF32Threads = 128;  // threads a CTA
constexpr int kF32Lanes = kRays / kF32Rays;  // 64 threads span the rays
constexpr int kF32Share = kK / (kF32Threads / kF32Lanes);  // triangles a group
constexpr int kStepPieces = kStepFloats / 4;  // 16-byte pieces of w per step

static_assert(kF32Lanes % 32 == 0, "a warp reads one triangle block");
static_assert(kStepPieces % kF32Threads == 0, "whole pieces per thread");

// Start copying w[s] as it lies in device memory, [j][c K + k], into dst;
// one commit group.
__device__ __forceinline__ void stage_step(float* dst,
                                           const float* __restrict__ w, int s) {
  const float4* src =
      reinterpret_cast<const float4*>(w + static_cast<size_t>(s) * kStepFloats);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int i = 0; i < kStepPieces / kF32Threads; ++i) {
    const int e = threadIdx.x + i * kF32Threads;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * static_cast<uint32_t>(e)),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Two groups of 64 threads each hold all 256 rays, 4 a thread, and fold
// their own half of the step's triangles; a ray's groups meet in the
// atomicMin.
__global__ void __launch_bounds__(kF32Threads)
fold_f32_kernel(const float* __restrict__ w, const float* __restrict__ rays,
                int* __restrict__ out, int steps) {
  __shared__ __align__(16) float s_w[2][kStepFloats];

  const int lane = threadIdx.x % kF32Lanes;
  const int k_first = threadIdx.x / kF32Lanes * kF32Share;
  float ry[kF32Rays][kDepth];
  int best[kF32Rays];
#pragma unroll
  for (int i = 0; i < kF32Rays; ++i) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j)
      ry[i][j] = rays[j * kRays + lane + i * kF32Lanes];
    best[i] = kSentinel;
  }

  int s = blockIdx.x;
  if (s < steps) stage_step(s_w[0], w, s);
  for (int cur = 0; s < steps; s += gridDim.x, cur ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // Step s has landed for every thread, and the other buffer's readers
    // (the previous step) are done.
    __syncthreads();
    if (s + gridDim.x < steps) stage_step(s_w[cur ^ 1], w, s + gridDim.x);

#pragma unroll 1
    for (int k = k_first; k < k_first + kF32Share; k += kTriBlock) {
      // m[c][t][i]: row c K + k + t of mm for ray i, summed j = 0..7 in
      // order, the first product rounded on its own.
      float m[6][kTriBlock][kF32Rays];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(
              &s_w[cur][j * kRows + c * kK + k]);
          const float av[kTriBlock] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int t = 0; t < kTriBlock; ++t) {
#pragma unroll
            for (int i = 0; i < kF32Rays; ++i)
              m[c][t][i] = j == 0 ? av[t] * ry[i][0]
                                  : fmaf(av[t], ry[i][j], m[c][t][i]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kTriBlock; ++t) {
#pragma unroll
        for (int i = 0; i < kF32Rays; ++i)
          best[i] = min(best[i], fold_tail(m[0][t][i], m[1][t][i], m[2][t][i],
                                           m[3][t][i], m[4][t][i], m[5][t][i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Rays; ++i)
    atomicMin(out + lane + i * kF32Lanes, best[i]);
}

// ---------------------------------------------------------------------------
// default / split3: bf16 tensor cores
// ---------------------------------------------------------------------------

// Two floats as a bf16x2 register, rounded to nearest even; `first` in the
// low half (the lower column or row index of the fragment).
__device__ __forceinline__ uint32_t pack_bf16(float first, float second) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x = hi + lo with hi = bf16(x) exactly representable and lo = x - hi
// (exact in f32), rounded to bf16 when packed.
__device__ __forceinline__ float bf16_hi(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a (16x8, row) * b (8x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint2 a, uint32_t b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(b));
}

// Thread (warp, lane) stages fragment entries f = warp + 8 i, i = 0..5, at
// its own lane: fragment f = mt * 6 + j covers rows m = j K + mt 16 of mm.
// Lane (g, t) = (lane / 4, lane % 4) holds A[g][2t..2t+1] and
// A[g+8][2t..2t+1] with A[row][col] = w[s][col][m + row].
__device__ __forceinline__ void load_step_frag(const float* __restrict__ w,
                                               int s, float (&buf)[6][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* src = w + static_cast<size_t>(s) * kStepFloats;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int f = warp + 8 * i;
    const int c = (f % 6) * kK + (f / 6) * 16 + g;
    buf[i][0] = __ldg(src + (2 * t) * kRows + c);
    buf[i][1] = __ldg(src + (2 * t + 1) * kRows + c);
    buf[i][2] = __ldg(src + (2 * t) * kRows + c + 8);
    buf[i][3] = __ldg(src + (2 * t + 1) * kRows + c + 8);
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
fold_mma_kernel(const float* __restrict__ w, const float* __restrict__ rays,
                int* __restrict__ out, int steps) {
  __shared__ uint2 s_hi[kFrags * 32];
  __shared__ uint2 s_lo[kSplit ? kFrags * 32 : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // B fragments of the warp's four n-tiles: B[row][col] = rays[row][n0 +
  // col], lane (g, t) holding B[2t..2t+1][g].
  uint32_t b_hi[kNTiles], b_lo[kNTiles];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const int col = warp * 32 + nt * 8 + g;
    const float x0 = rays[(2 * t) * kRays + col];
    const float x1 = rays[(2 * t + 1) * kRays + col];
    const float h0 = bf16_hi(x0), h1 = bf16_hi(x1);
    b_hi[nt] = pack_bf16(h0, h1);
    b_lo[nt] = pack_bf16(x0 - h0, x1 - h1);
  }
  // best[nt][c]: this lane's min for ray warp * 32 + nt * 8 + 2t + c.
  int best[kNTiles][2];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) best[nt][0] = best[nt][1] = kSentinel;

  float buf[6][4];
  int s = blockIdx.x;
  if (s < steps) load_step_frag(w, s, buf);
  for (; s < steps; s += gridDim.x) {
    __syncthreads();  // the previous step's fragments are consumed
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int e = (warp + 8 * i) * 32 + lane;
      const float h0 = bf16_hi(buf[i][0]), h1 = bf16_hi(buf[i][1]);
      const float h2 = bf16_hi(buf[i][2]), h3 = bf16_hi(buf[i][3]);
      s_hi[e] = make_uint2(pack_bf16(h0, h1), pack_bf16(h2, h3));
      if (kSplit)
        s_lo[e] = make_uint2(pack_bf16(buf[i][0] - h0, buf[i][1] - h1),
                             pack_bf16(buf[i][2] - h2, buf[i][3] - h3));
    }
    __syncthreads();
    if (s + gridDim.x < steps) load_step_frag(w, s + gridDim.x, buf);

    for (int mt = 0; mt < kMTiles; ++mt) {
      uint2 a_hi[6], a_lo[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        a_hi[j] = s_hi[(mt * 6 + j) * 32 + lane];
        if (kSplit) a_lo[j] = s_lo[(mt * 6 + j) * 32 + lane];
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        float acc[6][4];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          mma_bf16(acc[j], a_hi[j], b_hi[nt]);
          if (kSplit) {
            mma_bf16(acc[j], a_lo[j], b_hi[nt]);
            mma_bf16(acc[j], a_hi[j], b_lo[nt]);
          }
        }
        // Accumulator i sits at row g + 8 (i / 2) (triangle mt 16 + ...)
        // and column 2t + i % 2 of the n-tile.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = fold_tail(acc[0][i], acc[1][i], acc[2][i], acc[3][i],
                                  acc[4][i], acc[5][i]);
          best[nt][i & 1] = min(best[nt][i & 1], p);
        }
      }
    }
  }

  // Min over the eight lanes (g = 0..7) that share a column, then one
  // atomic per ray.
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int v = best[nt][c];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (g == 0) atomicMin(out + warp * 32 + nt * 8 + 2 * t + c, v);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, const float* w, const float* rays,
           int* out, int steps, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = steps < slots ? steps : slots;
  kernel<<<grid, threads, 0, stream>>>(w, rays, out, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 default, 1 highest, 2 split3.  out (R,) must hold 2**31 - 2.
extern "C" int dxrt_precision_fold(const float* w, const float* rays,
                                   int* out, int steps, int variant,
                                   cudaStream_t stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0:
      return launch(fold_mma_kernel<false>, kThreads, w, rays, out, steps,
                    stream);
    case 1:
      return launch(fold_f32_kernel, kF32Threads, w, rays, out, steps,
                    stream);
    case 2:
      return launch(fold_mma_kernel<true>, kThreads, w, rays, out, steps,
                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
