// compact: the wavefront compaction's sort key and its queue gather, one
// launch each (render/wavefront.py compact).
//
// No TPU kernel stands behind them: the JAX package's _compact_sort
// (directx_raytracer_tpu/render/whitted.py:79) is a jnp chain, which XLA
// fuses under jit.  Eager PyTorch launches every op of that chain on its
// own, ~140 launches a compaction: a torch.cat of the two branches'
// columns, the Morton key at four ops a bit over 24 bits (each reading a
// stride-3 view of the cells), a ten-column torch.cat of the source rows,
// a parked row copied from the host and repeated over the whole queue,
// then the gather.  At the 1080p glass frame's first compaction (16.6M
// candidates) that moves ~27 GB.  Their plain versions, compact_keys_plain
// and compact_gather_plain (render/wavefront.py), are those chains; these
// kernels give the same results bit for bit.  The library is built with
// FMA contraction on, so every float op here is an __f*_rn intrinsic,
// which nvcc never contracts: each rounds once, as the chain's op does.
//
// The candidate list is one or two branches of n rows each: A, then B
// (the branch an overflowing queue drops first).  Each column is read in
// place at its own row stride: origins, dirs and throughput as rows of 3
// adjacent floats, pixel (i32) and active (bool) contiguous.  Candidate c
// is A's row c for c < n, else B's row c - n; with several samples' rows
// in the list, its sample is sample[c mod n].
//
// compact_keys: one thread a candidate.  key = sample << 28 | B << 27 |
// octant of (d > 0) << 24 | the origin's Morton cell (x in bit 3b, y in
// 3b + 1, z in 3b + 2 of the 8-bit cells), each axis's cell
// ((o - lo) / max(hi - lo, 1e-12) * 256) clamped to [0, 255] and
// truncated; an inactive row keys n_samples << 28, above every live key.
// The key is i32 where that sentinel fits, else i64: the same order, so
// the stable sort gives the same permutation.
//
// compact_gather: one thread a queue row, n_samples * capacity rows.  From
// the stable sort's order and bounds[k], the first sorted position whose
// key is >= k << 27 (k = 0 .. 2 n_samples): sample s's live rows sit at
// sorted positions [bounds[2s], bounds[2s + 2]), of which it keeps the
// first min(count, capacity); the queue holds the kept rows sample after
// sample, then parked rows.  A kept row writes its candidate's packed row
// (origin, dir, throughput, and the pixel id clamped to 2^24 as an f32
// value), that value as its i32 pixel, active 1 and sample s; a parked row
// the parked constants, pixel 2^24, active 0 and sample 0.  The counts
// come from device memory: no upload and no host read.
//
// What bounds both: bytes.  compact_keys reads 25 B a candidate (29 with
// samples) and writes a 4-byte key (8 for i64); compact_gather writes 45 B
// a queue row (49 with samples) and reads 8 B of order and 40 B of the
// candidate for a kept row, at random.  A block stages its packed rows in
// shared memory, so its stores are whole lines.  One thread a row, 256 a
// block; built without fast-math.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 10;  // the packed row: origin, dir, throughput, pixel
constexpr int kSentinel = 1 << 24;  // render/wavefront.py PIXEL_SENTINEL

// One branch of the candidate list.  Strides are in floats; a pointer the
// kernel does not read may be null.
struct Branch {
  const float* o;
  const float* d;
  const float* t;
  const int* pixel;
  const uint8_t* active;
  int so, sd, st;
};

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The Morton cell of one axis, as compact_keys_plain computes it; a NaN
// truncates to 0, as .to(torch.int32) does on the card.
__device__ __forceinline__ uint32_t cell(float p, float lo, float hi) {
  float ext = __fsub_rn(hi, lo);
  ext = ext != ext ? ext : fmaxf(ext, 1e-12f);
  const float c = __fmul_rn(__fdiv_rn(__fsub_rn(p, lo), ext), 256.0f);
  return static_cast<uint32_t>(static_cast<int>(clamp(c, 0.0f, 255.0f)));
}

// Bit b of an 8-bit value to bit 3b.
__device__ __forceinline__ uint32_t spread8(uint32_t x) {
  x &= 0xFFu;
  x = (x | (x << 8)) & 0x0000F00Fu;
  x = (x | (x << 4)) & 0x000C30C3u;
  x = (x | (x << 2)) & 0x00249249u;
  return x;
}

template <typename Key>
__global__ void compact_keys_kernel(Branch a, Branch b, int n, int rows,
                                    const int* __restrict__ sample,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ hi,
                                    Key sentinel, Key* __restrict__ key) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= rows) return;
  const bool late = c >= n;
  const int i = late ? c - n : c;
  if ((late ? b.active : a.active)[i] == 0) {
    key[c] = sentinel;
    return;
  }
  const float* o = (late ? b.o : a.o) + static_cast<size_t>(i) * (late ? b.so : a.so);
  const float* d = (late ? b.d : a.d) + static_cast<size_t>(i) * (late ? b.sd : a.sd);
  const uint32_t morton = spread8(cell(o[0], lo[0], hi[0])) |
                          (spread8(cell(o[1], lo[1], hi[1])) << 1) |
                          (spread8(cell(o[2], lo[2], hi[2])) << 2);
  const uint32_t octant = (d[0] > 0.0f ? 4u : 0u) | (d[1] > 0.0f ? 2u : 0u) |
                          (d[2] > 0.0f ? 1u : 0u);
  Key k = static_cast<Key>((octant << 24) | morton | (late ? 1u << 27 : 0u));
  if (sample != nullptr) k |= static_cast<Key>(sample[i]) << 28;
  key[c] = k;
}

__global__ void compact_gather_kernel(Branch a, Branch b, int n,
                                      const long long* __restrict__ order,
                                      const long long* __restrict__ bounds,
                                      int n_samples, int capacity, int rows,
                                      float* __restrict__ packed,
                                      int* __restrict__ pixel,
                                      uint8_t* __restrict__ active,
                                      int* __restrict__ sample) {
  __shared__ float stage[kThreads * kCols];
  const int r0 = blockIdx.x * kThreads;
  const int r = r0 + threadIdx.x;
  if (r < rows) {
    // The sample whose kept rows hold queue row r, and its sorted position.
    int s = -1;
    long long src = 0, q = 0;
    for (int k = 0; k < n_samples; ++k) {
      const long long first = bounds[2 * k];
      long long kept = bounds[2 * k + 2] - first;
      kept = kept < capacity ? kept : capacity;
      if (r < q + kept) {
        s = k;
        src = first + (r - q);
        break;
      }
      q += kept;
    }
    float v[kCols] = {1e30f, 1e30f, 1e30f, 1.0f, 1.0f, 1.0f,
                      0.0f,  0.0f,  0.0f,  static_cast<float>(kSentinel)};
    int p = kSentinel;
    if (s >= 0) {
      const long long c = order[src];
      const bool late = c >= n;
      const size_t i = static_cast<size_t>(late ? c - n : c);
      const float* o = (late ? b.o : a.o) + i * (late ? b.so : a.so);
      const float* d = (late ? b.d : a.d) + i * (late ? b.sd : a.sd);
      const float* t = (late ? b.t : a.t) + i * (late ? b.st : a.st);
      const int px = (late ? b.pixel : a.pixel)[i];
      const float pf = __int2float_rn(px < kSentinel ? px : kSentinel);
      v[0] = o[0], v[1] = o[1], v[2] = o[2];
      v[3] = d[0], v[4] = d[1], v[5] = d[2];
      v[6] = t[0], v[7] = t[1], v[8] = t[2];
      v[9] = pf;
      p = static_cast<int>(pf);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) stage[threadIdx.x * kCols + j] = v[j];
    pixel[r] = p;
    active[r] = s >= 0 ? 1 : 0;
    if (sample != nullptr) sample[r] = s >= 0 ? s : 0;
  }
  __syncthreads();
  const int here = (rows - r0 < kThreads ? rows - r0 : kThreads) * kCols;
  float* out = packed + static_cast<size_t>(r0) * kCols;
  for (int j = threadIdx.x; j < here; j += kThreads) out[j] = stage[j];
}

Branch branch(const float* o, int so, const float* d, int sd, const float* t,
              int st, const int* pixel, const uint8_t* active) {
  return Branch{o, d, t, pixel, active, so, sd, st};
}

}  // namespace

extern "C" int dxrt_compact_keys(const float* oa, int soa, const float* da,
                                 int sda, const uint8_t* act_a,
                                 const float* ob, int sob, const float* db,
                                 int sdb, const uint8_t* act_b, int n,
                                 int n_branches, const int* sample,
                                 const float* lo, const float* hi,
                                 int n_samples, int wide, void* key,
                                 cudaStream_t stream) {
  if (n < 1 || n_branches < 1 || n_branches > 2 || n_samples < 1 ||
      static_cast<long long>(n_branches) * n > INT_MAX ||
      (n_branches == 2 && (ob == nullptr || db == nullptr || act_b == nullptr)) ||
      (!wide && (static_cast<long long>(n_samples) << 28) > INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n_branches * n;
  const Branch a = branch(oa, soa, da, sda, nullptr, 0, nullptr, act_a);
  const Branch b = branch(ob, sob, db, sdb, nullptr, 0, nullptr, act_b);
  const int blocks = (rows + kThreads - 1) / kThreads;
  if (wide)
    compact_keys_kernel<long long><<<blocks, kThreads, 0, stream>>>(
        a, b, n, rows, sample, lo, hi,
        static_cast<long long>(n_samples) << 28, static_cast<long long*>(key));
  else
    compact_keys_kernel<int><<<blocks, kThreads, 0, stream>>>(
        a, b, n, rows, sample, lo, hi, n_samples << 28, static_cast<int*>(key));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxrt_compact_gather(
    const float* oa, int soa, const float* da, int sda, const float* ta,
    int sta, const int* pa, const float* ob, int sob, const float* db,
    int sdb, const float* tb, int stb, const int* pb, int n,
    const long long* order, const long long* bounds, int n_samples,
    int capacity, float* packed, int* pixel, uint8_t* active, int* sample,
    cudaStream_t stream) {
  if (n < 0 || n_samples < 1 || capacity < 1 ||
      static_cast<long long>(n_samples) * capacity > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n_samples * capacity;
  const Branch a = branch(oa, soa, da, sda, ta, sta, pa, nullptr);
  const Branch b = branch(ob, sob, db, sdb, tb, stb, pb, nullptr);
  compact_gather_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(a, b, n, order, bounds, n_samples,
                                    capacity, rows, packed, pixel, active,
                                    sample);
  return static_cast<int>(cudaGetLastError());
}
