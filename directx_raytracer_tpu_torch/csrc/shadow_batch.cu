// shadow_batch: the shadow batch of ops/shading.direct_lighting, its sort
// keys and its rays, one launch each.
//
// No TPU kernel stands behind them: the JAX package computes both as jnp
// chains (directx_raytracer_tpu/ops/shading.py:140-149, the armed test and
// the Morton key; :244-289, the rays), which XLA fuses under jit.  Eager
// PyTorch launches every op of those chains on its own, ~165 launches a
// shadow batch (the key interleaves 30 bits at four ops a bit), so the
// host's enqueue, not the card, set their pace.  Their plain versions,
// shadow_keys_plain and shadow_rays_plain (ops/shading.py), are those
// chains; these kernels give the same results bit for bit.  The library is
// built with FMA contraction on, so every float op here is an __f*_rn
// intrinsic, which nvcc never contracts: each rounds once, as the chain's
// op does.
//
// shadow_keys: one thread a surface point.  armed = mask (all when null)
// where the point and its normal are finite; the cell of each axis is
// ((p - lo) / max(hi - lo, 1e-12) * 1024) clamped to [0, 1023] and
// truncated; the key interleaves the three 10-bit cells, x in bit 3b, y in
// 3b + 1, z in 3b + 2; a disarmed point keys INT32_MAX (sorted last).
// Writes key (n,) i32 and armed (n,) f32 (1 or 0), the column the caller's
// sorted gather carries.
//
// shadow_rays: one thread a (light, point) pair, light-major.  It reads the
// lighting's own (L, n) lxd, lyd, lzd, dist and cos (so the light math
// stays in one place) and writes the occluder's batch: origins (L*n, 3) the
// point biased along its normal, parked at 1e30 where not live; dirs
// (L*n, 3) the light direction, 1 where it or the origin is not usable;
// t_max (L*n,) dist - 2 * bias where cos > 0, else 0, and 0 where the
// point is masked or its origin not finite (with a mask).  live is "origin
// finite", and also "masked in" when park is set (sorted mode: disarmed
// points sit in the batch's tail, so parking them widens no armed tile).
//
// Points and normals are rows of `stride` floats (the sorted gather's
// packed rows, or (n, 3) tensors); everything else is contiguous.  What
// bounds both: bytes.  shadow_keys reads 24 B and a mask byte and writes
// 8 B a point; shadow_rays reads 20 B and writes 28 B a ray, and reads a
// point's 25 B once per light (from L2 after the first).  One thread a
// row or ray, 256 a block; built without fast-math.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7F800000u) != 0x7F800000u;
}

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The Morton cell of one axis, as _morton_key_points computes it.
__device__ __forceinline__ uint32_t cell(float p, float lo, float hi) {
  float ext = __fsub_rn(hi, lo);
  ext = ext != ext ? ext : fmaxf(ext, 1e-12f);
  const float c = __fmul_rn(__fdiv_rn(__fsub_rn(p, lo), ext), 1024.0f);
  return static_cast<uint32_t>(static_cast<int>(clamp(c, 0.0f, 1023.0f)));
}

// Bit b of a 10-bit value to bit 3b.
__device__ __forceinline__ uint32_t spread10(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__global__ void shadow_keys_kernel(const float* __restrict__ points,
                                   int p_stride,
                                   const float* __restrict__ normals,
                                   int n_stride,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ lo,
                                   const float* __restrict__ hi, int n,
                                   int* __restrict__ key,
                                   float* __restrict__ armed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = points + static_cast<size_t>(i) * p_stride;
  const float* q = normals + static_cast<size_t>(i) * n_stride;
  const float px = p[0], py = p[1], pz = p[2];
  const bool on = (mask == nullptr || mask[i] != 0) && finite(px) &&
                  finite(py) && finite(pz) && finite(q[0]) && finite(q[1]) &&
                  finite(q[2]);
  int k = 0x7FFFFFFF;
  if (on)
    k = static_cast<int>(spread10(cell(px, lo[0], hi[0])) |
                         (spread10(cell(py, lo[1], hi[1])) << 1) |
                         (spread10(cell(pz, lo[2], hi[2])) << 2));
  key[i] = k;
  armed[i] = on ? 1.0f : 0.0f;
}

__global__ void shadow_rays_kernel(
    const float* __restrict__ points, int p_stride,
    const float* __restrict__ normals, int n_stride,
    const uint8_t* __restrict__ mask, const float* __restrict__ lxd,
    const float* __restrict__ lyd, const float* __restrict__ lzd,
    const float* __restrict__ dist, const float* __restrict__ cosl, int n,
    int total, bool park, float bias, float t_bias,
    float* __restrict__ origins, float* __restrict__ dirs,
    float* __restrict__ t_max) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // l * n + i
  if (j >= total) return;
  const int i = j % n;
  const float* p = points + static_cast<size_t>(i) * p_stride;
  const float* q = normals + static_cast<size_t>(i) * n_stride;
  const float sx = __fadd_rn(p[0], __fmul_rn(q[0], bias));
  const float sy = __fadd_rn(p[1], __fmul_rn(q[1], bias));
  const float sz = __fadd_rn(p[2], __fmul_rn(q[2], bias));
  const bool fin = finite(sx) && finite(sy) && finite(sz);
  const bool in = mask == nullptr || mask[i] != 0;
  const bool live = fin && (in || !park);
  const float lx = lxd[j], ly = lyd[j], lz = lzd[j];
  const bool ok = live && finite(lx) && finite(ly) && finite(lz);
  float t = cosl[j] > 0.0f ? __fsub_rn(dist[j], t_bias) : 0.0f;
  if (mask != nullptr && !(in && fin)) t = 0.0f;
  const size_t o = 3 * static_cast<size_t>(j);
  origins[o] = live ? sx : 1e30f;
  origins[o + 1] = live ? sy : 1e30f;
  origins[o + 2] = live ? sz : 1e30f;
  dirs[o] = ok ? lx : 1.0f;
  dirs[o + 1] = ok ? ly : 1.0f;
  dirs[o + 2] = ok ? lz : 1.0f;
  t_max[j] = t;
}

}  // namespace

extern "C" int dxrt_shadow_keys(const float* points, int p_stride,
                                const float* normals, int n_stride,
                                const uint8_t* mask, const float* lo,
                                const float* hi, int n, int* key,
                                float* armed, cudaStream_t stream) {
  if (n < 1 || p_stride < 3 || n_stride < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  shadow_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      points, p_stride, normals, n_stride, mask, lo, hi, n, key, armed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxrt_shadow_rays(const float* points, int p_stride,
                                const float* normals, int n_stride,
                                const uint8_t* mask, const float* lxd,
                                const float* lyd, const float* lzd,
                                const float* dist, const float* cosl,
                                int n_lights, int n, int park, float bias,
                                float t_bias, float* origins, float* dirs,
                                float* t_max, cudaStream_t stream) {
  if (n < 1 || n_lights < 1 || p_stride < 3 || n_stride < 3 ||
      static_cast<long long>(n_lights) * n > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = n_lights * n;
  shadow_rays_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(points, p_stride, normals, n_stride, mask,
                                 lxd, lyd, lzd, dist, cosl, n, total,
                                 park != 0, bias, t_bias, origins, dirs,
                                 t_max);
  return static_cast<int>(cudaGetLastError());
}
