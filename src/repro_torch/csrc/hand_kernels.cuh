// Device helpers shared by the hand-written kernels K2-K7
// (bicgk.cu, gemver.cu, rmsnorm.cu, decode_attention.cu, adamw.cu,
// softmax_xent.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hk {

constexpr int NT = 256;            // threads per CTA of every hand kernel
constexpr int WARPS = NT / 32;

// V consecutive elements of T, loaded or stored as one access of
// V * sizeof(T) bytes (16-byte accesses for float V = 4, bf16 V = 8).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the NT threads of the CTA; every thread gets the result.
// ``red`` is shared scratch of WARPS floats.  Every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// The grid of a kernel over an (m, n) matrix cut into strips of `tn`
// columns, and each strip into `groups` even ranges of rows, one CTA
// each: as many CTAs as the card holds at once (the lower occupancy of
// the kernel's two instances `ka`, `kb`), so the grid runs as one
// balanced wave, and at least one row per warp.  `strips` is the strip
// count, which the wrappers size their partials with.
template <class KA, class KB>
inline cudaError_t row_groups(KA ka, KB kb, int m, int n, int tn,
                              int* groups, int* strips) {
  int dev = 0, sms = 0, a = 0, b = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, ka, NT, 0)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kb, NT, 0)) !=
          cudaSuccess)
    return err;
  *strips = (n + tn - 1) / tn;
  int g = (a < b ? a : b) * sms / (*strips > 0 ? *strips : 1);
  const int most = (m + WARPS - 1) / WARPS;
  if (g > most) g = most;
  *groups = g > 1 ? g : 1;
  return cudaSuccess;
}

// Blocks of NT threads for a grid-stride pass over `work` items, one
// item per thread per step: as many CTAs as the card holds at once of
// `kernel` (with `smem` bytes of dynamic shared memory), fewer where
// there is less work.
template <class K>
inline cudaError_t resident_grid(K kernel, long long work, size_t smem,
                                 int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NT, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (work + NT - 1) / NT;
  const long long cap = (long long)per_sm * sms;
  *grid = (int)(need < cap ? (need > 0 ? need : 1) : cap);
  return cudaSuccess;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace hk
