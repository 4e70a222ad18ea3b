// Kernel K4: RMSNorm, out = x * rsqrt(mean(x^2) + eps) * gamma per row,
// accumulated in float32, stored in x's type (float32 or bfloat16).
//
// Replaces src/repro/kernels/rmsnorm.py:18 _rmsnorm_kernel (pallas_call
// at :34).
//
// Bound: bytes.  The function reads x and gamma once and writes out: at
// (T, D) = (8192, 4096) float32 that is 268 MB, 0.080 ms at 3.35 TB/s
// (0.040 ms in bfloat16); its 4 flops per element are 1/16 of that time.
//
// Design: one CTA per row, 16-byte loads and stores where the row allows
// (D a multiple of 4 floats or 8 bfloat16s and the pointers aligned),
// element by element otherwise, so any D is taken.  A first pass sums
// the squares (block reduction); the second pass reads the row again —
// from L1/L2, the row is at most a few tens of KB — and writes the
// scaled values.  gamma is float32 (the wrapper casts it).

#include "hand_kernels.cuh"

namespace {

using hk::NT;
using hk::WARPS;

template <typename T, int V>
__global__ void __launch_bounds__(NT)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   T* __restrict__ out, int D, float eps) {
  __shared__ float red[WARPS];
  using P = hk::Pack<T, V>;
  const long long base = (long long)blockIdx.x * D;
  const P* xr = reinterpret_cast<const P*>(x + base);
  P* orow = reinterpret_cast<P*>(out + base);
  const int packs = D / V;  // V divides D (the launcher picks V so)
  float ss = 0.0f;
#pragma unroll 4
  for (int k = threadIdx.x; k < packs; k += NT) {
    const P v = xr[k];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = hk::to_f32(v.v[e]);
      ss += f * f;
    }
  }
  ss = hk::block_sum(ss, red);
  const float scale = rsqrtf(ss / (float)D + eps);
#pragma unroll 4
  for (int k = threadIdx.x; k < packs; k += NT) {
    const P v = xr[k];
    P o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = hk::from_f32<T>(hk::to_f32(v.v[e]) * scale * gamma[k * V + e]);
    orow[k] = o;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* gamma, void* out, int rows,
                   int D, float eps, cudaStream_t s) {
  rmsnorm_kernel<T, V><<<rows, NT, 0, s>>>(
      (const T*)x, (const float*)gamma, (T*)out, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x and out are (rows, D) of float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// gamma is (D,) float32.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              int rows, int D, float eps, int bf16,
                              void* stream) {
  if (rows < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = hk::aligned16(x) && hk::aligned16(out);
  if (bf16)
    return (int)(D % 8 == 0 && aligned
                     ? launch<__nv_bfloat16, 8>(x, gamma, out, rows, D, eps, s)
                     : launch<__nv_bfloat16, 1>(x, gamma, out, rows, D, eps, s));
  return (int)(D % 4 == 0 && aligned
                   ? launch<float, 4>(x, gamma, out, rows, D, eps, s)
                   : launch<float, 1>(x, gamma, out, rows, D, eps, s));
}
