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
// Design (the register path): each row is read once from device memory
// into registers, by `tpr` threads (32 to 128, a power of two) that hold
// `ppt` (1 to 8) 16-byte packs each; a CTA of NT threads takes NT / tpr
// rows at once.  A thread issues all its x loads and its gamma loads
// (float32, as 16-byte vectors) before the sum of squares, sums over its
// row's lanes (shuffles, then the row's warps in order through shared
// memory), and scales and stores the same registers.  Many small CTAs a
// SM keep other rows' loads in flight while one reduces.  At D = 4096
// that is 128 threads x 4 packs a row in bfloat16 (2 rows a CTA) and 128
// x 8 in float32.
// The general path takes what the register path does not (rows over
// 1024 packs, D not a multiple of the pack, unaligned pointers): one CTA
// a row, a first pass for the sum of squares and a second that reads
// the row again from L1/L2 to scale it, 16-byte packs where D and the
// pointers allow, element by element otherwise.  Sums run in a fixed
// order on both paths: the same inputs give the same bits every run.
//
// The block entry (rmsnorm_block_sumsq_launch, rmsnorm_block_scale_launch)
// normalises rows that are split over tensor-parallel ranks, each rank
// holding a block of D of the row's d_total columns (Mamba-2's gated
// norm over d_inner, cut by SSD heads): the first kernel writes each
// row's float32 sum of squares over the block, the ranks add those
// (T,) sums (an all-reduce outside the kernel), and the second scales
// the block by rsqrt(total / d_total + eps) * gamma, float32 throughout
// and rounded once, as the whole-row kernel does.  It replaces no TPU
// kernel of its own: the reference normalises the whole d_inner row on
// its mesh (src/repro/models/ssm.py:116); on the card a rank's share of
// the all-reduce is 4 bytes a row where gathering the rows would move
// 2 d_total.  Bound: bytes (x read by each kernel, out written); one
// CTA a row, the general path's 16-byte packs where D and the pointers
// allow, element by element otherwise; sums in a fixed order.

#include "hand_kernels.cuh"

namespace {

using hk::NT;
using hk::WARPS;
constexpr int PPT_MAX = 8;    // packs a thread holds on the register path
constexpr int TPR_MAX = 128;  // threads a row on the register path

// V floats of gamma from element i: 16-byte loads where V allows.
template <int V>
__device__ __forceinline__ void gamma_of(const float* __restrict__ gamma,
                                         int i, float* g) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(gamma + i + 4 * k);
      g[4 * k] = x.x;
      g[4 * k + 1] = x.y;
      g[4 * k + 2] = x.z;
      g[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) g[e] = gamma[i + e];
  }
}

template <typename T, int PPT>
__global__ void __launch_bounds__(NT)
    rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                 T* __restrict__ out, int rows, int D, int tpr, float eps) {
  constexpr int V = 16 / sizeof(T);
  using P = hk::Pack<T, V>;
  __shared__ float red[WARPS];
  const int packs = D / V;
  const int j = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (NT / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const P* xr = reinterpret_cast<const P*>(x + row * D);

  P xv[PPT];
  float g[PPT][V];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pk = j + k * tpr;
    if (live && pk < packs) xv[k] = xr[pk];
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pk = j + k * tpr;
    if (live && pk < packs) gamma_of<V>(gamma, pk * V, g[k]);
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (live && j + k * tpr < packs) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = hk::to_f32(xv[k].v[e]);
        ss += f * f;
      }
    }
  }
  ss = hk::warp_sum(ss);
  if (tpr > 32) {  // the row's warps, in order
    const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    __syncthreads();
    const int first = warp / per_row * per_row;
    ss = 0.0f;
    for (int w = 0; w < per_row; ++w) ss += red[first + w];
  }
  const float scale = rsqrtf(ss / (float)D + eps);
  P* orow = reinterpret_cast<P*>(out + row * D);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pk = j + k * tpr;
    if (live && pk < packs) {
      P o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = hk::from_f32<T>(hk::to_f32(xv[k].v[e]) * scale * g[k][e]);
      orow[pk] = o;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NT)
    rmsnorm_general(const T* __restrict__ x, const float* __restrict__ gamma,
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
    float g[V];
    gamma_of<V>(gamma, k * V, g);
    P o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = hk::from_f32<T>(hk::to_f32(v.v[e]) * scale * g[e]);
    orow[k] = o;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NT)
    rmsnorm_block_sumsq(const T* __restrict__ x, float* __restrict__ ss,
                        int D) {
  __shared__ float red[WARPS];
  using P = hk::Pack<T, V>;
  const P* xr = reinterpret_cast<const P*>(x + (long long)blockIdx.x * D);
  const int packs = D / V;
  float s = 0.0f;
#pragma unroll 4
  for (int k = threadIdx.x; k < packs; k += NT) {
    const P v = xr[k];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = hk::to_f32(v.v[e]);
      s += f * f;
    }
  }
  s = hk::block_sum(s, red);
  if (threadIdx.x == 0) ss[blockIdx.x] = s;
}

template <typename T, int V>
__global__ void __launch_bounds__(NT)
    rmsnorm_block_scale(const T* __restrict__ x, const float* __restrict__ ss,
                        const float* __restrict__ gamma, T* __restrict__ out,
                        int D, int d_total, float eps) {
  using P = hk::Pack<T, V>;
  const long long base = (long long)blockIdx.x * D;
  const P* xr = reinterpret_cast<const P*>(x + base);
  P* orow = reinterpret_cast<P*>(out + base);
  const int packs = D / V;
  const float scale = rsqrtf(ss[blockIdx.x] / (float)d_total + eps);
#pragma unroll 4
  for (int k = threadIdx.x; k < packs; k += NT) {
    const P v = xr[k];
    float g[V];
    gamma_of<V>(gamma, k * V, g);
    P o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = hk::from_f32<T>(hk::to_f32(v.v[e]) * scale * g[e]);
    orow[k] = o;
  }
}

// The path for a row of D elements of `es` bytes: 0 the register path
// (with tpr threads a row holding ppt packs each), 1 the general path
// in 16-byte packs, 2 element by element.
struct Plan {
  int path, tpr, ppt;
};

Plan plan_of(int D, int es, bool aligned) {
  const int V = 16 / es;
  if (!aligned || D % V != 0) return {2, 0, 0};
  const int packs = D / V;
  if (packs > TPR_MAX * PPT_MAX) return {1, 0, 0};
  int tpr = 32;  // about 4 packs a thread, at most TPR_MAX threads a row
  while (tpr < TPR_MAX && tpr * 4 < packs) tpr <<= 1;
  int ppt = 1;  // a power of two
  while (ppt * tpr < packs) ppt <<= 1;
  return {0, tpr, ppt};
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* out, int rows,
                   int D, float eps, bool aligned, cudaStream_t s) {
  const Plan p = plan_of(D, sizeof(T), aligned);
  const T* xt = (const T*)x;
  const float* g = (const float*)gamma;
  T* o = (T*)out;
  if (p.path == 0) {
    const int per_cta = NT / p.tpr;
    const int grid = (int)(((long long)rows + per_cta - 1) / per_cta);
    switch (p.ppt) {
      case 1:
        rmsnorm_rows<T, 1><<<grid, NT, 0, s>>>(xt, g, o, rows, D, p.tpr, eps);
        break;
      case 2:
        rmsnorm_rows<T, 2><<<grid, NT, 0, s>>>(xt, g, o, rows, D, p.tpr, eps);
        break;
      case 4:
        rmsnorm_rows<T, 4><<<grid, NT, 0, s>>>(xt, g, o, rows, D, p.tpr, eps);
        break;
      default:
        rmsnorm_rows<T, 8><<<grid, NT, 0, s>>>(xt, g, o, rows, D, p.tpr, eps);
    }
  } else if (p.path == 1) {
    rmsnorm_general<T, 16 / sizeof(T)><<<rows, NT, 0, s>>>(xt, g, o, D, eps);
  } else {
    rmsnorm_general<T, 1><<<rows, NT, 0, s>>>(xt, g, o, D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// The path K4 takes for rows of D elements (bf16: bfloat16, else
// float32) with 16-byte aligned pointers (aligned != 0) or not: path 0
// (registers), 1 (general, 16-byte packs) or 2 (general, element by
// element); on path 0 the threads a row, the rows a CTA and the packs a
// thread.
extern "C" int rmsnorm_plan(int D, int bf16, int aligned, int* path,
                            int* tpr, int* rows_per_cta, int* ppt) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(D, bf16 ? 2 : 4, aligned != 0);
  *path = p.path;
  *tpr = p.tpr;
  *rows_per_cta = p.path == 0 ? NT / p.tpr : 1;
  *ppt = p.ppt;
  return (int)cudaSuccess;
}

// x and out are (rows, D) of float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// gamma is (D,) float32.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              int rows, int D, float eps, int bf16,
                              void* stream) {
  if (rows < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      hk::aligned16(x) && hk::aligned16(out) && hk::aligned16(gamma);
  if (bf16)
    return (int)launch<__nv_bfloat16>(x, gamma, out, rows, D, eps, aligned, s);
  return (int)launch<float>(x, gamma, out, rows, D, eps, aligned, s);
}

// The block entry's first kernel: ss[t] = sum of x[t, :]^2 in float32,
// x (rows, D) float32 or bfloat16 (bf16 == 1), ss (rows,) float32.
extern "C" int rmsnorm_block_sumsq_launch(const void* x, void* ss, int rows,
                                          int D, int bf16, void* stream) {
  if (rows < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int V = 16 / (bf16 ? 2 : 4);
  const bool packed = hk::aligned16(x) && D % V == 0;
  float* o = (float*)ss;
  if (bf16) {
    const __nv_bfloat16* xt = (const __nv_bfloat16*)x;
    if (packed)
      rmsnorm_block_sumsq<__nv_bfloat16, 8><<<rows, NT, 0, s>>>(xt, o, D);
    else
      rmsnorm_block_sumsq<__nv_bfloat16, 1><<<rows, NT, 0, s>>>(xt, o, D);
  } else {
    const float* xt = (const float*)x;
    if (packed)
      rmsnorm_block_sumsq<float, 4><<<rows, NT, 0, s>>>(xt, o, D);
    else
      rmsnorm_block_sumsq<float, 1><<<rows, NT, 0, s>>>(xt, o, D);
  }
  return (int)cudaGetLastError();
}

// The block entry's second kernel: out[t, :] = x[t, :] *
// rsqrt(ss[t] / d_total + eps) * gamma, x and out (rows, D) of one type,
// ss (rows,) the rows' float32 sums of squares over all d_total columns,
// gamma (D,) float32, this block's.
extern "C" int rmsnorm_block_scale_launch(const void* x, const void* ss,
                                          const void* gamma, void* out,
                                          int rows, int D, int d_total,
                                          float eps, int bf16,
                                          void* stream) {
  if (rows < 0 || D < 1 || d_total < D) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int V = 16 / (bf16 ? 2 : 4);
  const bool packed = hk::aligned16(x) && hk::aligned16(out) &&
                      hk::aligned16(gamma) && D % V == 0;
  const float* sv = (const float*)ss;
  const float* g = (const float*)gamma;
  if (bf16) {
    const __nv_bfloat16* xt = (const __nv_bfloat16*)x;
    __nv_bfloat16* o = (__nv_bfloat16*)out;
    if (packed)
      rmsnorm_block_scale<__nv_bfloat16, 8><<<rows, NT, 0, s>>>(
          xt, sv, g, o, D, d_total, eps);
    else
      rmsnorm_block_scale<__nv_bfloat16, 1><<<rows, NT, 0, s>>>(
          xt, sv, g, o, D, d_total, eps);
  } else {
    const float* xt = (const float*)x;
    float* o = (float*)out;
    if (packed)
      rmsnorm_block_scale<float, 4><<<rows, NT, 0, s>>>(xt, sv, g, o, D,
                                                        d_total, eps);
    else
      rmsnorm_block_scale<float, 1><<<rows, NT, 0, s>>>(xt, sv, g, o, D,
                                                        d_total, eps);
  }
  return (int)cudaGetLastError();
}
