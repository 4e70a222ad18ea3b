// Kernel K5: single-token GQA decode attention, o = softmax(q K^T * scale)
// V per query head, the G = Hq / Hkv query heads of one KV head sharing
// its K/V stream; float32 or bfloat16 in and out, float32 inside.
//
// Replaces src/repro/kernels/decode_attention.py:20 _decode_attn_kernel
// (pallas_call at :64), which walks the KV axis in order on one TPU core
// and carries the online softmax (acc, m, l) across it in scratch.
//
// Bound: bytes.  The function reads K and V once (q is small) and writes
// o: at (B, Hq, Hkv, S, d) = (8, 32, 8, 8192, 128) in bfloat16, one
// Llama-3-8B layer's decode step for 8 sequences at an 8k context, that
// is 268.4 MB, 0.0801 ms at 3.35 TB/s (536.9 MB, 0.1603 ms in float32);
// its 4 G flops per K/V element pair are far below the card's rate.
//
// Design: flash-decoding in two kernels, because B * Hkv CTAs (64 at the
// shape above) would leave half of the 132 SMs idle.
// * decode_attention_split: one CTA per (b, h_kv, chunk of S), with the
//   chunk count from the kernel's occupancy (decode_attention_chunks) so
//   that one wave fills the card.  The CTA reads its K/V chunk once for
//   all G query heads, in tiles of TS positions: the 8 warps compute the
//   tile's G x TS scores (a row of K spread over a power-of-two group of
//   lanes, 16-byte loads where d and the pointers allow, q from shared
//   memory, a shuffle sum over the group), then per head the tile's max,
//   the rescale of the running (acc, m, l) and the weights p = exp(s -
//   m), then p V with threads over (head, slice of d) and the tile's rows
//   cut among thread groups, summed in shared memory.  It writes its
//   partials (acc[G][d], m[G], l[G]) in float32.
// * decode_attention_combine: one CTA per (b, query head) rescales the
//   chunks' partials by exp(m_c - m), divides by sum_c l_c exp(m_c - m),
//   and writes o in q's type.
// Scores and sums are plain FMA loops, tails of S and d are masked, any
// d up to D_MAX is taken, and there are no atomics: the same inputs give
// the same bits every run.

#include "hand_kernels.cuh"

#include <math_constants.h>

namespace {

using hk::NT;
using hk::WARPS;
constexpr int TS = 64;      // positions of one tile
constexpr int EMAX = 8;     // elements of a K row one lane holds (d <= 256)
constexpr int D_MAX = 256;  // the largest head dim taken

// Shared memory of the split kernel, in floats: q, acc and the scores of
// a tile, the per-head (m, l, alpha), and the p V partials of RG row
// groups.
__host__ __device__ inline int row_groups_of(int G, int d, int vec) {
  const int pairs = G * (d / vec);
  return pairs < NT ? NT / pairs : 1;
}
__host__ __device__ inline int smem_floats(int G, int d, int vec) {
  return 2 * G * d + G * TS + 3 * G + row_groups_of(G, d, vec) * G * d;
}

// VEC consecutive floats from shared memory.
template <int VEC>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = x.x;
      out[4 * i + 1] = x.y;
      out[4 * i + 2] = x.z;
      out[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = p[e];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT) decode_attention_split(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int S, int Hkv,
    int G, int d, int chunks, int len, float scale) {
  extern __shared__ __align__(16) float sm[];
  using P = hk::Pack<T, VEC>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int b = bh / Hkv, h = bh % Hkv;
  const long long s0 = (long long)c * len;
  const long long s1 = s0 + len < S ? s0 + len : S;
  const int Gd = G * d, NV = d / VEC;
  int LPR = 1;  // lanes per K row: a power of two, at most 32
  while (LPR < NV && LPR < 32) LPR <<= 1;
  const int RPW = 32 / LPR, sub = lane / LPR, ln = lane % LPR;
  const int RG = row_groups_of(G, d, VEC), pairs = G * NV;

  float* q_s = sm;
  float* acc_s = q_s + Gd;
  float* sc = acc_s + Gd;
  float* m_s = sc + G * TS;
  float* l_s = m_s + G;
  float* al_s = l_s + G;
  float* red = al_s + G;

  // the G query heads of KV head h are q[b, h*G .. h*G + G)
  const T* qb = q + ((long long)b * Hkv * G + (long long)h * G) * d;
  for (int i = tid; i < Gd; i += NT) {
    q_s[i] = hk::to_f32(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += NT) {
    m_s[g] = -CUDART_INF_F;
    l_s[g] = 0.0f;
  }
  __syncthreads();

  const long long row_stride = (long long)Hkv * d;
  const T* kb = k + ((long long)b * S * Hkv + h) * d;
  const T* vb = v + ((long long)b * S * Hkv + h) * d;
  for (long long t0 = s0; t0 < s1; t0 += TS) {
    const int nt = (int)(s1 - t0 < TS ? s1 - t0 : TS);

    // scores: warp rows r0 + sub, each row over LPR lanes
#pragma unroll 2
    for (int r0 = warp * RPW; r0 < TS; r0 += WARPS * RPW) {
      const int t = r0 + sub;
      const bool ok = t < nt;
      const T* row = kb + (t0 + t) * row_stride;
      float kv[EMAX];
#pragma unroll
      for (int j = 0; j < EMAX / VEC; ++j) {
        const int vi = ln + j * LPR;
        if (ok && vi < NV) {
          const P pk = *reinterpret_cast<const P*>(row + vi * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[j * VEC + e] = hk::to_f32(pk.v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[j * VEC + e] = 0.0f;
        }
      }
      for (int g = 0; g < G; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < EMAX / VEC; ++j) {
          const int vi = ln + j * LPR;
          if (vi < NV) {
            float qv[VEC];
            lds<VEC>(q_s + g * d + vi * VEC, qv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) part += qv[e] * kv[j * VEC + e];
          }
        }
        for (int off = LPR >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (ln == 0 && ok) sc[g * TS + t] = part * scale;
      }
    }
    __syncthreads();

    // per head: the tile's max, the rescale, the weights and their sum
    for (int g = warp; g < G; g += WARPS) {
      float s[TS / 32], mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) {
        const int t = lane + 32 * i;
        s[i] = t < nt ? sc[g * TS + t] : -CUDART_INF_F;
        mx = fmaxf(mx, s[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < TS / 32; ++i) {
        const int t = lane + 32 * i;
        const float p = t < nt ? expf(s[i] - m_new) : 0.0f;
        sc[g * TS + t] = p;
        sum += p;
      }
      sum = hk::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        al_s[g] = alpha;
      }
    }
    __syncthreads();

    // p V: thread (row group, head, slice of d), rows rg, rg + RG, ...
    const int first = RG > 1 ? tid % pairs : tid;
    const int rg = RG > 1 ? tid / pairs : 0;
    if (rg < RG) {
      for (int pid = first; pid < pairs; pid += (RG > 1 ? pairs : NT)) {
        const int g = pid / NV, vi = pid % NV;
        const float* pg = sc + g * TS;
        const T* col = vb + vi * VEC;
        float a[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = 0.0f;
#pragma unroll 4
        for (int t = rg; t < nt; t += RG) {
          const P pk = *reinterpret_cast<const P*>(col + (t0 + t) * row_stride);
          const float w = pg[t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[e] += w * hk::to_f32(pk.v[e]);
        }
        float* dst = red + rg * Gd + g * d + vi * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = a[e];
        if (RG > 1) break;
      }
    }
    __syncthreads();
    for (int o = tid; o < Gd; o += NT) {
      float s = acc_s[o] * al_s[o / d];
      for (int r = 0; r < RG; ++r) s += red[r * Gd + o];
      acc_s[o] = s;
    }
    __syncthreads();
  }

  const long long at = blockIdx.x;  // bh * chunks + c
  for (int o = tid; o < Gd; o += NT) acc_part[at * Gd + o] = acc_s[o];
  for (int g = tid; g < G; g += NT) {
    m_part[at * G + g] = m_s[g];
    l_part[at * G + g] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) decode_attention_combine(
    const float* __restrict__ acc_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ out, int Hq, int G,
    int d, int chunks) {
  const int bq = blockIdx.x;           // b * Hq + query head
  const int hq = bq % Hq;
  const long long base = (long long)(bq / Hq * (Hq / G) + hq / G) * chunks;
  const int g = hq % G;
  float m = -CUDART_INF_F;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, m_part[(base + c) * G + g]);
  float l = 0.0f;
  for (int c = 0; c < chunks; ++c)
    l += l_part[(base + c) * G + g] * expf(m_part[(base + c) * G + g] - m);
  for (int e = threadIdx.x; e < d; e += NT) {
    float o = 0.0f;
    for (int c = 0; c < chunks; ++c)
      o += acc_part[((base + c) * G + g) * d + e] *
           expf(m_part[(base + c) * G + g] - m);
    out[(long long)bq * d + e] = hk::from_f32<T>(o / l);
  }
}

template <typename T>
constexpr int vec_of() {
  return 16 / sizeof(T);
}

// The split kernel's instance, its vector width and shared memory.
template <typename T>
void split_kernel(int d, bool aligned, void** kernel, int* vec) {
  if (d % vec_of<T>() == 0 && aligned) {
    *kernel = (void*)decode_attention_split<T, vec_of<T>()>;
    *vec = vec_of<T>();
  } else {
    *kernel = (void*)decode_attention_split<T, 1>;
    *vec = 1;
  }
}

cudaError_t prepare(void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// The split's grid: chunks of len positions per (b, h_kv), as many CTAs
// as the card holds at once over bh = B * Hkv pairs, at least one tile
// per chunk, no chunk empty.
extern "C" int decode_attention_chunks(int bh, int S, int G, int d, int bf16,
                                       int* chunks, int* len) {
  if (bh < 1 || S < 1 || G < 1 || d < 1 || d > D_MAX)
    return (int)cudaErrorInvalidValue;
  void* kernel = nullptr;
  int vec = 1;
  if (bf16)
    split_kernel<__nv_bfloat16>(d, true, &kernel, &vec);
  else
    split_kernel<float>(d, true, &kernel, &vec);
  const int smem = smem_floats(G, d, vec) * (int)sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = prepare(kernel, smem)) != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, (const void*)kernel, NT, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int c = per_sm * sms / bh;
  if (c < 1) c = 1;
  int l = (S + c - 1) / c;
  if (l < TS) l = TS;
  *len = l;
  *chunks = (S + l - 1) / l;
  return (int)cudaSuccess;
}

// q: (B, Hq, d); k, v: (B, S, Hkv, d), all float32 (bf16 == 0) or
// bfloat16; acc_part: (B * Hkv * chunks, G, d) and m_part, l_part:
// (B * Hkv * chunks, G) float32, with chunks and len from
// decode_attention_chunks.
extern "C" int decode_attention_split_launch(
    const void* q, const void* k, const void* v, void* acc_part,
    void* m_part, void* l_part, int B, int Hq, int Hkv, int S, int d,
    int chunks, int len, float scale, int bf16, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || d < 1 || d > D_MAX ||
      chunks < 1 || (long long)chunks * len < S)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const bool aligned = hk::aligned16(k) && hk::aligned16(v);
  void* kernel = nullptr;
  int vec = 1;
  if (bf16)
    split_kernel<__nv_bfloat16>(d, aligned, &kernel, &vec);
  else
    split_kernel<float>(d, aligned, &kernel, &vec);
  const int smem = smem_floats(G, d, vec) * (int)sizeof(float);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, (void*)&acc_part,
                  (void*)&m_part, (void*)&l_part, (void*)&S, (void*)&Hkv,
                  (void*)&G, (void*)&d, (void*)&chunks, (void*)&len,
                  (void*)&scale};
  err = cudaLaunchKernel((const void*)kernel, dim3(B * Hkv * chunks),
                         dim3(NT), args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out: (B, Hq, d) in q's type, from the split's partials.
extern "C" int decode_attention_combine_launch(
    const void* acc_part, const void* m_part, const void* l_part, void* out,
    int B, int Hq, int Hkv, int d, int chunks, int bf16, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || d < 1 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)acc_part;
  const float* m = (const float*)m_part;
  const float* l = (const float*)l_part;
  if (bf16)
    decode_attention_combine<__nv_bfloat16><<<B * Hq, NT, 0, s>>>(
        a, m, l, (__nv_bfloat16*)out, Hq, G, d, chunks);
  else
    decode_attention_combine<float><<<B * Hq, NT, 0, s>>>(
        a, m, l, (float*)out, Hq, G, d, chunks);
  return (int)cudaGetLastError();
}
