// Kernel K6: one AdamW step in one pass, out of place:
//   m' = b1 m + (1 - b1) g,  v' = b2 v + (1 - b2) g^2,
//   p' = p - lr ((m' c1) / (sqrt(v' c2) + eps) + wd p),
// in float32, with p' stored in p's type (float32 or bfloat16), g
// float32 or bfloat16, m and v float32.
//
// Replaces src/repro/kernels/adamw.py:24 _adamw_kernel (pallas_call at
// :66).
//
// Bound: bytes.  The function reads p, g, m, v once and writes p', m',
// v': 28 bytes a parameter with p and g in float32, 22 in bfloat16.  At
// N = 218,103,808 (one Llama-3-8B decoder layer) that is 6.107 GB, 1.823
// ms at 3.35 TB/s (4.798 GB, 1.432 ms in bfloat16); its 14 flops a
// parameter are 1/30 of that time.
//
// Design: one grid-stride pass over packs of 4 parameters, as many CTAs
// as the card holds at once, each thread loading a pack of each of the
// four inputs before it computes (16-byte loads for float32 arrays, 8
// for bfloat16 ones); the last N mod 4 parameters go one per thread.
// Where a pointer is not aligned to its pack, the same kernel runs
// parameter by parameter, so any N and any offset are taken.  The hyperparameters come as
// one float32 array on the device, [lr, b1, b2, eps, wd, c1, c2, 0], as
// the TPU kernel's (1, 8) block: the bias corrections c1, c2 are
// computed by the caller, and a learning-rate schedule can live on the
// device, with no host round trip per step.

#include "hand_kernels.cuh"

namespace {

using hk::NT;

struct Hyper {
  float lr, b1, b2, eps, wd, c1, c2, omb1, omb2;
};

// One parameter's update; returns p' and sets m', v'.
__device__ __forceinline__ float update(const Hyper& hy, float pf, float gf,
                                        float mf, float vf, float& m2,
                                        float& v2) {
  m2 = hy.b1 * mf + hy.omb1 * gf;
  v2 = hy.b2 * vf + hy.omb2 * (gf * gf);
  const float upd = (m2 * hy.c1) / (sqrtf(v2 * hy.c2) + hy.eps) + hy.wd * pf;
  return pf - hy.lr * upd;
}

// Packs of V parameters grid-stride, then the n - V * packs left over
// one per thread.
template <typename TP, typename TG, int V>
__global__ void __launch_bounds__(NT)
    adamw_kernel(const float* __restrict__ h, const TP* __restrict__ p,
                 const TG* __restrict__ g, const float* __restrict__ m,
                 const float* __restrict__ v, TP* __restrict__ po,
                 float* __restrict__ mo, float* __restrict__ vo,
                 long long n) {
  const Hyper hy{h[0], h[1], h[2], h[3], h[4], h[5], h[6],
                 1.0f - h[1], 1.0f - h[2]};
  using PP = hk::Pack<TP, V>;
  using PG = hk::Pack<TG, V>;
  using PF = hk::Pack<float, V>;
  const long long packs = n / V;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  for (long long k = first; k < packs; k += stride) {
    const PP pv = reinterpret_cast<const PP*>(p)[k];
    const PG gv = reinterpret_cast<const PG*>(g)[k];
    const PF mv = reinterpret_cast<const PF*>(m)[k];
    const PF vv = reinterpret_cast<const PF*>(v)[k];
    PP pn;
    PF mn, vn;
#pragma unroll
    for (int e = 0; e < V; ++e)
      pn.v[e] = hk::from_f32<TP>(update(hy, hk::to_f32(pv.v[e]),
                                        hk::to_f32(gv.v[e]), mv.v[e],
                                        vv.v[e], mn.v[e], vn.v[e]));
    reinterpret_cast<PP*>(po)[k] = pn;
    reinterpret_cast<PF*>(mo)[k] = mn;
    reinterpret_cast<PF*>(vo)[k] = vn;
  }
  const long long t = packs * V + first;  // the tail, fewer than V
  if (V > 1 && t < n) {
    float m2, v2;
    po[t] = hk::from_f32<TP>(update(hy, hk::to_f32(p[t]), hk::to_f32(g[t]),
                                    m[t], v[t], m2, v2));
    mo[t] = m2;
    vo[t] = v2;
  }
}

template <typename TP, typename TG, int V>
cudaError_t launch(const void* h, const void* p, const void* g,
                   const void* m, const void* v, void* po, void* mo,
                   void* vo, long long n, cudaStream_t s) {
  auto kernel = adamw_kernel<TP, TG, V>;
  int grid = 0;
  cudaError_t err = hk::resident_grid(kernel, n / V, 0, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, 0, s>>>((const float*)h, (const TP*)p, (const TG*)g,
                             (const float*)m, (const float*)v, (TP*)po,
                             (float*)mo, (float*)vo, n);
  return cudaGetLastError();
}

inline bool aligned(const void* x, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(x) % bytes) == 0;
}

// Packs of 4 where every pointer is aligned to its pack, else one
// parameter at a time.
template <typename TP, typename TG>
cudaError_t dispatch(const void* h, const void* p, const void* g,
                     const void* m, const void* v, void* po, void* mo,
                     void* vo, long long n, cudaStream_t s) {
  constexpr int V = 4;
  const bool packed = aligned(p, sizeof(TP) * V) &&
                      aligned(po, sizeof(TP) * V) &&
                      aligned(g, sizeof(TG) * V) && hk::aligned16(m) &&
                      hk::aligned16(v) && hk::aligned16(mo) &&
                      hk::aligned16(vo);
  return packed ? launch<TP, TG, V>(h, p, g, m, v, po, mo, vo, n, s)
                : launch<TP, TG, 1>(h, p, g, m, v, po, mo, vo, n, s);
}

}  // namespace

// h is (8,) float32 [lr, b1, b2, eps, wd, c1, c2, 0]; p, po are (n,) of
// float32 (p_bf16 == 0) or bfloat16; g is (n,) float32 (g_bf16 == 0) or
// bfloat16; m, v, mo, vo are (n,) float32.
extern "C" int adamw_launch(const void* h, const void* p, const void* g,
                            const void* m, const void* v, void* po, void* mo,
                            void* vo, long long n, int p_bf16, int g_bf16,
                            void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (p_bf16)
    return (int)(g_bf16 ? dispatch<bf, bf>(h, p, g, m, v, po, mo, vo, n, s)
                        : dispatch<bf, float>(h, p, g, m, v, po, mo, vo, n, s));
  return (int)(g_bf16 ? dispatch<float, bf>(h, p, g, m, v, po, mo, vo, n, s)
                      : dispatch<float, float>(h, p, g, m, v, po, mo, vo, n, s));
}
