// Kernel K7: softmax cross-entropy per row, loss_t = logsumexp(x_t) -
// x_t[label_t], in float32 over logits of float32 or bfloat16 and labels
// of int32 or int64.  The mean over rows is taken by the caller, as the
// reference takes it outside its kernel.
//
// A second entry, xent_block_launch, takes one block of columns
// [c0, c0 + cols) of the vocabulary, the logits a tensor-parallel rank
// holds (models/forward.py lm_loss over a vocabulary split), and writes
// for each row the float32 triple (max m, sum of exp(x - m), x[label]
// where the label falls in the block, else 0).  The ranks combine their
// triples (kernels/grad.py XentBlockRows): the largest m, the sums
// rescaled to it, the x[label] summed, then loss = m + log(sum) -
// x[label].  The block may be a column slice of wider logits: rows lie
// `ld` elements apart.
//
// Replaces src/repro/kernels/softmax_xent.py:17 _xent_kernel (pallas_call
// at :35).
//
// Bound: bytes.  The function reads the (T, V) logits and the labels
// once and writes T losses: at (T, V) = (8192, 128256) (Llama-3-8B's
// vocabulary) that is 4.203 GB in float32, 1.2545 ms at 3.35 TB/s, and
// 2.101 GB, 0.6273 ms, in bfloat16.  Its exponentials, one a logit, take
// a third of that time or less on the special-function units.
//
// Design: one CTA per row, and the row is read once.  Each thread walks
// the row grid-stride, UNROLL packs at a time with all their loads in
// flight (16-byte packs where V and the pointer allow, one logit at a
// time otherwise), and keeps an online (max, sum of exp(x - max)) in
// float32: a pack's max rescales the running sum at most once, so there
// is about one exponential a logit.  The thread holding column label_t
// keeps x[label] on the way.  The (max, sum) pairs combine across the
// warp by shuffles and across the 8 warps in shared memory.  A label
// outside [0, V) contributes no logit, as in the TPU kernel's masked
// sum.  No atomics: each row's loss is the same from run to run.  The
// block entry is the same kernel with another epilogue: it reads the
// block's logits once (bound: T * cols of them) and writes 12 bytes a
// row in place of 4.

#include "hand_kernels.cuh"

#include <math_constants.h>

namespace {

using hk::NT;
using hk::WARPS;
constexpr int UNROLL = 4;

struct MaxSum {
  float m, s;
};

// (m1, s1) and (m2, s2) as one: the larger max, the sums rescaled to it.
__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  if (a.m == -CUDART_INF_F) return b;
  if (b.m == -CUDART_INF_F) return a;
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// Where a row's result goes: the loss (the whole row), or the block's
// triple.
struct Out {
  float* loss;  // (rows,), or the triple's max
  float* sum;   // (rows,) of the triple, null for the loss
  float* xl;    // (rows,) of the triple, null for the loss
};

// One CTA a row of `cols` logits, rows `ld` apart; `col0` is the row's
// first column in the vocabulary (the label's offset).
template <typename T, int V, typename L, bool kTriple>
__global__ void __launch_bounds__(NT)
    xent_kernel(const T* __restrict__ x, const L* __restrict__ labels,
                Out out, int cols, long long ld, long long col0) {
  __shared__ MaxSum red[WARPS];
  __shared__ float picked[WARPS];
  using P = hk::Pack<T, V>;
  const long long row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * ld);
  const long long label = (long long)labels[row] - col0;
  const int packs = cols / V;  // V divides cols (the launcher picks V so)
  MaxSum acc{-CUDART_INF_F, 0.0f};
  float xl = 0.0f;
  for (int k0 = threadIdx.x; k0 < packs; k0 += UNROLL * NT) {
    P pk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * NT;
      if (k < packs) pk[u] = xr[k];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * NT;
      if (k >= packs) break;
      float f[V], pm = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        f[e] = hk::to_f32(pk[u].v[e]);
        pm = fmaxf(pm, f[e]);
      }
      if (pm > acc.m) {
        acc.s *= expf(acc.m - pm);  // exp(-inf) = 0 on the first pack
        acc.m = pm;
      }
      const long long c0 = (long long)k * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc.s += expf(f[e] - acc.m);
        if (label == c0 + e) xl = f[e];
      }
    }
  }
  // the warp, then the CTA
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const MaxSum o{__shfl_xor_sync(0xffffffffu, acc.m, off),
                   __shfl_xor_sync(0xffffffffu, acc.s, off)};
    acc = combine(acc, o);
  }
  xl = hk::warp_sum(xl);  // one thread of the row holds it, the rest 0
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = acc;
    picked[warp] = xl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    MaxSum all = red[0];
    float x_label = picked[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      all = combine(all, red[w]);
      x_label += picked[w];
    }
    if constexpr (kTriple) {
      out.loss[row] = all.m;
      out.sum[row] = all.s;
      out.xl[row] = x_label;
    } else {
      out.loss[row] = all.m + logf(all.s) - x_label;
    }
  }
}

template <typename T, int V, bool kTriple>
cudaError_t launch(const void* x, const void* labels, int label64, Out out,
                   int rows, int cols, long long ld, long long col0,
                   cudaStream_t s) {
  if (label64)
    xent_kernel<T, V, long long, kTriple><<<rows, NT, 0, s>>>(
        (const T*)x, (const long long*)labels, out, cols, ld, col0);
  else
    xent_kernel<T, V, int, kTriple><<<rows, NT, 0, s>>>(
        (const T*)x, (const int*)labels, out, cols, ld, col0);
  return cudaGetLastError();
}

// 16-byte packs where the row's length, the row stride and the pointer
// allow them, one logit at a time otherwise.
template <bool kTriple>
cudaError_t dispatch(const void* x, const void* labels, int label64, Out out,
                     int rows, int cols, long long ld, long long col0,
                     int bf16, cudaStream_t s) {
  if (rows < 0 || cols < 1 || ld < cols) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const bool aligned = hk::aligned16(x);
  if (bf16)
    return cols % 8 == 0 && ld % 8 == 0 && aligned
               ? launch<__nv_bfloat16, 8, kTriple>(x, labels, label64, out,
                                                   rows, cols, ld, col0, s)
               : launch<__nv_bfloat16, 1, kTriple>(x, labels, label64, out,
                                                   rows, cols, ld, col0, s);
  return cols % 4 == 0 && ld % 4 == 0 && aligned
             ? launch<float, 4, kTriple>(x, labels, label64, out, rows, cols,
                                         ld, col0, s)
             : launch<float, 1, kTriple>(x, labels, label64, out, rows, cols,
                                         ld, col0, s);
}

}  // namespace

// x is (rows, cols) of float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// labels is (rows,) of int32 (label64 == 0) or int64; loss is (rows,)
// float32.
extern "C" int xent_launch(const void* x, const void* labels, void* loss,
                           int rows, int cols, int bf16, int label64,
                           void* stream) {
  return (int)dispatch<false>(x, labels, label64,
                              Out{(float*)loss, nullptr, nullptr}, rows,
                              cols, cols, 0, bf16, (cudaStream_t)stream);
}

// The block entry: x holds rows of `cols` logits `ld` elements apart,
// columns [c0, c0 + cols) of the vocabulary; m, sum and xl are (rows,)
// float32: the row's max, its sum of exp(x - max) and x[label] (0 where
// the label lies outside the block).
extern "C" int xent_block_launch(const void* x, const void* labels, void* m,
                                 void* sum, void* xl, int rows, int cols,
                                 long long ld, long long c0, int bf16,
                                 int label64, void* stream) {
  return (int)dispatch<true>(x, labels, label64,
                             Out{(float*)m, (float*)sum, (float*)xl}, rows,
                             cols, ld, c0, bf16, (cudaStream_t)stream);
}
