// Kernel K3: GEMVER, B = A + u1 v1^T + u2 v2^T; x = beta B^T y + z;
// w = alpha B x, as two kernels with the cheap x = beta t + z between them.
//
// Replaces src/repro/kernels/gemver.py:26 _k1 and :38 _k2 (pallas_calls
// at :52 and :75).
//
// Bound: bytes.  gemver_k1 reads A and writes B (m x n float32 each),
// gemver_k2 reads B back: three matrix streams, at m = n = 4096 201 MB,
// 0.060 ms at 3.35 TB/s (the library sequence moves B five times or
// more).  B must reach device memory because it is an output, and x
// needs all of B^T y before B x can start, so three streams is the least
// two kernels can do.
//
// gemver_k1: A is cut into strips of TN columns, and each strip into
// `groups` even ranges of rows, one CTA each, with `groups` chosen from
// the kernel's occupancy (gemver_groups) so that the whole grid is
// resident at once: one balanced wave.  A warp walks rows of its range,
// R rows at a time with all their loads in flight, forms B's rows from A
// with 16-byte loads where rows are aligned, stores them, and each lane
// adds its columns' terms B_ij y_i in registers; the 8 warps combine
// those in shared memory and write them as t_part[row range][column].
// The wrapper sums t_part over its lead axis (the reference also
// combines its per-stripe partials outside the kernel).
// gemver_k2: one warp per row of B, a coalesced dot product with x,
// times alpha read from device memory.  No atomics.

#include "hand_kernels.cuh"

namespace {

using hk::NT;
using hk::WARPS;
constexpr int TN = 128;        // gemver_k1's columns per strip
constexpr int COLS = TN / 32;  // columns per lane
constexpr int R = 4;           // rows a warp loads at once

template <int V>
__global__ void __launch_bounds__(NT)
    gemver_k1(const float* __restrict__ A, const float* __restrict__ u1,
              const float* __restrict__ v1, const float* __restrict__ u2,
              const float* __restrict__ v2, const float* __restrict__ y,
              float* __restrict__ B, float* __restrict__ t_part, int m, int n) {
  __shared__ float t_s[WARPS][TN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i0 = (long long)m * blockIdx.y / gridDim.y;
  const long long i1 = (long long)m * (blockIdx.y + 1) / gridDim.y;
  const int j0 = blockIdx.x * TN;
  float v1r[COLS], v2r[COLS], tacc[COLS];
#pragma unroll
  for (int k = 0; k < COLS / V; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int j = j0 + (k * 32 + lane) * V + e;
      v1r[k * V + e] = j < n ? v1[j] : 0.0f;
      v2r[k * V + e] = j < n ? v2[j] : 0.0f;
      tacc[k * V + e] = 0.0f;
    }

  // R rows per warp per step, all their loads issued before any use
  for (long long i = i0 + warp; i < i1; i += R * WARPS) {
    hk::Pack<float, V> b[R][COLS / V];
    float a1[R], a2[R], yi[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const long long iu = i + u * WARPS;
      const bool in = iu < i1;
      a1[u] = in ? u1[iu] : 0.0f;
      a2[u] = in ? u2[iu] : 0.0f;
      yi[u] = in ? y[iu] : 0.0f;
#pragma unroll
      for (int k = 0; k < COLS / V; ++k) {
        const int jb = j0 + (k * 32 + lane) * V;
        if (in && jb + V <= n) {
          b[u][k] = *reinterpret_cast<const hk::Pack<float, V>*>(A + iu * n + jb);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            b[u][k].v[e] = in && jb + e < n ? A[iu * n + jb + e] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const long long iu = i + u * WARPS;
#pragma unroll
      for (int k = 0; k < COLS / V; ++k) {
        const int jb = j0 + (k * 32 + lane) * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float& v = b[u][k].v[e];
          v = v + a1[u] * v1r[k * V + e] + a2[u] * v2r[k * V + e];
          tacc[k * V + e] += v * yi[u];
        }
        if (iu >= i1 || jb >= n) continue;
        if (jb + V <= n) {
          *reinterpret_cast<hk::Pack<float, V>*>(B + iu * n + jb) = b[u][k];
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (jb + e < n) B[iu * n + jb + e] = b[u][k].v[e];
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < COLS / V; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) t_s[warp][(k * 32 + lane) * V + e] = tacc[k * V + e];
  __syncthreads();
  for (int c = threadIdx.x; c < TN; c += NT) {
    if (j0 + c >= n) break;
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += t_s[w][c];
    t_part[(long long)blockIdx.y * n + j0 + c] = t;
  }
}

template <int V>
__global__ void __launch_bounds__(NT)
    gemver_k2(const float* __restrict__ B, const float* __restrict__ x,
              const float* __restrict__ alpha, float* __restrict__ w, int m,
              int n) {
  const long long i = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= m) return;
  const float* row = B + i * (long long)n;
  float acc = 0.0f;
#pragma unroll 4
  for (int j = lane * V; j < n; j += 32 * V) {
    const auto b = *reinterpret_cast<const hk::Pack<float, V>*>(row + j);
    const auto xv = *reinterpret_cast<const hk::Pack<float, V>*>(x + j);
#pragma unroll
    for (int e = 0; e < V; ++e) acc += b.v[e] * xv.v[e];
  }
  acc = hk::warp_sum(acc);
  if (lane == 0) w[i] = alpha[0] * acc;
}

}  // namespace

// gemver_k1's grid: row ranges per column strip, as many CTAs as the
// card holds at once and at least one row per warp, and the column strips.
extern "C" int gemver_groups(int m, int n, int* groups, int* strips) {
  return (int)hk::row_groups(gemver_k1<4>, gemver_k1<1>, m, n, TN, groups,
                             strips);
}

// B is (m, n); t_part is (groups, n).
extern "C" int gemver_k1_launch(const void* A, const void* u1, const void* v1,
                                const void* u2, const void* v2, const void* y,
                                void* B, void* t_part, int m, int n,
                                int groups, void* stream) {
  if (m < 0 || n < 0 || groups < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;  // m == 0 still zeroes t_part
  const dim3 grid((n + TN - 1) / TN, groups);
  cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)A, *pu1 = (const float*)u1,
              *pv1 = (const float*)v1, *pu2 = (const float*)u2,
              *pv2 = (const float*)v2, *py = (const float*)y;
  float *b = (float*)B, *tp = (float*)t_part;
  if (n % 4 == 0 && hk::aligned16(A) && hk::aligned16(B))
    gemver_k1<4><<<grid, NT, 0, s>>>(a, pu1, pv1, pu2, pv2, py, b, tp, m, n);
  else
    gemver_k1<1><<<grid, NT, 0, s>>>(a, pu1, pv1, pu2, pv2, py, b, tp, m, n);
  return (int)cudaGetLastError();
}

// w (m,) = alpha[0] * B x; alpha is a one-element device array.
extern "C" int gemver_k2_launch(const void* B, const void* x, const void* alpha,
                                void* w, int m, int n, void* stream) {
  if (m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const long long blocks = ((long long)m * 32 + NT - 1) / NT;
  cudaStream_t s = (cudaStream_t)stream;
  const float *b = (const float*)B, *xx = (const float*)x,
              *al = (const float*)alpha;
  float* ww = (float*)w;
  if (n % 4 == 0 && hk::aligned16(B) && hk::aligned16(x))
    gemver_k2<4><<<(unsigned)blocks, NT, 0, s>>>(b, xx, al, ww, m, n);
  else
    gemver_k2<1><<<(unsigned)blocks, NT, 0, s>>>(b, xx, al, ww, m, n);
  return (int)cudaGetLastError();
}
