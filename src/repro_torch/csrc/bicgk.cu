// Kernel K2: BiCGK, q = A p and s = A^T r in one pass over A.
//
// Replaces src/repro/kernels/bicgk.py:20 _bicgk_kernel (pallas_call at
// :37), which walks column stripes of A in order on one TPU core.
//
// Bound: bytes.  The function reads A (m x n float32) once, p and r, and
// writes q and s: at m = n = 4096 that is 67.2 MB, 0.020 ms at 3.35 TB/s,
// while its 4mn flops take 1 us at 67 TFLOP/s.  Reading A once is the
// whole point of the fusion (the two library matvecs read it twice).
//
// Design: A is cut into strips of TN columns, and each strip into
// `groups` even ranges of rows, one CTA each; `groups` is chosen from the
// kernel's occupancy (bicgk_groups) so that every CTA of the grid is
// resident at once and the card streams A in one balanced wave (fixed
// tiles left a second, mostly empty wave).  Each warp walks rows of its
// range, R rows at a time with all their loads in flight, coalesced, 16
// bytes a lane where rows are 16-byte aligned.  A row's term of q is a
// warp shuffle sum; each lane keeps its columns' terms of s in
// registers, and the 8 warps combine them in shared memory at the end.
// q's partial goes to q_part[strip][row] and s's to s_part[row
// range][column]; the wrapper sums both over their lead axis, as the
// reference sums its q partials after the kernel.  No atomics, so
// results are the same from run to run.  The partials, (n/TN) x m and
// groups x n floats, are under 1 MB at 4096^2 (1.2 % of A's bytes).

#include "hand_kernels.cuh"

namespace {

using hk::NT;
using hk::WARPS;
constexpr int TN = 128;        // columns per strip
constexpr int COLS = TN / 32;  // columns per lane
constexpr int R = 4;           // rows a warp loads at once

template <int V>
__global__ void __launch_bounds__(NT)
    bicgk_kernel(const float* __restrict__ A, const float* __restrict__ p,
                 const float* __restrict__ r, float* __restrict__ q_part,
                 float* __restrict__ s_part, int m, int n) {
  __shared__ float s_s[WARPS][TN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i0 = (long long)m * blockIdx.y / gridDim.y;
  const long long i1 = (long long)m * (blockIdx.y + 1) / gridDim.y;
  const int j0 = blockIdx.x * TN;

  // lane's columns: pack k holds columns j0 + (k * 32 + lane) * V + e
  float pv[COLS], sacc[COLS];
#pragma unroll
  for (int k = 0; k < COLS / V; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int j = j0 + (k * 32 + lane) * V + e;
      pv[k * V + e] = j < n ? p[j] : 0.0f;
      sacc[k * V + e] = 0.0f;
    }

  // R rows per warp per step, all their loads issued before any use
  for (long long i = i0 + warp; i < i1; i += R * WARPS) {
    hk::Pack<float, V> a[R][COLS / V];
    float ri[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const long long iu = i + u * WARPS;
      const float* row = A + iu * n;
      ri[u] = iu < i1 ? r[iu] : 0.0f;
#pragma unroll
      for (int k = 0; k < COLS / V; ++k) {
        const int jb = j0 + (k * 32 + lane) * V;
        if (iu < i1 && jb + V <= n) {
          a[u][k] = *reinterpret_cast<const hk::Pack<float, V>*>(row + jb);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            a[u][k].v[e] = iu < i1 && jb + e < n ? row[jb + e] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < COLS / V; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          q += a[u][k].v[e] * pv[k * V + e];
          sacc[k * V + e] += a[u][k].v[e] * ri[u];
        }
      q = hk::warp_sum(q);
      const long long iu = i + u * WARPS;
      if (lane == 0 && iu < i1) q_part[(long long)blockIdx.x * m + iu] = q;
    }
  }

#pragma unroll
  for (int k = 0; k < COLS / V; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) s_s[warp][(k * 32 + lane) * V + e] = sacc[k * V + e];
  __syncthreads();
  for (int c = threadIdx.x; c < TN; c += NT) {
    if (j0 + c >= n) break;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += s_s[w][c];
    s_part[(long long)blockIdx.y * n + j0 + c] = s;
  }
}

}  // namespace

// The grid: row ranges per column strip, as many CTAs as the card holds
// at once and at least one row per warp, and the column strips.
extern "C" int bicgk_groups(int m, int n, int* groups, int* strips) {
  return (int)hk::row_groups(bicgk_kernel<4>, bicgk_kernel<1>, m, n, TN,
                             groups, strips);
}

// q_part is (strips, m) and s_part (groups, n), with both counts from
// bicgk_groups.
extern "C" int bicgk_launch(const void* A, const void* p, const void* r,
                            void* q_part, void* s_part, int m, int n,
                            int groups, void* stream) {
  if (m < 0 || n < 0 || groups < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;  // m == 0 still zeroes s_part
  const dim3 grid((n + TN - 1) / TN, groups);
  cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)A, *pp = (const float*)p, *rr = (const float*)r;
  float *qp = (float*)q_part, *sp = (float*)s_part;
  if (n % 4 == 0 && hk::aligned16(A))
    bicgk_kernel<4><<<grid, NT, 0, s>>>(a, pp, rr, qp, sp, m, n);
  else
    bicgk_kernel<1><<<grid, NT, 0, s>>>(a, pp, rr, qp, sp, m, n);
  return (int)cudaGetLastError();
}
