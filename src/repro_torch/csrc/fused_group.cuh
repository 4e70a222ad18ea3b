// Device helpers shared by every kernel that core/cuda_codegen.py
// generates (kernel K1, one kernel per fused plan group).
//
// The generated kernels include this header and add only the per-group
// parts: index arithmetic, the glued per-point expressions of the
// group's elementaries, and the stores.  What lives here is what every
// group needs: the monoids, the warp and block reductions, and the
// grid-wide barrier.  The barrier serves two ends, both in one
// cooperative launch: between the phases of a multi-phase group (a
// consumed reduction finished before its consumers read it), and
// between the items of a phase whose reduce axes were cut into slices
// and the fold of their partials (every slice's partial written before
// any CTA combines them).  Loads and stores convert between a buffer's
// element type (float or __half) and the float32 every map and
// reduction computes in.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace k1 {

// A loaded element as float32, and a float32 value rounded once to a
// buffer's element type.
__device__ __forceinline__ float ld(float x) { return x; }
__device__ __forceinline__ float ld(__half x) { return __half2float(x); }
template <class T> __device__ __forceinline__ T st(float x);
template <> __device__ __forceinline__ float st<float>(float x) { return x; }
template <> __device__ __forceinline__ __half st<__half>(float x) {
  return __float2half_rn(x);
}

// Monoids: identity and combine.  Every reduction of a group combines
// with one of these, in a fixed order that depends on the plan alone
// (the slice counts included), so a kernel's result does not change from
// run to run (no atomics anywhere).
struct Sum {
  static __device__ __forceinline__ float id() { return 0.0f; }
  static __device__ __forceinline__ float op(float a, float b) { return a + b; }
};
struct Max {
  static __device__ __forceinline__ float id() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float op(float a, float b) { return fmaxf(a, b); }
};
struct Min {
  static __device__ __forceinline__ float id() { return CUDART_INF_F; }
  static __device__ __forceinline__ float op(float a, float b) { return fminf(a, b); }
};

// Tree reduction over the 32 lanes of a warp; lane 0 holds the result.
// Every lane must call it (it is a collective of the full warp).
template <class M>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = M::op(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Reduction over all NT threads of the block; thread 0 holds the result.
// ``red`` is shared scratch of NT / 32 floats.  Every thread must call it.
template <class M, int NT>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = warp_reduce<M>(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = M::id();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) r = M::op(r, red[w]);
  }
  __syncthreads();
  return r;
}

// Every block of the grid has finished what came before, and its
// global-memory writes (the consumed reductions' workspace, the slices'
// partials) are visible to all blocks: a phase boundary, or the step
// from the slices to their combine.  Valid only in a cooperative launch
// (cudaLaunchKernelExC with cudaLaunchAttributeCooperative, which stream
// capture records as a graph node) with every block co-resident.
__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

}  // namespace k1
