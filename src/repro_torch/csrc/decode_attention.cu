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
// its 4 G flops per K/V element pair are far below the card's rate.  So
// the design keeps device memory busy without a break, and keeps the
// work on each K/V element small enough to hide under the stream.
//
// Design: flash-decoding in two kernels, because B * Hkv CTAs (64 at the
// shape above) would leave half of the 132 SMs idle.
// * The split: one CTA per (b, h_kv, chunk of S, group of at most GH_MAX
//   query heads; G <= 8 is one group), the chunk count from the
//   kernel's occupancy so that one wave fills the card
//   (kernels/decode_attention.py: chunk_plan, whole tiles a chunk).
//   Each CTA streams its chunk of K and V through a ring of 3-4 shared-
//   memory stages, the next stages in flight while one is used, and
//   every thread copies exactly the rows and slices it (or its warp)
//   reads later, so the loop over the chunk has no CTA barrier: each warp
//   streams and computes at its own pace.  Each row slot (or warp) keeps
//   its own online softmax (m, l and the p V accumulators, in registers
//   across the chunk, m in log2 units with q scaled by scale * log2 e);
//   at the end the slots are merged in slot order through shared memory
//   (M = max m_r; sum 2^(m_r - M) acc_r and 2^(m_r - M) l_r) and written
//   as float32 partials acc[G][d], m[G], l[G].  Two instances:
//   - decode_attention_split_mma, bfloat16 with d of 64, 128 or 256 and
//     16-byte aligned K and V: 4 warps, each taking 16-row blocks of
//     the chunk into its own ring, one cp.async.bulk a row on the
//     stage's mbarrier.  S^T = Q K^T on the tensor cores (mma.sync
//     m16n8k16, heads padded to 16), p V as O^T += V^T P^T with p split
//     into bfloat16 hi + lo parts, all accumulated in float32.  On FMA
//     the work on a bfloat16 row (G FMAs an element for the scores and G
//     for p V, plus the shuffles that sum a row's lanes) could not be
//     hidden under the stream.
//   - decode_attention_split, every other case: 256 threads over (row,
//     16-byte slice of d), LPR lanes a row holding up to 8 elements
//     each, 16-byte cp.async.cg copies (plain loads where d or the
//     pointers are not aligned).  Each thread keeps q for its slice in
//     registers, reads each K and V element of its slice once from
//     shared memory, and the LPR lanes of a row sum their partial dot
//     products with a transposing shuffle tree (log2 GH steps that halve
//     the heads a lane carries, then a butterfly) and gather the heads
//     back.  p V stays float32 FMA: the partials are held to 1e-4
//     against their plain version, which TF32 would miss.
// * decode_attention_combine: one CTA per (b, query head), a warp per
//   chunk up to 32 warps: each warp loads a batch of its chunks' (m_c,
//   l_c, acc_c) at once and folds them with a running max; the warps are
//   merged in warp order.  At B * Hq = 1 and ~256 chunks that is one
//   round of loads, not one thread walking the chunks.  It is launched
//   as a programmatic dependent of the split, so that its launch
//   overlaps the split's last CTAs.
// Only the valid prefix [0, kv_len) of each batch's S rows is read and
// chunked (a KV cache allocated at its full horizon and filled up to the
// decode position; S stays the row count of a batch's slab), so a decode
// step attends its cache in place, without a copy of the prefix.
// kv_len is a host integer, or is read from device memory: then the
// chunks are planned once for all S and a chunk past kv_len writes empty
// partials (m = -inf, l = 0, acc = 0) that the combine skips, so one
// captured CUDA graph of a decode step serves every position.  Tails
// of kv_len and d are masked; any d up to D_MAX is taken; no atomics:
// the same inputs give the same bits every run.

#include "hand_kernels.cuh"

#include <math_constants.h>

namespace {

using hk::NT;
constexpr int TS_MAX = 64;       // rows of a tile
constexpr int EMAX = 8;          // elements of a row one lane holds
constexpr int D_MAX = 256;       // the largest head dim taken
constexpr int GH_MAX = 8;        // query heads one CTA carries
constexpr int TILE_BYTES = 32 * 1024;   // K + V of a 64-row tile at most
constexpr int RING4_BYTES = 96 * 1024;  // four stages where they fit
constexpr int COMBINE_WARPS = 32;
constexpr int MMA_WARPS = 4;     // warps of the tensor-core instance
constexpr int MMA_ROWS = 16;     // rows a warp takes at a time there

// Lanes a row on the FMA instance: a power of two (at most 32) such that
// each lane holds at most jp pieces of the row's nv.
__host__ __device__ inline int lanes_of(int nv, int jp) {
  const int want = (nv + jp - 1) / jp;
  int l = 1;
  while (l < want && l < 32) l <<= 1;
  return l;
}

// The split kernel's layout for G query heads of dim d, elements of `es`
// bytes, `vec` elements a 16-byte piece (1 on the element-by-element
// instance); `mma` picks the tensor-core instance (bfloat16, d % 16 ==
// 0, 16-byte aligned K and V).
struct Config {
  int mma, threads;  // the instance; threads a CTA
  int vec, lpr;      // elements a piece; lanes a row (the FMA instance)
  int slots;         // row slots merged at the end of a chunk
  int groups, gh;    // head groups a (b, h_kv); heads a group
  int gh_t;          // gh rounded up to a power of two (the instance)
  int ts, stages;    // rows a tile (all warps); tiles in the ring
  int pitch;         // elements from one row of a stage to the next
  int body;          // bytes of the ring (or of the end-of-chunk sums)
  int smem;          // dynamic shared memory in all
};

inline Config config_of(int G, int d, int es, int vec, bool mma) {
  Config c;
  c.mma = mma;
  c.vec = vec;
  c.lpr = lanes_of(d / vec, EMAX / vec);
  c.groups = (G + GH_MAX - 1) / GH_MAX;
  c.gh = (G + c.groups - 1) / c.groups;
  c.gh_t = 1;
  while (c.gh_t < c.gh) c.gh_t <<= 1;
  int ring;
  if (mma) {  // per warp and stage: 16 rows of K and of V, rows padded
    c.threads = MMA_WARPS * 32;
    c.slots = MMA_WARPS;
    c.ts = MMA_WARPS * MMA_ROWS;
    c.pitch = d + 8;  // 16 bytes more: ldmatrix rows hit distinct banks
    const int stage = MMA_WARPS * 2 * MMA_ROWS * c.pitch * es;
    c.stages = 4 * stage <= RING4_BYTES ? 4 : 3;
    ring = c.stages * stage;
  } else {
    c.threads = NT;
    c.slots = NT / c.lpr;
    const int row = d * es;
    c.ts = 2 * TS_MAX * row <= TILE_BYTES ? TS_MAX : TS_MAX / 2;
    c.pitch = d;
    const int stage = 2 * c.ts * row;
    c.stages = 4 * stage <= RING4_BYTES ? 4 : 3;
    ring = c.stages * stage;
  }
  const int sums = c.slots * c.gh_t * d * 4;
  c.body = ((ring > sums ? ring : sums) + 15) / 16 * 16;
  // then the slots' m and l, and the tensor-core instance's mbarriers
  c.smem = c.body + 2 * c.slots * c.gh_t * 4;
  if (mma) c.smem = (c.smem + 7) / 8 * 8 + MMA_WARPS * c.stages * 8;
  return c;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most stages - 2 copy groups of this thread are pending.
__device__ __forceinline__ void cp_async_wait_stage(int stages) {
  if (stages == 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A lane's elements of one row of a tile in shared memory: pieces ln,
// ln + LPR, ... (the first jp) of VEC elements, zeros past d or where
// !ok.
template <typename T, int VEC>
__device__ __forceinline__ void row_slice(const T* row, int ln, int LPR,
                                          int NV, int jp, bool ok,
                                          float* out) {
  using P = hk::Pack<T, VEC>;
#pragma unroll
  for (int j = 0; j < EMAX / VEC; ++j) {
    const int vi = ln + j * LPR;
    if (j >= jp) break;
    if (ok && vi < NV) {
      const P pk = *reinterpret_cast<const P*>(row + vi * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[j * VEC + e] = hk::to_f32(pk.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[j * VEC + e] = 0.0f;
    }
  }
}

// Sums v[0..GH) over the LPR lanes of a row (an aligned power-of-two
// group of lanes).  While a lane carries more than one head and lanes
// are left, each step sends half of its heads to its partner and keeps
// the other half, so that the lane ends with GH / LPR heads (at least
// one) in v[0..), heads ln * GH / LPR onwards.  Every lane of the warp
// must call it.
template <int GH>
__device__ __forceinline__ void reduce_heads(float (&v)[GH], int ln,
                                             int LPR) {
  int off = LPR >> 1;
#pragma unroll
  for (int half = GH / 2; half >= 1; half >>= 1) {
    if (off >= 1) {
      const bool up = (ln & off) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      off >>= 1;
    }
  }
  for (; off >= 1; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
}

// Every head's sum of v over the LPR lanes of a row, in every lane of
// the row: the transposing tree, then GH shuffles that gather the heads
// from the lanes holding them (LPR >= GH), or a butterfly a head.
template <int GH>
__device__ __forceinline__ void all_heads(float (&v)[GH], int lane, int ln,
                                          int LPR) {
  if (LPR >= GH) {
    reduce_heads<GH>(v, ln, LPR);
    if (GH > 1) {
      const float mine = v[0];
      const int first = lane - ln, step = LPR / GH;
#pragma unroll
      for (int g = 0; g < GH; ++g)
        v[g] = __shfl_sync(0xffffffffu, mine, first + g * step);
    }
  } else {
    for (int off = LPR >> 1; off >= 1; off >>= 1)
#pragma unroll
      for (int g = 0; g < GH; ++g)
        v[g] += __shfl_xor_sync(0xffffffffu, v[g], off);
  }
}

// The end of a chunk: the row slots' (m, l, acc), in shared memory as
// sums [slots][GH][d] and ms, ls [slots][GH] (m in log2 units), merged
// in slot order, M = max m_r, acc = sum 2^(m_r - M) acc_r and l = sum
// 2^(m_r - M) l_r, and written as the chunk's partials (row `at`, heads
// g0 .. g0 + gn of G).  Every thread of the CTA calls it.
template <int GH>
__device__ __forceinline__ void merge_slots(
    const float* sums, float* ms, const float* ls, int slots, int gn, int d,
    long long at, int G, int g0, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int tid = threadIdx.x;
  if (tid < gn) {  // each head's max and the slots' weights
    float M = -CUDART_INF_F;
    for (int r = 0; r < slots; ++r) M = fmaxf(M, ms[r * GH + tid]);
    float L = 0.0f;
    for (int r = 0; r < slots; ++r) {
      const float w = exp2f(ms[r * GH + tid] - M);  // 0 for an empty slot
      ms[r * GH + tid] = w;
      L += w * ls[r * GH + tid];
    }
    m_part[at * G + g0 + tid] = M / LOG2E;
    l_part[at * G + g0 + tid] = L;
  }
  __syncthreads();
  for (int o = tid; o < gn * d; o += blockDim.x) {
    const int g = o / d, e = o - g * d;
    float s = 0.0f;
    for (int r = 0; r < slots; ++r)
      s += ms[r * GH + g] * sums[(r * GH + g) * d + e];
    acc_part[(at * G + g0 + g) * d + e] = s;
  }
}

// A chunk that starts at or past kv_len (read from device memory, the
// chunks planned for the cache's whole S): its partials are empty, m =
// -inf, l = 0, acc = 0, which the combine skips.  Every thread of the
// CTA calls it.
__device__ __forceinline__ void empty_partial(
    int gn, int d, long long at, int G, int g0, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part) {
  const long long base = at * G + g0;
  for (int o = threadIdx.x; o < gn * d; o += blockDim.x)
    acc_part[base * d + o] = 0.0f;
  if (threadIdx.x < gn) {
    m_part[base + threadIdx.x] = -CUDART_INF_F;
    l_part[base + threadIdx.x] = 0.0f;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Two floats as a bfloat16 pair, the first in the low half.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// D = A B + D, m16n8k16, bfloat16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&acc)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// `bytes` bytes from global src to shared dst, counted on mbarrier bar.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The tensor-core instance (bfloat16, d % 16 == 0, 16-byte aligned K
// and V).  Warp w of the CTA takes the chunk's 16-row blocks w, w +
// MMA_WARPS, ...: its lanes 0-15 copy the block's K rows and 16-31 its
// V rows into the warp's own ring, one cp.async.bulk a row, counted on
// the stage's mbarrier (rows past the chunk repeat its last row and are
// masked).  Per block, S^T = Q K^T on the tensor cores (q in registers
// as the A fragments, heads padded to 16, K rows through ldmatrix as the
// B fragments); the warp's online softmax per head; then O^T += V^T P^T
// with V^T through ldmatrix.trans and P^T straight from the score
// fragments, p split into bfloat16 hi + lo parts (two products, p kept
// to 2^-17), accumulated in float32.  Warps never wait for each other
// until the merge at the end of the chunk.
template <int GH, int KT>
__global__ void __launch_bounds__(MMA_WARPS * 32) decode_attention_split_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int S,
    int kv_len, const int* __restrict__ kv_len_dev, int Hkv, int G, int d,
    int chunks, int len, float scale,
    int groups, int gh,
    int ts, int stages, int pitch, int body) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr float LOG2E = 1.4426950408889634f;  // KT = d / 16
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  // the combine may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int hgi = blockIdx.x % groups;
  const int bhc = blockIdx.x / groups;
  const int bh = bhc / chunks, c = bhc % chunks;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g0 = hgi * gh;
  const int gn = G - g0 < gh ? G - g0 : gh;
  (void)ts;  // the CTA's rows a tile: MMA_WARPS * MMA_ROWS

  // a device kv_len past S (the host's kv_len then) reads no row past S
  if (kv_len_dev != nullptr) kv_len = min(*kv_len_dev, kv_len);
  const long long s0 = (long long)c * len;
  if (s0 >= kv_len) {
    empty_partial(gn, d, (long long)bh * chunks + c, G, g0, acc_part, m_part,
                  l_part);
    return;
  }
  const long long s1 = s0 + len < kv_len ? s0 + len : kv_len;
  const int nb = (int)((s1 - s0 + MMA_ROWS - 1) / MMA_ROWS);
  const int mine = nb > warp ? (nb - warp + MMA_WARPS - 1) / MMA_WARPS : 0;
  const long long row_stride = (long long)Hkv * d;
  const __nv_bfloat16* kb = k + ((long long)b * S * Hkv + h) * d;
  const __nv_bfloat16* vb = v + ((long long)b * S * Hkv + h) * d;

  // this warp's ring: stages of [K rows 16][pitch], [V rows 16][pitch]
  const int stage_elems = 2 * MMA_ROWS * pitch;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) +
                        (long long)warp * stages * stage_elems;
  const int bar_off =
      (body + 2 * MMA_WARPS * GH * 4 + 7) / 8 * 8 + warp * stages * 8;
  const unsigned bars = smem_u32(smem + bar_off);
  if (lane < stages) mbar_init(bars + 8 * lane);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  const unsigned row_bytes = (unsigned)d * 2;
  auto issue = [&](int it) {  // the warp's it-th block into its stage
    if (it >= mine) return;
    const int st = it % stages;
    const unsigned bar = bars + 8 * st;
    if (lane == 0) mbar_expect(bar, 2 * MMA_ROWS * row_bytes);
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const long long row0 = s0 + (long long)(warp + it * MMA_WARPS) * MMA_ROWS;
    const int r = lane & 15;
    const long long t = row0 + r < s1 ? row0 + r : s1 - 1;
    const __nv_bfloat16* src = (lane < 16 ? kb : vb) + t * row_stride;
    const __nv_bfloat16* dst =
        ring + st * stage_elems + (lane < 16 ? 0 : MMA_ROWS * pitch) + r * pitch;
    bulk_copy(smem_u32(dst), src, row_bytes, bar);
  };
  for (int it = 0; it < stages - 1; ++it) issue(it);

  // q as the A fragments of S^T = Q K^T: rows = heads (grp; rows 8-15,
  // the padding, are zero), columns = d
  unsigned qa[KT][2];
  const bool hv = grp < gn;
  const __nv_bfloat16* qb =
      q + ((long long)b * Hkv * G + (long long)h * G + g0 + (hv ? grp : 0)) *
              d;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int x = 0; x < KT; ++x) {
    const int col = x * 16 + quad * 2;
    __nv_bfloat162 lo, hi;
    lo.x = hv ? qb[col] : zero;
    lo.y = hv ? qb[col + 1] : zero;
    hi.x = hv ? qb[col + 8] : zero;
    hi.y = hv ? qb[col + 9] : zero;
    qa[x][0] = *reinterpret_cast<const unsigned*>(&lo);
    qa[x][1] = *reinterpret_cast<const unsigned*>(&hi);
  }
  const float qs = scale * LOG2E;

  // O^T fragments: d rows x * 16 + grp (+ 8), heads quad * 2 (+ 1)
  float acc[KT][4];
#pragma unroll
  for (int x = 0; x < KT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.0f;
  float m = -CUDART_INF_F, l = 0.0f;  // head grp: running max, my rows' sum

  // the lanes' row addresses for ldmatrix: matrix j = lane / 8 takes
  // rows (j / 2) * 8 + lane % 8 and columns (j % 2) * 8 of a 16 x 16 piece
  const int lm_row = ((lane >> 4) << 3) + (lane & 7);
  const int lm_col = ((lane >> 3) & 1) << 3;
  for (int it = 0; it < mine; ++it) {
    const int st = it % stages;
    mbar_wait(bars + 8 * st, (it / stages) & 1);
    __syncwarp();
    issue(it + stages - 1);  // into the stage read at it - 1
    const __nv_bfloat16* ks = ring + st * stage_elems;
    const __nv_bfloat16* vs = ks + MMA_ROWS * pitch;
    const long long row0 = s0 + (long long)(warp + it * MMA_WARPS) * MMA_ROWS;

    // scores: n-tile n holds rows n * 8 + quad * 2 (+ 1) of head grp;
    // all of the block's K fragments first, then four independent
    // chains of products (two n-tiles, even and odd steps of d)
    unsigned kf[KT][4];
    const unsigned kaddr = smem_u32(ks + lm_row * pitch + lm_col);
#pragma unroll
    for (int x = 0; x < KT; ++x) ldmatrix_x4(kf[x], kaddr + x * 32);
    float sc[2][2][4] = {};
#pragma unroll
    for (int x = 0; x < KT; ++x) {
      mma_bf16(sc[0][x & 1], qa[x][0], 0u, qa[x][1], 0u, kf[x][0], kf[x][1]);
      mma_bf16(sc[1][x & 1], qa[x][0], 0u, qa[x][1], 0u, kf[x][2], kf[x][3]);
    }
    float s4[4], mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = row0 + n * 8 + quad * 2 + e < s1;
        s4[n * 2 + e] = ok ? (sc[n][0][e] + sc[n][1][e]) * qs : -CUDART_INF_F;
        mx = fmaxf(mx, s4[n * 2 + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = m_new == -CUDART_INF_F ? 1.0f : exp2f(m - m_new);
    m = m_new;
    float p[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      p[x] = s4[x] == -CUDART_INF_F ? 0.0f : exp2f(s4[x] - m_new);
    }
    l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
    // the rescale of the heads this lane accumulates, quad * 2 (+ 1)
    const float a0 = __shfl_sync(0xffffffffu, alpha, quad * 8);
    const float a1 = __shfl_sync(0xffffffffu, alpha, quad * 8 + 4);
    // P^T as B fragments: rows quad * 2 (+ 1) and + 8, head grp
    unsigned ph[2], pl[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(p[n * 2], p[n * 2 + 1]);
      ph[n] = *reinterpret_cast<const unsigned*>(&hi2);
      pl[n] = bf16x2(p[n * 2] - __bfloat162float(hi2.x),
                     p[n * 2 + 1] - __bfloat162float(hi2.y));
    }
    // p V: the V fragments, then the hi products of every 16 dims of d,
    // then the lo ones (no product waits on the one before it)
    unsigned vf[KT][4];
    const unsigned vaddr = smem_u32(vs + lm_row * pitch + lm_col);
#pragma unroll
    for (int x = 0; x < KT; ++x) ldmatrix_x4_trans(vf[x], vaddr + x * 32);
#pragma unroll
    for (int x = 0; x < KT; ++x) {
      acc[x][0] *= a0;
      acc[x][1] *= a1;
      acc[x][2] *= a0;
      acc[x][3] *= a1;
      mma_bf16(acc[x], vf[x][0], vf[x][1], vf[x][2], vf[x][3], ph[0], ph[1]);
    }
#pragma unroll
    for (int x = 0; x < KT; ++x)
      mma_bf16(acc[x], vf[x][0], vf[x][1], vf[x][2], vf[x][3], pl[0], pl[1]);
  }

  // the warps' (m, l, acc) into shared memory, then the merge
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();  // every warp is done with the ring
  float* sums = reinterpret_cast<float*>(smem);       // [warps][GH][d]
  float* ms = reinterpret_cast<float*>(smem + body);  // [warps][GH]
  float* ls = ms + MMA_WARPS * GH;
  if (quad == 0 && grp < gn) {
    ms[warp * GH + grp] = m;
    ls[warp * GH + grp] = l;
  }
#pragma unroll
  for (int x = 0; x < KT; ++x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hd = quad * 2 + (e & 1), dd = x * 16 + grp + (e >> 1) * 8;
      if (hd < gn) sums[(warp * GH + hd) * d + dd] = acc[x][e];
    }
  }
  __syncthreads();
  merge_slots<GH>(sums, ms, ls, MMA_WARPS, gn, d, (long long)bh * chunks + c,
                  G, g0, acc_part, m_part, l_part);
}

template <typename T, int VEC, int GH>
__global__ void __launch_bounds__(NT, GH <= 4 ? 2 : 1) decode_attention_split(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int S,
    int kv_len, const int* __restrict__ kv_len_dev, int Hkv, int G, int d,
    int chunks, int len, float scale,
    int groups, int gh,
    int ts, int stages, int pitch, int body) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int JP = EMAX / VEC;  // pieces a lane holds of a row
  constexpr int RB = 4;           // rows a thread takes a batch
  constexpr float LOG2E = 1.4426950408889634f;
  const int tid = threadIdx.x, lane = tid & 31;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int NV = d / VEC;
  const int LPR = lanes_of(NV, JP);     // lanes a row
  const int RGS = NT / LPR;             // row slots: rows a pass
  const int jp = (NV + LPR - 1) / LPR;  // pieces a lane holds, <= JP
  const int ln = lane & (LPR - 1), rs = tid / LPR;
  (void)pitch;  // rows lie d elements apart in this instance's ring

  // blockIdx.x = ((b * Hkv + h) * chunks + c) * groups + head group
  const int hgi = blockIdx.x % groups;
  const int bhc = blockIdx.x / groups;
  const int bh = bhc / chunks, c = bhc % chunks;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g0 = hgi * gh;
  const int gn = G - g0 < gh ? G - g0 : gh;  // heads of this CTA, <= GH

  // a device kv_len past S (the host's kv_len then) reads no row past S
  if (kv_len_dev != nullptr) kv_len = min(*kv_len_dev, kv_len);
  const long long s0 = (long long)c * len;
  if (s0 >= kv_len) {
    empty_partial(gn, d, (long long)bh * chunks + c, G, g0, acc_part, m_part,
                  l_part);
    return;
  }
  T* ring = reinterpret_cast<T*>(smem);
  const int tile = ts * d;  // elements of one K (or V) tile
  const long long s1 = s0 + len < kv_len ? s0 + len : kv_len;
  const int ntiles = (int)((s1 - s0 + ts - 1) / ts);
  const long long row_stride = (long long)Hkv * d;
  const T* kb = k + ((long long)b * S * Hkv + h) * d;
  const T* vb = v + ((long long)b * S * Hkv + h) * d;

  // Tile i of the chunk into stage i % stages.  A thread copies exactly
  // the rows (rs, rs + RGS, ...) and pieces (ln, ln + LPR, ...) it reads
  // later, so its own cp.async.wait_group makes them visible: the loop
  // needs no barrier.  An empty group past the last tile keeps the group
  // count uniform.
  auto issue = [&](int i) {
    if (i < ntiles) {
      const long long t0 = s0 + (long long)i * ts;
      const int nt = (int)(s1 - t0 < ts ? s1 - t0 : ts);
      T* ks = ring + (i % stages) * 2 * tile;
      T* vs = ks + tile;
      for (int t = rs; t < nt; t += RGS) {
        const long long go = (t0 + t) * row_stride;
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int vi = ln + j * LPR;
          if (j >= jp) break;
          if (vi < NV) {
            const int o = t * d + vi * VEC;
            if constexpr (VEC > 1) {
              cp_async16(ks + o, kb + go + vi * VEC);
              cp_async16(vs + o, vb + go + vi * VEC);
            } else {
              ks[o] = kb[go + vi];
              vs[o] = vb[go + vi];
            }
          }
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < stages - 1; ++i) issue(i);

  // q of this thread's slice for the CTA's heads, in registers, scaled
  // so that the scores come out in log2 units (exp2 below)
  float qr[GH][EMAX];
  const T* qb = q + ((long long)b * Hkv * G + (long long)h * G + g0) * d;
  const float qs = scale * LOG2E;
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int j = 0; j < JP; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int vi = ln + j * LPR;
        qr[g][j * VEC + e] = g < gn && vi < NV
                                 ? hk::to_f32(qb[g * d + vi * VEC + e]) * qs
                                 : 0.0f;
      }
  // the row slot's online softmax: running max (log2 units), sum of
  // weights and p V over its rows, the same in every lane of the slot
  float acc[GH][EMAX], m[GH], l[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EMAX; ++e) acc[g][e] = 0.0f;
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait_stage(stages);  // this thread's copies of tile i landed
    issue(i + stages - 1);        // into the stage it read in tile i - 1
    const long long t0 = s0 + (long long)i * ts;
    const int nt = (int)(s1 - t0 < ts ? s1 - t0 : ts);
    const T* ks = ring + (i % stages) * 2 * tile;
    const T* vs = ks + tile;
    // batches of RB rows: the scores, one rescale, then p V
    for (int b0 = 0; b0 < nt; b0 += RB * RGS) {
      // rows of the batch some slot has (the same in every thread)
      const int nr = (nt - b0 + RGS - 1) / RGS;
      float sc[RB][GH], mx[GH];
#pragma unroll
      for (int g = 0; g < GH; ++g) mx[g] = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) break;
        const int t = b0 + r * RGS + rs;
        const bool ok = t < nt;
        float kv[EMAX];
        row_slice<T, VEC>(ks + t * d, ln, LPR, NV, jp, ok, kv);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            if (j >= jp) break;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s += qr[g][j * VEC + e] * kv[j * VEC + e];
          }
          sc[r][g] = s;
        }
        all_heads<GH>(sc[r], lane, ln, LPR);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          sc[r][g] = ok ? sc[r][g] : -CUDART_INF_F;
          mx[g] = fmaxf(mx[g], sc[r][g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);
        // 0 on the slot's first rows; 1 while it has seen none
        const float alpha = m_new == -CUDART_INF_F ? 1.0f
                                                    : exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          if (j >= jp) break;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][j * VEC + e] *= alpha;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int t = b0 + r * RGS + rs;
        if (t < nt) {
          float p[GH];
#pragma unroll
          for (int g = 0; g < GH; ++g) {
            p[g] = exp2f(sc[r][g] - m[g]);
            l[g] += p[g];
          }
          float vv[EMAX];
          row_slice<T, VEC>(vs + t * d, ln, LPR, NV, jp, true, vv);
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            if (j >= jp) break;
#pragma unroll
            for (int g = 0; g < GH; ++g)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[g][j * VEC + e] += p[g] * vv[j * VEC + e];
          }
        }
      }
    }
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem);  // [slots][GH][d]
  float* ms = reinterpret_cast<float*>(smem + body);  // [slots][GH]
  float* ls = ms + RGS * GH;                          // [slots][GH]
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    if (ln == 0) {
      ms[rs * GH + g] = m[g];
      ls[rs * GH + g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int vi = ln + j * LPR;
      if (vi < NV) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sums[(rs * GH + g) * d + vi * VEC + e] = acc[g][j * VEC + e];
      }
    }
  }
  __syncthreads();
  merge_slots<GH>(sums, ms, ls, RGS, gn, d, (long long)bh * chunks + c, G,
                  g0, acc_part, m_part, l_part);
}

// The combine for heads of up to 32 * XD dims: warp w folds chunks w,
// w + warps, ... in batches of CB, all of a batch's loads issued at
// once, with its own running max; the warps are then merged in warp
// order.
template <typename T, int XD>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    decode_attention_combine(const float* __restrict__ acc_part,
                             const float* __restrict__ m_part,
                             const float* __restrict__ l_part,
                             T* __restrict__ out, int Hq, int G, int d,
                             int chunks) {
  constexpr int CB = 16 / XD;  // chunks a warp loads at once
  __shared__ float red_m[COMBINE_WARPS], red_l[COMBINE_WARPS];
  // launched as a programmatic dependent of the split: wait for its
  // grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ float red_o[];  // [warps][d]
  const int bq = blockIdx.x;        // b * Hq + query head
  const int hq = bq % Hq, g = hq % G;
  const long long base = (long long)(bq / Hq * (Hq / G) + hq / G) * chunks;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float mw = -CUDART_INF_F, lw = 0.0f, o[XD];
#pragma unroll
  for (int x = 0; x < XD; ++x) o[x] = 0.0f;
  for (int c0 = warp; c0 < chunks; c0 += CB * warps) {
    float mc[CB], lc[CB], a[CB][XD];
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const int c = c0 + u * warps;
      const long long r = (base + c) * G + g;
      const bool ok = c < chunks;
      mc[u] = ok ? m_part[r] : -CUDART_INF_F;
      lc[u] = ok ? l_part[r] : 0.0f;
#pragma unroll
      for (int x = 0; x < XD; ++x) {
        const int e = lane + 32 * x;
        a[u][x] = ok && e < d ? acc_part[r * d + e] : 0.0f;
      }
    }
    float mb = mw;
#pragma unroll
    for (int u = 0; u < CB; ++u) mb = fmaxf(mb, mc[u]);
    // 0 on the first batch; an empty chunk (m = -inf) weighs 0, and
    // exp(-inf - (-inf)) is never formed
    const float alpha = mb == -CUDART_INF_F ? 1.0f : expf(mw - mb);
    lw *= alpha;
#pragma unroll
    for (int x = 0; x < XD; ++x) o[x] *= alpha;
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const float w = mc[u] == -CUDART_INF_F ? 0.0f : expf(mc[u] - mb);
      lw += lc[u] * w;
#pragma unroll
      for (int x = 0; x < XD; ++x) o[x] += a[u][x] * w;
    }
    mw = mb;
  }
  if (lane == 0) {
    red_m[warp] = mw;
    red_l[warp] = lw;
  }
#pragma unroll
  for (int x = 0; x < XD; ++x) {
    const int e = lane + 32 * x;
    if (e < d) red_o[warp * d + e] = o[x];
  }
  __syncthreads();
  if (warp == 0) {  // the warps' weights exp(m_w - M) and 1 / sum l_w w
    const float mv = lane < warps ? red_m[lane] : -CUDART_INF_F;
    float M = mv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float f = lane < warps && mv != -CUDART_INF_F ? expf(mv - M) : 0.0f;
    const float L = hk::warp_sum(lane < warps ? red_l[lane] * f : 0.0f);
    red_m[lane] = f / L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += red_o[w * d + e] * red_m[w];
    out[(long long)bq * d + e] = hk::from_f32<T>(s);
  }
}

template <typename T>
constexpr int vec_of() {
  return 16 / sizeof(T);
}

// The split kernel's instance for the config's vector width and head
// count.
template <typename T, int VEC>
void* split_instance(int gh_t) {
  switch (gh_t) {
    case 1: return (void*)decode_attention_split<T, VEC, 1>;
    case 2: return (void*)decode_attention_split<T, VEC, 2>;
    case 4: return (void*)decode_attention_split<T, VEC, 4>;
    default: return (void*)decode_attention_split<T, VEC, 8>;
  }
}

// The tensor-core instance for the config's head count and d / 16.
template <int KT>
void* mma_instance(int gh_t) {
  switch (gh_t) {
    case 1: return (void*)decode_attention_split_mma<1, KT>;
    case 2: return (void*)decode_attention_split_mma<2, KT>;
    case 4: return (void*)decode_attention_split_mma<4, KT>;
    default: return (void*)decode_attention_split_mma<8, KT>;
  }
}

// The instance and config for (G, d, type), vectorized where `aligned`:
// the tensor-core one for bfloat16 with d of 64, 128 or 256, the FMA
// one else.
void* split_kernel(int G, int d, bool bf16, bool aligned, Config* cfg) {
  const int es = bf16 ? 2 : 4, vec = 16 / es;
  const bool vec_ok = aligned && d % vec == 0;
  const bool mma = bf16 && vec_ok && (d == 64 || d == 128 || d == 256);
  *cfg = config_of(G, d, es, vec_ok ? vec : 1, mma);
  if (mma)
    return d == 64    ? mma_instance<4>(cfg->gh_t)
           : d == 128 ? mma_instance<8>(cfg->gh_t)
                      : mma_instance<16>(cfg->gh_t);
  if (bf16)
    return vec_ok ? split_instance<__nv_bfloat16, vec_of<__nv_bfloat16>()>(
                        cfg->gh_t)
                  : split_instance<__nv_bfloat16, 1>(cfg->gh_t);
  return vec_ok ? split_instance<float, vec_of<float>()>(cfg->gh_t)
                : split_instance<float, 1>(cfg->gh_t);
}

template <typename T>
using CombineFn = void (*)(const float*, const float*, const float*, T*, int,
                           int, int, int);

// The combine's instance for heads of up to 32 * xd dims.
template <typename T>
CombineFn<T> combine_instance(int xd) {
  if (xd == 2) return decode_attention_combine<T, 2>;
  if (xd == 4) return decode_attention_combine<T, 4>;
  return decode_attention_combine<T, 8>;
}

cudaError_t prepare(void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// The split kernel's configuration for G query heads of dim d on the
// current card (16-byte aligned K and V): CTAs an SM at its shared
// memory, the card's SMs, head groups a (b, h_kv) and heads a group,
// rows a tile (all of a CTA's warps), stages of the ring, dynamic shared
// memory in bytes, threads a CTA, lanes a row (the FMA instance) and
// whether it is the tensor-core instance.  The wrapper sizes the grid
// from it (chunk_plan).
extern "C" int decode_attention_config(int G, int d, int bf16,
                                       int* ctas_per_sm, int* sms,
                                       int* groups, int* heads, int* tile,
                                       int* stages, int* smem, int* threads,
                                       int* lanes, int* tensor_cores) {
  if (G < 1 || d < 1 || d > D_MAX) return (int)cudaErrorInvalidValue;
  Config cfg;
  void* kernel = split_kernel(G, d, bf16 != 0, true, &cfg);
  int dev = 0, per_sm = 0;
  cudaError_t err;
  if ((err = prepare(kernel, cfg.smem)) != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, (const void*)kernel, cfg.threads, cfg.smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas_per_sm = per_sm;
  *groups = cfg.groups;
  *heads = cfg.gh;
  *tile = cfg.ts;
  *stages = cfg.stages;
  *smem = cfg.smem;
  *threads = cfg.threads;
  *lanes = cfg.mma ? 0 : cfg.lpr;
  *tensor_cores = cfg.mma;
  return (int)cudaSuccess;
}

// q: (B, Hq, d); k, v: (B, S, Hkv, d), all float32 (bf16 == 0) or
// bfloat16, of which rows [0, kv_len) of each batch's slab are attended
// (a cache allocated at its full horizon, filled up to kv_len; S stays
// the slab's row count, the stride from one batch to the next);
// acc_part: (B * Hkv * chunks, G, d) and m_part, l_part:
// (B * Hkv * chunks, G) float32; chunks of len positions cover kv_len,
// none empty.  Where kv_len_dev is not null, kv_len is read from it on
// the device (1 <= *kv_len_dev <= S, a decode position held on the card,
// so one captured graph serves every step): the host's kv_len must then
// be S, the chunks cover all S, and those past *kv_len_dev are empty.
extern "C" int decode_attention_split_launch(
    const void* q, const void* k, const void* v, void* acc_part,
    void* m_part, void* l_part, int B, int Hq, int Hkv, int S, int kv_len,
    int d, int chunks, int len, float scale, int bf16, const void* kv_len_dev,
    void* stream) {
  if (kv_len_dev != nullptr && kv_len != S) return (int)cudaErrorInvalidValue;
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || kv_len < 1 || kv_len > S ||
      d < 1 || d > D_MAX || chunks < 1 || len < 1 ||
      (long long)chunks * len < kv_len ||
      (long long)(chunks - 1) * len >= kv_len)
    return (int)cudaErrorInvalidValue;
  int G = Hq / Hkv;
  const bool aligned = hk::aligned16(k) && hk::aligned16(v);
  Config cfg;
  void* kernel = split_kernel(G, d, bf16 != 0, aligned, &cfg);
  cudaError_t err = prepare(kernel, cfg.smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)B * Hkv * chunks * cfg.groups;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&q,          (void*)&k,      (void*)&v,
                  (void*)&acc_part,   (void*)&m_part, (void*)&l_part,
                  (void*)&S,          (void*)&kv_len, (void*)&kv_len_dev,
                  (void*)&Hkv,
                  (void*)&G,
                  (void*)&d,          (void*)&chunks, (void*)&len,
                  (void*)&scale,      (void*)&cfg.groups,
                  (void*)&cfg.gh,     (void*)&cfg.ts, (void*)&cfg.stages,
                  (void*)&cfg.pitch,  (void*)&cfg.body};
  err = cudaLaunchKernel((const void*)kernel, dim3((unsigned)grid),
                         dim3(cfg.threads), args, (size_t)cfg.smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out: (B, Hq, d) in q's type, from the split's partials.
extern "C" int decode_attention_combine_launch(
    const void* acc_part, const void* m_part, const void* l_part, void* out,
    int B, int Hq, int Hkv, int d, int chunks, int bf16, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || d < 1 || d > D_MAX || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int warps = chunks < COMBINE_WARPS ? chunks : COMBINE_WARPS;
  const size_t smem = (size_t)warps * d * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)acc_part;
  const float* m = (const float*)m_part;
  const float* l = (const float*)l_part;
  const int xd = d <= 64 ? 2 : d <= 128 ? 4 : 8;
  // a programmatic dependent launch: the combine's CTAs are set up while
  // the split's last CTAs run, and wait in griddepcontrol.wait
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(B * Hq);
  lc.blockDim = dim3(warps * 32);
  lc.dynamicSmemBytes = smem;
  lc.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  cudaError_t err;
  if (bf16)
    err = cudaLaunchKernelEx(&lc, combine_instance<__nv_bfloat16>(xd), a, m,
                             l, (__nv_bfloat16*)out, Hq, G, d, chunks);
  else
    err = cudaLaunchKernelEx(&lc, combine_instance<float>(xd), a, m, l,
                             (float*)out, Hq, G, d, chunks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
