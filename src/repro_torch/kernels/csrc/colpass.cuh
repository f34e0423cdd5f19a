// One streaming pass over the columns of a row-major float32 (MATVEC and
// FISTA: or bf16) X (n, p):
//
//     dot[b, j] = sum_i C[b, i] * X[i, j]          for b < NB queries
//
// with an epilogue chosen at compile time (MODE):
//
//   MATVEC  out0[b, j] = dot[b, j]
//   SCORES  out0[b, j] = |dot[b, j]| + rho_b * sqrt(ss[j]),  out1[j] = ss[j]
//           where ss[j] = sum_i X[i, j]^2 rides the same pass
//   FISTA   u = z[b, j] - step_b * dot[b, j]
//           out0[b, j] = S(u, step_b * lam_b)                       (beta')
//           out1[b, j] = out0 + mom_b * (out0 - beta_old[b, j])     (z')
//   GROUP   out0[g] = sqrt(sum_{j in group g} dot[0, j]^2)  (B = 1; groups of
//           m contiguous columns; the p dots never reach device memory)
//
// What bounds it. The pass reads X once and writes each output once; for
// B <= 8 it does at most 2*B flops per 4-byte element of X, far below the
// card's flop/byte balance. On the wide screens (784 x 50 000: 157 MB) it
// is bound by the bytes of X at 3.35 TB/s. On the solver's narrow buckets
// (784 x 32: 100 KB, resident in L2 across iterations) it is bound by
// latency: the launch, one round trip to L2 and the reductions.
//
// Layout (a Plan, chosen on the host by launch_plan in edpp_screen.py):
// every CTA has 256 threads (8 warps) and owns `tile` consecutive columns
// and a contiguous range of rows. Each lane owns 4 adjacent columns:
//   tile 128  32 lanes on one row, a warp reads 512 contiguous bytes of it
//             (the wide pass: p / 128 tiles already fill the card);
//   tile 32   8 lanes on a row, 4 rows per warp step (the narrow pass,
//             where a 32-lane row would leave 24 lanes idle).
// vec = 4 loads the 4 columns as one float4 (p % 4 == 0 and X 16-byte
// aligned), streamed past L1; vec = 1 loads them as 4 scalars. Both sum in
// the same order, so the choice never changes a bit of the result.
//
// bf16 X (MATVEC: the mixed-precision screen's wide pass, which replaces
// the bf16 input of the Pallas screen_matvec; FISTA: the mixed-precision
// solve's iterations on the bf16 bucket, which replace the Pallas
// fista_step on bf16 X with float r, z and beta_old): a lane owns 8
// adjacent columns, one 16-byte load of a row (vec = 8; else 8 scalar
// loads of the same columns), so tile 128 puts 16 lanes on a row and 2 rows
// in a warp step, tile 32 4 lanes and 8 rows; each value is widened with
// __bfloat162float (exact) where it meets the float centre, and every sum
// runs in float, in the order below. The pass reads half the bytes of the
// float pass and is bound by them. Its bits differ from the float pass's
// (the mixed-precision margins cover that) but not with B, alignment or
// the run. FISTA's epilogue does not depend on the element type: z,
// beta_old, beta' and z' stay float, and the rows a CTA of a cluster takes
// (n / split, e.g. 196 at 784 rows and 4 ranks) need not be a multiple of
// the 8 rows of a warp step, since each row load is masked.
//
// Rows: within a CTA, warp w and row group g take rows w*R + g, + 8R, ...
// (R rows per warp step). A thread issues U row loads (8 for B <= 4, else
// 4) before their FMAs, and its first batch before the centre is staged.
// The CTA's centre rows are staged in shared memory once when they fit
// the 96 KB budget, else in stages of `stage_rows` with two barriers
// between stages; nothing else stops the streaming loop. Where the column
// tiles alone would leave SMs idle, `split` CTAs of one tile (a
// thread-block cluster, split <= 8) each take n / split rows, and each
// runs the epilogue for tile / split of the columns: the others write
// their sums for those columns into its shared memory (distributed shared
// memory), and one cluster barrier later it adds them in rank order; no
// CTA reads another's memory. Partials are folded by warp shuffles, then
// over the 8 warps through shared memory, then over the ranks, each in a
// fixed order and without atomics: two launches on the same inputs give
// the same bits. Columns past p are masked; a zero row or a zero column
// of X adds exactly nothing.
//
// Measured (chip_smoke.py --kernels, NVIDIA H100 80GB HBM3, 700.00 W; the
// rest in PERF.md section 6): MATVEC at 784 x 50 000, B = 1, 0.0567 ms,
// 83 % of its byte bound (torch.matmul(c, X) 0.0587 ms in the same run);
// at 3072 x 99 288, 0.401 ms, 91 %. FISTA at 784 x 32, B = 1, on a
// cluster of 4: 0.0078 ms, where a 1-element zero_() takes 0.0050 ms and
// the same launch on zero rows 0.0070 ms: the launch and the cluster's
// barriers, not the rows, set its time. GROUP at 250 x 200 000, m = 10:
// 0.074 ms, 80 % of its byte bound (torch.matmul(c, X) 0.084 ms).
//
// GROUP (launch plan: group_plan in group_screen.py). A tile holds whole
// groups: the largest multiple of lcm(m, 4) up to 128 columns (120 for
// m = 5, 10, 20), every lane on one row, lanes past the tile masked; or,
// where lcm(m, 4) > 128, a multiple of m up to 128 with scalar loads, or
// one group of m > 128 columns walked in steps of 128 (the pass over the
// rows runs once per step). After the fold a tile's dots sit in shared
// memory; one thread per group adds their squares in column order, takes
// the square root and writes the group's score. With a cluster each rank
// runs the epilogue for tile / split columns, which the plan keeps a
// multiple of m, so no group is cut between ranks.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace colpass {

namespace cg = cooperative_groups;

constexpr int WARPS = 8;                 // warps per CTA, every launch
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_B = 8;                 // queries per launch; the wrapper splits more
constexpr int MAX_SPLIT = 8;             // portable cluster size
constexpr size_t MAX_SMEM = 232448;      // 227 KB: the opt-in limit of sm_90
constexpr size_t DEFAULT_SMEM = 49152;   // above this a kernel must opt in

enum Mode { MATVEC = 0, SCORES = 1, FISTA = 2, GROUP = 3 };
constexpr int GROUP_SPAN = 128;          // GROUP: columns a step, 32 lanes x 4

struct Plan {
  int vec;         // 16 / sizeof(T): one 16-byte load per lane and row (4
                   // floats or 8 bf16); 1: the same columns as scalar loads
  int tile;        // columns per CTA: 32 or 128 (GROUP: whole groups)
  int split;       // CTAs per column tile (the cluster), each on its own rows
  int stage_rows;  // centre rows staged in shared memory at a time
};

// X's element type: float, or bf16 for MATVEC and FISTA (the
// mixed-precision screen pass and solve iterations). A lane owns COLS adjacent columns, one 16-byte load of a row;
// `Raw` holds them as loaded, converted to float (exactly: every bf16 is a
// float) only where they meet the centre, and every sum runs in float.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int COLS = 4;
  using Raw = float4;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int COLS = 8;
  using Raw = uint4;
};

// Per-query parameters: `params` is null (then the scalars s0..s2 hold for
// every query) or a device array (3, B) row-major: rho | step, lam, mom.
struct Epilogue {
  const float* params;
  float s0, s1, s2;
  const float* z;         // FISTA: (B, p)
  const float* beta_old;  // FISTA: (B, p)
  float* out0;            // (B, p); GROUP: (p / m,)
  float* out1;            // SCORES: (p,); FISTA: (B, p)
  int m;                  // GROUP: columns per group
};

// Shared memory, in floats: the staged centre [NB][stage_rows] (rounded
// up to 16 bytes) and the warps' partials [WARPS][NB + 1][span], span the
// columns of one step (the tile; GROUP_SPAN for GROUP). Without a
// cluster the partials reuse the centre's space once the stream is done;
// with one they have their own, followed by the inbox [split][NB + 1]
// [tile / split] that the cluster's CTAs write their sums into.
template <int MODE>
__host__ __device__ inline int span_of(const Plan& pl) {
  return MODE == GROUP ? GROUP_SPAN : pl.tile;
}

__host__ __device__ inline size_t centre_floats(const Plan& pl, int nb) {
  return ((size_t)nb * pl.stage_rows + 3) / 4 * 4;
}

template <int MODE>
__host__ __device__ inline size_t red_floats(const Plan& pl, int nb) {
  return (size_t)WARPS * (nb + 1) * span_of<MODE>(pl);
}

template <int MODE>
__host__ __device__ inline size_t smem_bytes(const Plan& pl, int nb) {
  const size_t c = centre_floats(pl, nb), r = red_floats<MODE>(pl, nb);
  const size_t floats =
      pl.split == 1 ? (c > r ? c : r) : c + r + (size_t)(nb + 1) * pl.tile;
  return floats * sizeof(float);
}

// The cluster barrier in its two halves: `arrive` (release; relaxed for
// the first, which orders nothing) and `wait` (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float param(const Epilogue& ep, int row, int b,
                                       int nb, float fallback) {
  return ep.params ? ep.params[row * nb + b] : fallback;
}

// The lane's 4 columns of one row; `xc` points at X[row, col]. Columns
// from `lim` on (p, or the end of a GROUP tile) read as 0.
template <bool VEC>
__device__ __forceinline__ float4 load_raw(const float* __restrict__ xc,
                                           int col, int lim) {
  if (VEC) {  // read-only, and not kept in L1: no other lane reads it
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < lim)
      asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "l"(xc));
    return v;
  }
  float4 v;
  v.x = col < lim ? __ldg(xc) : 0.f;
  v.y = col + 1 < lim ? __ldg(xc + 1) : 0.f;
  v.z = col + 2 < lim ? __ldg(xc + 2) : 0.f;
  v.w = col + 3 < lim ? __ldg(xc + 3) : 0.f;
  return v;
}

// The lane's 8 bf16 columns of one row, as loaded: element 2k in the low
// half of word k (memory order). Columns from `lim` on read as 0.
template <bool VEC>
__device__ __forceinline__ uint4 load_raw(const __nv_bfloat16* __restrict__ xc,
                                          int col, int lim) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (col < lim)
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "l"(xc));
    return v;
  }
  const unsigned short* const h = reinterpret_cast<const unsigned short*>(xc);
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = col + 2 * k < lim ? __ldg(h + 2 * k) : 0u;
    const unsigned hi = col + 2 * k + 1 < lim ? __ldg(h + 2 * k + 1) : 0u;
    w[k] = lo | (hi << 16);
  }
  v.x = w[0], v.y = w[1], v.z = w[2], v.w = w[3];
  return v;
}

__device__ __forceinline__ void to_floats(const float4& v, float (&x)[4]) {
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __bfloat162float(__ushort_as_bfloat16(h));
}

__device__ __forceinline__ void to_floats(const uint4& v, float (&x)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = bf16_bits((unsigned short)(w[k] & 0xffffu));
    x[2 * k + 1] = bf16_bits((unsigned short)(w[k] >> 16));
  }
}

// Rows i, i + stride, ... of the stage that starts at row s0 (rows of it).
template <typename T, bool VEC, int U>
__device__ __forceinline__ void load_batch(typename Elem<T>::Raw (&v)[U],
                                           const T* __restrict__ xc, int col,
                                           int lim, int p, int s0, int i,
                                           int rows, int stride) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = i + u * stride;
    v[u] = r < rows ? load_raw<VEC>(xc + (size_t)(s0 + r) * p, col, lim)
                    : typename Elem<T>::Raw{};
  }
}

template <int MODE, int NB, int U, typename T>
__device__ __forceinline__ void fma_batch(const typename Elem<T>::Raw (&v)[U],
                                          const float* c_s, int ld, int i,
                                          int rows, int stride,
                                          float (&acc)[NB][Elem<T>::COLS],
                                          float (&ss)[Elem<T>::COLS]) {
  constexpr int COLS = Elem<T>::COLS;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = i + u * stride;
    if (r < rows) {
      float x[COLS];
      to_floats(v[u], x);
      if (MODE == SCORES) {
#pragma unroll
        for (int k = 0; k < COLS; ++k) ss[k] = fmaf(x[k], x[k], ss[k]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float c = c_s[b * ld + r];
#pragma unroll
        for (int k = 0; k < COLS; ++k) acc[b][k] = fmaf(c, x[k], acc[b][k]);
      }
    }
  }
}

// c_s[b * ld + i] = C[b, s0 + i] for i < rows: float4 copies when the rows
// are 16-byte aligned, else scalar ones.
template <int NB>
__device__ __forceinline__ void stage_centre(const float* __restrict__ C,
                                             int n, int s0, int rows, int ld,
                                             float* c_s) {
  const bool v4 = ((reinterpret_cast<uintptr_t>(C + s0) & 15u) == 0) &&
                  n % 4 == 0 && rows % 4 == 0 && ld % 4 == 0;
  if (v4) {
    const int q = rows / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < NB * q; e += THREADS) {
      const int b = e / q, i = e - b * q;
      reinterpret_cast<float4*>(c_s + b * ld)[i] =
          __ldg(reinterpret_cast<const float4*>(C + (size_t)b * n + s0) + i);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < NB * rows; e += THREADS) {
      const int b = e / rows, i = e - b * rows;
      c_s[b * ld + i] = __ldg(C + (size_t)b * n + s0 + i);
    }
  }
}

// The epilogue of one output column j of query b, given its dot d (and,
// for SCORES, its sum of squares sq). FISTA reads z and beta_old there,
// or takes them as fetched before the pass (`pre`).
template <int MODE, int NB>
__device__ __forceinline__ void finish(const Epilogue& ep, int p, int b,
                                       int j, float d, float sq, bool pre,
                                       float z_pre, float bo_pre) {
  const size_t o = (size_t)b * p + j;
  if (MODE == MATVEC) {
    ep.out0[o] = d;
  } else if (MODE == SCORES) {
    ep.out0[o] = fabsf(d) + param(ep, 0, b, NB, ep.s0) * sqrtf(sq);
    if (b == 0) ep.out1[j] = sq;
  } else {
    const float step = param(ep, 0, b, NB, ep.s0);
    const float lam = param(ep, 1, b, NB, ep.s1);
    const float mom = param(ep, 2, b, NB, ep.s2);
    const float zv = pre ? z_pre : ep.z[o];
    const float bo = pre ? bo_pre : ep.beta_old[o];
    const float u = zv - step * d;
    const float m = fmaxf(fabsf(u) - step * lam, 0.f);
    const float beta = u > 0.f ? m : (u < 0.f ? -m : 0.f);
    ep.out0[o] = beta;
    ep.out1[o] = beta + mom * (beta - bo);
  }
}

// GROUP, after the fold of one step (columns cs .. cs + span of the tile):
// `dots` holds the step's column dots; thread g < groups adds the squares
// of its group's columns in this step, in column order, to `gsum`.
__device__ __forceinline__ void group_squares(const float* dots, int m,
                                              int groups, int cs, int width,
                                              float& gsum) {
  const int g = threadIdx.x;
  if (g >= groups) return;
  const int lo = max(g * m, cs), hi = min(min(g * m + m, cs + GROUP_SPAN),
                                          width);
  for (int c = lo; c < hi; ++c) {
    const float d = dots[c - cs];
    gsum = fmaf(d, d, gsum);
  }
}

// Registers: at most 128 a thread (two CTAs an SM); the single-query
// float4 pass, the wide screens' case, at most 80 (three CTAs an SM, so
// that 391 tiles of 784 x 50 000 run in one wave on 132 SMs). GROUP keeps
// 128 (two CTAs an SM): at 80 its float4 pass spills. T is bf16 for
// MATVEC and FISTA only.
template <int MODE, int NB, bool VEC, typename T>
__global__ void __launch_bounds__(THREADS,
                                  VEC && NB == 1 && MODE != GROUP ? 3 : 2)
colpass_kernel(const T* __restrict__ X, const float* __restrict__ C,
               int n, int p, Plan pl, Epilogue ep) {
  constexpr int COLS = Elem<T>::COLS;  // columns per lane: 4, bf16 8
  static_assert(MODE == MATVEC || MODE == FISTA || COLS == 4,
                "bf16 X: MATVEC and FISTA only");
  constexpr int U = NB <= 4 ? 8 : 4;  // row loads in flight per thread
  constexpr int NS = MODE == SCORES ? NB + 1 : NB;  // sums per column
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tile = pl.tile, ld = pl.stage_rows, split = pl.split;
  const int span = span_of<MODE>(pl);         // columns of one step
  float* const c_s = smem;                                // [NB][ld]
  float* const red = split == 1 ? smem : smem + centre_floats(pl, NB);
  float* const inbox = red + red_floats<MODE>(pl, NB);    // [split][NB + 1][cols]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lpr = span / COLS;                // lanes per row: 8 or 32 (bf16 4 or 16)
  const int rpw = 32 / lpr;                   // rows per warp step: 4 or 1 (8 or 2)
  const int stride = WARPS * rpw;             // rows per CTA step
  const int rowoff = warp * rpw + lane / lpr;
  const int cl = COLS * (lane % lpr);         // the lane's first column
  const int col0 = blockIdx.x * tile;
  // GROUP: the tile's columns end on a group boundary; the lanes past it
  // read nothing
  const int lim = MODE == GROUP ? min(p, col0 + tile) : p;
  const int rank = blockIdx.y;                // rank in the cluster
  const int r0 = (int)((long long)n * rank / split);
  const int r1 = (int)((long long)n * (rank + 1) / split);
  const int cols = tile / split;              // this CTA's share of the epilogue
  const int c_lo = rank * cols;
  if (split > 1) cluster_arrive_relaxed();    // this CTA has started

  // FISTA: z and beta_old of the thread's first epilogue element, fetched
  // now so that their latency hides under the pass.
  float z_pre = 0.f, bo_pre = 0.f;
  if (MODE == FISTA && tid < NB * cols) {
    const int j = col0 + c_lo + tid % cols;
    if (j < p) {
      const size_t o = (size_t)(tid / cols) * p + j;
      z_pre = __ldg(ep.z + o);
      bo_pre = __ldg(ep.beta_old + o);
    }
  }

  // GROUP: one step per GROUP_SPAN columns of the tile (more than one only
  // for a group wider than that); gsum is thread g's sum for group g.
  const int steps = MODE == GROUP ? (tile + span - 1) / span : 1;
  float gsum = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int cs = step * span;               // the step's first column
    const int col = col0 + cs + cl;
    float acc[NB][COLS], ss[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      ss[k] = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b][k] = 0.f;
    }

    const T* const xc = X + col;
    typename Elem<T>::Raw v[U];
    int s0 = r0;
    int rows = min(ld, r1 - s0);
    load_batch<T, VEC, U>(v, xc, col, lim, p, s0, rowoff, rows, stride);
    if (MODE == GROUP && step > 0)
      __syncthreads();  // every thread has read the last step's dots
    stage_centre<NB>(C, n, s0, rows, ld, c_s);
    __syncthreads();
    for (;;) {
      for (int i = rowoff;;) {
        fma_batch<MODE, NB, U, T>(v, c_s, ld, i, rows, stride, acc, ss);
        i += U * stride;
        if (i >= rows) break;
        load_batch<T, VEC, U>(v, xc, col, lim, p, s0, i, rows, stride);
      }
      s0 += ld;
      if (s0 >= r1) break;
      rows = min(ld, r1 - s0);
      load_batch<T, VEC, U>(v, xc, col, lim, p, s0, rowoff, rows, stride);
      __syncthreads();  // every warp is done with the previous stage
      stage_centre<NB>(C, n, s0, rows, ld, c_s);
      __syncthreads();
    }

    // Lanes lane ^ lpr, lane ^ 2 lpr, ... hold the same columns: fold them.
    for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        if (MODE == SCORES) ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], off);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          acc[b][k] += __shfl_xor_sync(0xffffffffu, acc[b][k], off);
      }
    }
    if (split == 1) __syncthreads();  // the centre is consumed: red overlays it
    if (lane < lpr) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int k = 0; k < COLS; k += 4)
          *reinterpret_cast<float4*>(red + (warp * (NB + 1) + b) * span + cl +
                                     k) =
              make_float4(acc[b][k], acc[b][k + 1], acc[b][k + 2],
                          acc[b][k + 3]);
      if (MODE == SCORES)
        *reinterpret_cast<float4*>(red + (warp * (NB + 1) + NB) * span + cl) =
            make_float4(ss[0], ss[1], ss[2], ss[3]);
    }
    __syncthreads();

    if (split == 1) {
      if (MODE == GROUP) {
        // Thread c sums column c over the warps, in order, and leaves the
        // dot in warp 0's row of red (no other thread reads column c).
        if (tid < span) {
          float d = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) d += red[w * (NB + 1) * span + tid];
          red[tid] = d;
        }
        __syncthreads();
        group_squares(red, ep.m, tile / ep.m, cs, lim - col0, gsum);
        continue;
      }
      for (int e = tid; e < NB * tile; e += THREADS) {
        const int b = e / tile, c = e % tile, j = col0 + c;
        if (j >= p) continue;
        float d = 0.f, sq = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {  // warps in order
          d += red[(w * (NB + 1) + b) * tile + c];
          if (MODE == SCORES) sq += red[(w * (NB + 1) + NB) * tile + c];
        }
        finish<MODE, NB>(ep, p, b, j, d, sq, e == tid, z_pre, bo_pre);
      }
      return;
    }

    // The cluster: each CTA sums its warps and writes the sums of column c
    // into the inbox of the CTA that owns c, slot [rank].
    cluster_wait();  // every CTA of the cluster has started
    cg::cluster_group cluster = cg::this_cluster();
    for (int e = tid; e < NS * tile; e += THREADS) {
      const int slot = e / tile, c = e % tile, owner = c / cols;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        s += red[(w * (NB + 1) + slot) * span + c];
      cluster.map_shared_rank(inbox, owner)[(rank * (NB + 1) + slot) * cols +
                                            c - owner * cols] = s;
    }
    cluster_arrive();  // release: the sums are written
    cluster_wait();    // acquire: every rank's sums have arrived
    if (MODE == GROUP) {
      // One step only (the plan takes no cluster for wider groups); this
      // rank owns the whole groups of columns c_lo .. c_lo + cols.
      if (tid < cols) {
        float d = 0.f;
#pragma unroll 8
        for (int q = 0; q < split; ++q) d += inbox[q * (NB + 1) * cols + tid];
        inbox[tid] = d;
      }
      __syncthreads();
      group_squares(inbox, ep.m, cols / ep.m, 0, min(cols, lim - col0 - c_lo),
                    gsum);
      if (tid < cols / ep.m && col0 + c_lo + tid * ep.m < p)
        ep.out0[(col0 + c_lo) / ep.m + tid] = sqrtf(gsum);
      return;
    }
    for (int e = tid; e < NB * cols; e += THREADS) {
      const int b = e / cols, c = e % cols, j = col0 + c_lo + c;
      if (j >= p) continue;
      float d = 0.f, sq = 0.f;
#pragma unroll 8
      for (int q = 0; q < split; ++q) {  // ranks in order
        d += inbox[(q * (NB + 1) + b) * cols + c];
        if (MODE == SCORES) sq += inbox[(q * (NB + 1) + NB) * cols + c];
      }
      finish<MODE, NB>(ep, p, b, j, d, sq, e == tid, z_pre, bo_pre);
    }
    return;
  }
  // GROUP without a cluster: every step is folded into gsum
  if (MODE == GROUP && tid < tile / ep.m && col0 + tid * ep.m < p)
    ep.out0[col0 / ep.m + tid] = sqrtf(gsum);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// MATVEC, SCORES, FISTA: tiles of 32 or 128 columns. GROUP: whole groups,
// at most GROUP_SPAN columns or one group walked in steps; a cluster only
// on a tile of one step whose ranks each own whole groups.
template <int MODE>
inline bool plan_ok(const Plan& pl, int m, int cols) {
  const bool common = (pl.vec == 1 || pl.vec == cols) && pl.split >= 1 &&
                      pl.split <= MAX_SPLIT &&
                      (pl.split & (pl.split - 1)) == 0 && pl.stage_rows >= 1;
  if (MODE != GROUP) return common && (pl.tile == 32 || pl.tile == 128);
  return common && m >= 1 && pl.tile >= m && pl.tile % m == 0 &&
         (pl.tile <= GROUP_SPAN || pl.tile == m) &&
         (pl.split == 1 || (pl.tile <= GROUP_SPAN && pl.tile % pl.split == 0 &&
                            pl.tile / pl.split % m == 0));
}

template <int MODE, int NB, bool VEC, typename T>
int run(const T* X, const float* C, int n, int p, const Plan& pl,
        const Epilogue& ep, cudaStream_t stream) {
  const auto kernel = colpass_kernel<MODE, NB, VEC, T>;
  const size_t smem = smem_bytes<MODE>(pl, NB);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = pl.split;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p + pl.tile - 1) / pl.tile, pl.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = pl.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, X, C, n, p, pl, ep);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int MODE, bool VEC, typename T>
int run_b(const T* X, const float* C, int n, int p, int B,
          const Plan& pl, const Epilogue& ep, cudaStream_t stream) {
  if constexpr (MODE == GROUP) {  // a rank-1 centre
    return run<MODE, 1, VEC>(X, C, n, p, pl, ep, stream);
  } else {
    switch (B) {
      case 1: return run<MODE, 1, VEC>(X, C, n, p, pl, ep, stream);
      case 2: return run<MODE, 2, VEC>(X, C, n, p, pl, ep, stream);
      case 3: return run<MODE, 3, VEC>(X, C, n, p, pl, ep, stream);
      case 4: return run<MODE, 4, VEC>(X, C, n, p, pl, ep, stream);
      case 5: return run<MODE, 5, VEC>(X, C, n, p, pl, ep, stream);
      case 6: return run<MODE, 6, VEC>(X, C, n, p, pl, ep, stream);
      case 7: return run<MODE, 7, VEC>(X, C, n, p, pl, ep, stream);
      default: return run<MODE, 8, VEC>(X, C, n, p, pl, ep, stream);
    }
  }
}

// Refuses a plan it cannot run (cudaErrorInvalidValue) and the 16-byte
// path on a p, an X or a GROUP tile that is not 16-byte aligned
// (cudaErrorMisalignedAddress); it never changes the plan it was given.
// T is float, or bf16 for MATVEC and FISTA.
template <int MODE, typename T>
int launch(const T* X, const float* C, int n, int p, int B,
           const Plan& pl, const Epilogue& ep, cudaStream_t stream) {
  constexpr int COLS = Elem<T>::COLS;
  if (n < 0 || p < 1 || B < 1 || B > (MODE == GROUP ? 1 : MAX_B) ||
      !plan_ok<MODE>(pl, ep.m, COLS) || (MODE == GROUP && p % ep.m != 0) ||
      smem_bytes<MODE>(pl, B) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (pl.vec == COLS &&
      (p % COLS != 0 || !aligned16(X) || pl.tile % COLS != 0))
    return (int)cudaErrorMisalignedAddress;
  if constexpr (MODE != MATVEC && MODE != FISTA && COLS != 4) {
    return (int)cudaErrorInvalidValue;  // bf16 X: MATVEC and FISTA only
  } else {
    return pl.vec == COLS
               ? run_b<MODE, true>(X, C, n, p, B, pl, ep, stream)
               : run_b<MODE, false>(X, C, n, p, B, pl, ep, stream);
  }
}

}  // namespace colpass
