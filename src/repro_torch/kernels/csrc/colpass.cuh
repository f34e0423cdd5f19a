// One streaming pass over the columns of a row-major float32 X (n, p):
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
//
// Layout: a block owns TILE_P consecutive columns (threadIdx.x) and all n
// rows, split over blockDim.y row phases. A warp is 32 threads of one row
// phase on 32 consecutive columns, so every row read is one coalesced
// 128-byte segment. The centre rows C[:, i0:i0+CHUNK_N] are staged in
// shared memory and read back as broadcasts. Each thread keeps NB dot
// partials (and the sum of squares) in registers; the row phases are then
// summed through shared memory in a fixed order, so results do not change
// from run to run. Columns past p are masked; a zero row or a zero column
// of X adds exactly nothing.
//
// The kernel reads X once and writes each output once: for the main
// path's B <= 8 it does at most 2*B flops per 4-byte element of X, far
// below the card's flop/byte balance, so it is bound by the bytes of X.
#pragma once

#include <cuda_runtime.h>

namespace colpass {

constexpr int TILE_P = 32;   // columns per block: one warp-wide segment
constexpr int CHUNK_N = 128; // centre rows staged in shared memory per step
constexpr int MAX_B = 8;     // queries per launch; the wrapper splits more

enum Mode { MATVEC = 0, SCORES = 1, FISTA = 2 };

// Per-query parameters: `params` is null (then the scalars s0..s2 hold for
// every query) or a device array (3, B) row-major: rho | step, lam, mom.
struct Epilogue {
  const float* params;
  float s0, s1, s2;
  const float* z;         // FISTA: (B, p)
  const float* beta_old;  // FISTA: (B, p)
  float* out0;            // (B, p)
  float* out1;            // SCORES: (p,); FISTA: (B, p)
};

__device__ __forceinline__ float param(const Epilogue& ep, int row, int b,
                                       int nb, float fallback) {
  return ep.params ? ep.params[row * nb + b] : fallback;
}

template <int MODE, int NB>
__global__ void __launch_bounds__(1024)
colpass_kernel(const float* __restrict__ X, const float* __restrict__ C,
               int n, int p, Epilogue ep) {
  extern __shared__ float smem[];
  float* c_s = smem;                     // [NB][CHUNK_N]
  float* red = smem + NB * CHUNK_N;      // [blockDim.y][NB + 1][TILE_P]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ry = blockDim.y;
  const int tid = ty * TILE_P + tx;
  const int nthreads = ry * TILE_P;
  const int col = blockIdx.x * TILE_P + tx;
  const bool live = col < p;

  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  float ss = 0.f;

  for (int i0 = 0; i0 < n; i0 += CHUNK_N) {
    const int rows = min(CHUNK_N, n - i0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = tid; e < NB * CHUNK_N; e += nthreads) {
      const int b = e / CHUNK_N;
      const int i = e - b * CHUNK_N;
      c_s[e] = i < rows ? C[(size_t)b * n + i0 + i] : 0.f;
    }
    __syncthreads();
    if (live) {
      const float* xp = X + (size_t)i0 * p + col;
#pragma unroll 4
      for (int i = ty; i < rows; i += ry) {
        const float x = __ldg(xp + (size_t)i * p);
        if (MODE == SCORES) ss = fmaf(x, x, ss);
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] = fmaf(c_s[b * CHUNK_N + i], x, acc[b]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b) red[(ty * (NB + 1) + b) * TILE_P + tx] = acc[b];
  red[(ty * (NB + 1) + NB) * TILE_P + tx] = ss;
  __syncthreads();
  if (ty != 0 || !live) return;

  float sq = 0.f;
  if (MODE == SCORES) {
    for (int y = 0; y < ry; ++y) sq += red[(y * (NB + 1) + NB) * TILE_P + tx];
    ep.out1[col] = sq;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float d = 0.f;
    for (int y = 0; y < ry; ++y) d += red[(y * (NB + 1) + b) * TILE_P + tx];
    const size_t o = (size_t)b * p + col;
    if (MODE == MATVEC) {
      ep.out0[o] = d;
    } else if (MODE == SCORES) {
      ep.out0[o] = fabsf(d) + param(ep, 0, b, NB, ep.s0) * sqrtf(sq);
    } else {
      const float step = param(ep, 0, b, NB, ep.s0);
      const float lam = param(ep, 1, b, NB, ep.s1);
      const float mom = param(ep, 2, b, NB, ep.s2);
      const float u = ep.z[o] - step * d;
      const float m = fmaxf(fabsf(u) - step * lam, 0.f);
      const float beta = u > 0.f ? m : (u < 0.f ? -m : 0.f);
      ep.out0[o] = beta;
      ep.out1[o] = beta + mom * (beta - ep.beta_old[o]);
    }
  }
}

template <int MODE, int NB>
int run(const float* X, const float* C, int n, int p, const Epilogue& ep,
        int ry, cudaStream_t stream) {
  const dim3 block(TILE_P, ry);
  const dim3 grid((p + TILE_P - 1) / TILE_P);
  const size_t smem = (size_t)(NB * CHUNK_N + ry * (NB + 1) * TILE_P) * sizeof(float);
  colpass_kernel<MODE, NB><<<grid, block, smem, stream>>>(X, C, n, p, ep);
  return (int)cudaGetLastError();
}

// Row phases per block: 32 when the blocks alone cannot fill two waves of
// the card's SMs (the narrow reduced buckets of the solver), else 8 (the
// wide screening passes, where the grid already fills it).
inline int row_phases_for_blocks(int blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return blocks < 2 * sms ? 32 : 8;
}

inline int row_phases(int p) { return row_phases_for_blocks((p + TILE_P - 1) / TILE_P); }

template <int MODE>
int launch(const float* X, const float* C, int n, int p, int B,
           const Epilogue& ep, cudaStream_t stream) {
  if (n < 0 || p < 1 || B < 1 || B > MAX_B) return (int)cudaErrorInvalidValue;
  const int ry = row_phases(p);
  switch (B) {
    case 1: return run<MODE, 1>(X, C, n, p, ep, ry, stream);
    case 2: return run<MODE, 2>(X, C, n, p, ep, ry, stream);
    case 3: return run<MODE, 3>(X, C, n, p, ep, ry, stream);
    case 4: return run<MODE, 4>(X, C, n, p, ep, ry, stream);
    case 5: return run<MODE, 5>(X, C, n, p, ep, ry, stream);
    case 6: return run<MODE, 6>(X, C, n, p, ep, ry, stream);
    case 7: return run<MODE, 7>(X, C, n, p, ep, ry, stream);
    default: return run<MODE, 8>(X, C, n, p, ep, ry, stream);
  }
}

}  // namespace colpass
