// Cyclic coordinate descent over a Gram system, for the PyTorch port:
//
//     q    = beta G                                   (G = X^T X, symmetric)
//     for sweeps x j = 0 .. p-1:
//       rho_j  = c_j - q_j + G_jj beta_j
//       beta_j' = S(rho_j, lam_b) / G_jj   (0 where G_jj = 0 or valid_j = 0)
//       q     += G[j, :] (beta_j' - beta_j)   (row j: G is symmetric)
//
// Replaces the Pallas kernel cd_gram_sweep of
// src/repro/kernels/solver_step.py (its pallas_call at line 251), which kept
// all of G in VMEM.
//
// What bounds it: the coordinates form a chain of sweeps*p dependent steps
// (every update reads the q the previous one wrote), so one query's sweep
// cannot be split over blocks, and its time is that chain's latency, far
// above both the bytes of G (p*p*4, read from L2 after the first sweep) and
// its 2*(sweeps+1)*p*p flops. One step's latency is the update's arithmetic,
// the IEEE division and one warp shuffle; cd_chain_f32 times it alone.
//
// Design: one block per query (the wrapper launches at most MAX_B), the
// coordinates cut into chunks of 32, one warp a chunk, lane l owning
// coordinate k = 32 * warp + l and keeping beta_k, c_k, q_k, valid_k and
// G_kk in registers. q0 = beta G is summed over rows in a fixed order.
//
//   p <= 32: one warp holds the whole system. Lane k keeps G[0..p), k] in
//   registers, so the sweeps make no loads. At step j every lane computes
//   its own coordinate's update, lane j's is broadcast with __shfl_sync
//   and taken, and every lane adds G[j, k] * delta_j to q_k: no shared
//   memory, no barrier, no divergent branch.
//
//   p > 32: the warp that owns chunk c runs its 32 steps the same way,
//   with its diagonal block G[chunk, chunk] staged in shared memory at the
//   start (read into registers at the start of its turn), publishes the
//   32 deltas in shared memory, and one block barrier follows per chunk.
//   Every other warp then adds the 32 deltas to its q_k in order j, each as
//   q_k + G[j, k] * delta_j rounded separately, from the block G[chunk, k]
//   that it loaded before the barrier (one 128-byte row segment a load),
//   and loads its block for the next chunk. That is the plain version's
//   sequence of operations on every q_k, so the result does not depend on
//   the schedule.
//
// No atomics: the result is the same from run to run. The per-coordinate
// arithmetic is not contracted into fused multiply-adds, so it rounds as
// the plain PyTorch version's does.
//
// Measured (chip_smoke.py --kernels, NVIDIA H100 80GB HBM3, 700.00 W; the
// rest in PERF.md section 6): one step of the chain 75 ns; 10 sweeps at
// p = 32 0.031 ms (97 ns a step with the launch), at p = 1024 1.53 ms
// (149 ns a step): there the other warps' loads of their next block slow
// the owning warp's turn (with more warps, more of it).
#include <cuda_runtime.h>

namespace {

constexpr int MAX_P = 1024;  // GRAM_BUCKET_MAX: at most 32 chunks of 32
constexpr int MAX_B = 8;     // queries per launch; the wrapper splits more
constexpr int CHUNK = 32;    // coordinates of one warp's turn
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t DEFAULT_SMEM = 49152;  // above this a kernel must opt in

// One lane's coordinate: what its update reads besides q_k and beta_k.
struct Coord {
  float c;      // c_k
  float gkk;    // G_kk
  float den;    // max(G_kk, 1e-30), or 1 where G_kk <= 0 (the update is 0)
  float valid;  // 1, or 0 where the query screened k out (and past p)
};

__device__ __forceinline__ Coord load_coord(const float* __restrict__ G,
                                            const float* __restrict__ C,
                                            const float* __restrict__ valid,
                                            int p, size_t off, int k) {
  Coord cd{0.f, 0.f, 1.f, 0.f};
  if (k < p) {
    cd.c = C[off];
    cd.gkk = G[(size_t)k * p + k];
    cd.den = cd.gkk > 0.f ? fmaxf(cd.gkk, 1e-30f) : 1.f;
    cd.valid = valid ? valid[off] : 1.f;
  }
  return cd;
}

// The new beta_k, rounded as the plain version rounds it:
//   rho = (c - q) + G_kk beta,  beta' = valid * sign(rho) max(|rho| - lam, 0)
//   / G_kk, 0 where G_kk <= 0. Every lane divides (the quotient is taken
//   where it is needed), so the dividend of a zero magnitude is replaced
//   by 1, and the quotient signed after the division: a zero dividend
//   would send the whole warp down the division's slow path.
__device__ __forceinline__ float update(const Coord& cd, float q, float b,
                                        float lam) {
  const float rho = __fadd_rn(__fsub_rn(cd.c, q), __fmul_rn(cd.gkk, b));
  const float mag = fmaxf(__fsub_rn(fabsf(rho), lam), 0.f);
  const bool some = mag > 0.f;
  const float div = __fdiv_rn(some ? mag : 1.f, cd.den);
  const float quo = some ? div : 0.f;
  const float bn = cd.gkk > 0.f ? (rho < 0.f ? -quo : quo) : 0.f;
  return __fmul_rn(bn, cd.valid);
}

// One warp's turn over a chunk of `live` coordinates: at step i lane i's
// update is broadcast and taken, and every lane adds g[i] * delta_i to its
// q, where g[i] = G[chunk's i-th coordinate, k]. Returns the lane's own
// delta.
__device__ __forceinline__ float turn(const float (&g)[CHUNK], int live,
                                      const Coord& cd, float lam, float& q,
                                      float& b, int lane) {
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    if (i < live) {  // the same for every lane
      const float bn = update(cd, q, b, lam);
      const float d = __shfl_sync(FULL, __fsub_rn(bn, b), i);
      b = lane == i ? bn : b;
      mine = lane == i ? d : mine;
      q = __fadd_rn(q, __fmul_rn(g[i], d));
    }
  }
  return mine;
}

// p <= 32: one warp a query.
__global__ void __launch_bounds__(CHUNK)
cd_warp_kernel(const float* __restrict__ G, const float* __restrict__ C,
               const float* __restrict__ beta0,
               const float* __restrict__ valid, int p, int sweeps,
               const float* __restrict__ lam_dev, float lam_s,
               float* __restrict__ beta_out) {
  const int k = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * p + k;
  const float lam = lam_dev ? lam_dev[blockIdx.x] : lam_s;
  const Coord cd = load_coord(G, C, valid, p, off, k);
  float b = k < p ? beta0[off] : 0.f;

  float g[CHUNK];  // G[0..p), k]
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    g[i] = i < p && k < p ? G[(size_t)i * p + k] : 0.f;
  float q = 0.f;  // q_k = sum_j beta_j G[j, k], rows in order
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    const float bj = __shfl_sync(FULL, b, j);
    if (j < p && k < p) q = fmaf(bj, g[j], q);
  }
  for (int s = 0; s < sweeps; ++s) turn(g, p, cd, lam, q, b, k);
  if (k < p) beta_out[off] = b;
}

// Shared memory of the block kernel, in floats: the diagonal blocks
// [chunks][CHUNK][CHUNK], beta [chunks * CHUNK] (for q0), the deltas
// [2][CHUNK].
inline size_t block_smem_floats(int chunks) {
  return (size_t)chunks * CHUNK * CHUNK + (size_t)chunks * CHUNK + 2 * CHUNK;
}

// g[i] = G[j0 + i, k] for the chunk starting at row j0 (0 past p): each
// load of the warp reads 32 consecutive floats of one row.
__device__ __forceinline__ void load_block(float (&g)[CHUNK],
                                           const float* __restrict__ G, int p,
                                           int k, int j0) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    g[i] = k < p && j0 + i < p ? __ldg(G + (size_t)(j0 + i) * p + k) : 0.f;
}

// 32 < p <= 1024: one warp a chunk, one block barrier a chunk.
__global__ void __launch_bounds__(MAX_P)
cd_block_kernel(const float* __restrict__ G, const float* __restrict__ C,
                const float* __restrict__ beta0,
                const float* __restrict__ valid, int p, int sweeps,
                const float* __restrict__ lam_dev, float lam_s,
                float* __restrict__ beta_out) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int chunks = blockDim.x / CHUNK;
  float* const diag = smem;                               // [chunks][32][32]
  float* const beta_s = diag + (size_t)chunks * CHUNK * CHUNK;
  float* const delta_s = beta_s + chunks * CHUNK;         // [2][32]

  const int tid = threadIdx.x, warp = tid / CHUNK, lane = tid % CHUNK;
  const int k = tid;
  const size_t off = (size_t)blockIdx.x * p + k;
  const float lam = lam_dev ? lam_dev[blockIdx.x] : lam_s;
  const Coord cd = load_coord(G, C, valid, p, off, k);
  float b = k < p ? beta0[off] : 0.f;

  // diag[c][i][l] = G[32c + i, 32c + l], the chunk's rows in order
  for (int e = tid; e < chunks * CHUNK * CHUNK; e += blockDim.x) {
    const int c = e / (CHUNK * CHUNK), i = e / CHUNK % CHUNK, l = e % CHUNK;
    const int r = c * CHUNK + i, j = c * CHUNK + l;
    diag[e] = r < p && j < p ? G[(size_t)r * p + j] : 0.f;
  }
  beta_s[k] = b;
  __syncthreads();
  float q = 0.f;  // q_k = sum_j beta_j G[j, k], rows in order
  if (k < p)
    for (int j = 0; j < p; ++j) q = fmaf(beta_s[j], G[(size_t)j * p + k], q);

  // g: this warp's block for the next chunk (G[chunk, k]), or, on its own
  // turn, its diagonal block
  float g[CHUNK];
  if (warp != 0) load_block(g, G, p, k, 0);
  int slot = 0;
  for (int s = 0; s < sweeps; ++s) {
    for (int c = 0; c < chunks; ++c) {
      const int live = min(CHUNK, p - c * CHUNK);
      float* const ds = delta_s + slot * CHUNK;
      if (warp == c) {
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          g[i] = diag[(c * CHUNK + i) * CHUNK + lane];
        ds[lane] = turn(g, live, cd, lam, q, b, lane);
      }
      __syncthreads();  // the chunk's deltas are published
      if (warp != c) {
#pragma unroll
        for (int i = 0; i < CHUNK; i += 4) {
          const float4 d = reinterpret_cast<const float4*>(ds)[i / 4];
          const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i + u < live) q = __fadd_rn(q, __fmul_rn(g[i + u], dv[u]));
        }
      }
      const int cn = c + 1 == chunks ? 0 : c + 1;
      if (warp != cn && (s + 1 < sweeps || c + 1 < chunks))
        load_block(g, G, p, k, cn * CHUNK);
      slot ^= 1;
    }
  }
  if (k < p) beta_out[off] = b;
}

// The chain alone: one warp runs `reps` turns of `live` steps on a system
// held in registers (G_kk = gkk on the diagonal, small off it; no loads),
// for timing one step. Every value comes from the arguments, so that the
// compiler folds nothing that the sweep computes.
__global__ void __launch_bounds__(CHUNK)
cd_chain_kernel(int reps, int live, float lam, float gkk,
                float* __restrict__ out) {
  const int lane = threadIdx.x;
  float g[CHUNK];
#pragma unroll
  for (int i = 0; i < CHUNK; ++i)
    g[i] = i == lane ? gkk : 0.005f * gkk / (float)(1 + i + lane);
  const Coord cd{1.f + 0.03125f * lane, gkk,
                 gkk > 0.f ? fmaxf(gkk, 1e-30f) : 1.f, gkk > 0.f ? 1.f : 0.f};
  float q = 0.f, b = 0.f;
  for (int r = 0; r < reps; ++r) turn(g, live, cd, lam, q, b, lane);
  out[lane] = b + q;
}

}  // namespace

// Launches on the given stream, does not synchronise, and returns the
// launch's cudaError_t (0 on success). lam_dev is null (lam holds for every
// query) or a device array of B per-query values; valid may be null.
extern "C" int cd_gram_sweep_f32(const float* G, const float* C,
                                 const float* beta, const float* valid, int p,
                                 int B, int sweeps, const float* lam_dev,
                                 float lam, float* beta_out, void* stream) {
  if (p < 1 || p > MAX_P || B < 1 || B > MAX_B || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= CHUNK) {
    cd_warp_kernel<<<B, CHUNK, 0, st>>>(G, C, beta, valid, p, sweeps, lam_dev,
                                        lam, beta_out);
    return (int)cudaGetLastError();
  }
  const int chunks = (p + CHUNK - 1) / CHUNK;
  const size_t smem = block_smem_floats(chunks) * sizeof(float);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        cd_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cd_block_kernel<<<B, chunks * CHUNK, smem, st>>>(G, C, beta, valid, p,
                                                   sweeps, lam_dev, lam,
                                                   beta_out);
  return (int)cudaGetLastError();
}

// Launches the one-warp chain kernel: `reps` turns of `live` <= 32
// dependent steps, writing 32 floats to `out`.
extern "C" int cd_chain_f32(int reps, int live, float lam, float gkk,
                            float* out, void* stream) {
  if (reps < 0 || live < 1 || live > CHUNK) return (int)cudaErrorInvalidValue;
  cd_chain_kernel<<<1, CHUNK, 0, static_cast<cudaStream_t>(stream)>>>(
      reps, live, lam, gkk, out);
  return (int)cudaGetLastError();
}
