// Cyclic coordinate descent over a Gram system, for the PyTorch port:
//
//     q    = beta G                                   (G = X^T X, symmetric)
//     for sweeps x j = 0 .. p-1:
//       rho_j  = c_j - q_j + G_jj beta_j
//       beta_j' = S(rho_j, lam_b) / G_jj   (0 where G_jj = 0 or valid_j = 0)
//       q     += G[j, :] (beta_j' - beta_j)
//
// Replaces the Pallas kernel cd_gram_sweep of
// src/repro/kernels/solver_step.py (its pallas_call at line 251), which kept
// all of G in VMEM.
//
// What bounds it: the coordinates form a chain of sweeps*p dependent steps
// (every update reads the q the previous one wrote), so one query's sweep
// cannot be split over blocks, and its time is that chain's latency, far
// above both the bytes of G (p*p*4, read from L2 after the first sweep) and
// its 2*(sweeps+1)*p*p flops.
//
// Design: one block per query (the wrapper launches at most MAX_B), one
// thread per coordinate, p rounded up to a whole warp, p <= 1024. Thread k
// keeps beta_k, c_k, q_k, valid_k and G_kk in registers. q0 = beta G is summed
// in the kernel over rows in a fixed order. At coordinate j, thread j alone
// computes the new beta_j and publishes the change delta through shared memory
// (two slots, alternating, so one barrier per coordinate suffices); after the
// barrier every thread adds G[j, k] * delta to q_k. G is symmetric, so row j
// stands for column j and is read coalesced; each thread loads its element
// of the next row before the barrier, so the load overlaps the barrier wait.
// A 1024^2 float32 G is 4 MiB: more than an SM's shared memory, but it stays
// resident in the 50 MB L2 across sweeps. No atomics: the result is the same
// from run to run. The per-coordinate arithmetic is not contracted into fused
// multiply-adds, so it rounds as the plain PyTorch version's does.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_P = 1024;  // GRAM_BUCKET_MAX: one thread per coordinate
constexpr int MAX_B = 8;     // queries per launch; the wrapper splits more

__global__ void __launch_bounds__(MAX_P)
cd_gram_kernel(const float* __restrict__ G, const float* __restrict__ C,
               const float* __restrict__ beta0,
               const float* __restrict__ valid, int p, int sweeps,
               const float* __restrict__ lam_dev, float lam_s,
               float* __restrict__ beta_out) {
  __shared__ float beta_s[MAX_P];
  __shared__ float delta_s[2];

  const int k = threadIdx.x;
  const int b = blockIdx.x;
  const bool live = k < p;
  const size_t off = (size_t)b * p + k;
  const float lam = lam_dev ? lam_dev[b] : lam_s;

  float bk = live ? beta0[off] : 0.f;
  const float ck = live ? C[off] : 0.f;
  const float vk = live ? (valid ? valid[off] : 1.f) : 0.f;
  const float gkk = live ? G[(size_t)k * p + k] : 0.f;

  beta_s[k] = bk;
  __syncthreads();
  float qk = 0.f;  // q_k = sum_j beta_j G[j, k], rows in order
  if (live)
    for (int j = 0; j < p; ++j) qk = fmaf(beta_s[j], G[(size_t)j * p + k], qk);

  float g_cur = live ? G[k] : 0.f;  // G[0, k]
  int slot = 0;
  for (int s = 0; s < sweeps; ++s) {
    for (int j = 0; j < p; ++j) {
      if (k == j) {
        const float rho = __fadd_rn(ck - qk, __fmul_rn(gkk, bk));
        float bn = 0.f;
        if (gkk > 0.f) {
          const float mag = fmaxf(fabsf(rho) - lam, 0.f);
          bn = (rho < 0.f ? -mag : mag) / fmaxf(gkk, 1e-30f);
        }
        bn *= vk;
        delta_s[slot] = bn - bk;
        bk = bn;
      }
      const int jn = j + 1 == p ? 0 : j + 1;
      const float g_next = live ? G[(size_t)jn * p + k] : 0.f;
      __syncthreads();
      qk = __fadd_rn(qk, __fmul_rn(g_cur, delta_s[slot]));
      g_cur = g_next;
      slot ^= 1;
    }
  }
  if (live) beta_out[off] = bk;
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
  const int threads = (p + 31) / 32 * 32;
  cd_gram_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      G, C, beta, valid, p, sweeps, lam_dev, lam, beta_out);
  return (int)cudaGetLastError();
}
