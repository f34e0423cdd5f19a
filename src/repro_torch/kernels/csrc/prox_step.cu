// The FISTA prox and momentum over p-vectors for the PyTorch port:
//
//     g     = g_0 + g_1 + ... + g_{k-1}          (k = parts, in index order)
//     u     = z - step_b * g
//     beta' = sign(u) * max(|u| - step_b * lam_b, 0)
//     z'    = beta' + mom_b * (beta' - beta_old)
//
// for z, beta_old of shape (B, p), row-major, g a stack (k, B, p) of the
// gradient's parts (1 <= k <= MAX_PARTS; k = 1 is a plain gradient), and
// per-query step, lam, mom. Replaces the Pallas kernel prox_step of
// src/repro/kernels/prox_step.py, which padded B to 8 and p to 1024-wide
// tiles and carried the scalars in a (3, Bp) block; here nothing is padded.
// The distributed FISTA's "chunked" mode computes its gradient as one part
// per row chunk and the reference adds them with functools.reduce(jnp.add);
// summing them here, each addition rounded on its own in index order,
// gives the same bits as that chain of additions and saves its k - 1
// launches per iteration.
//
// A pure elementwise pass: it reads k + 2 and writes two float32 values per
// element and does 7 + k flops on them, so it is bound by the bytes
// (4 * (k + 4) per element) and, at the widths of the distributed solver
// (B * p of 1e4 to 1e6), by the launch: the solver replays its launches
// from a CUDA graph (repro_torch/core/graphs.py), which takes the host's
// launch out of each iteration. Grid-stride over the flattened B * p
// elements, one thread per 4 of them: float4 loads and stores when
// p % 4 == 0 and every pointer is 16-byte aligned (the 4 elements then
// share a query, and each part starts 16-byte aligned), scalar accesses
// otherwise and for the tail. The query index comes from the flattened
// offset.
//
// Per-query parameters: `params` is null (then step, lam, mom hold for
// every query, passed by value) or a device array (3, B) row-major:
// step | lam | mom. A solver loop replayed from a graph passes a row of its
// parameter table here, so each replayed launch reads that iteration's
// momentum.
//
// Each product, sum and difference is rounded on its own (no fused
// multiply-add contraction), as the plain PyTorch version rounds them, so
// the two agree bit for bit. Launches on the given stream, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTS = 8;

struct Params {
  const float* dev;  // (3, B) or null
  float step, lam, mom;
};

__device__ __forceinline__ void query_params(const Params& pr, int B, int b,
                                             float& step, float& lam,
                                             float& mom) {
  if (pr.dev) {
    step = __ldg(pr.dev + b);
    lam = __ldg(pr.dev + B + b);
    mom = __ldg(pr.dev + 2 * B + b);
  } else {
    step = pr.step;
    lam = pr.lam;
    mom = pr.mom;
  }
}

__device__ __forceinline__ void prox1(float z, float g, float bo, float step,
                                      float t, float mom, float& beta,
                                      float& zn) {
  const float u = __fsub_rn(z, __fmul_rn(step, g));
  const float m = fmaxf(__fsub_rn(fabsf(u), t), 0.f);
  beta = u > 0.f ? m : (u < 0.f ? -m : 0.f);
  zn = __fadd_rn(beta, __fmul_rn(mom, __fsub_rn(beta, bo)));
}

// SUM: parts > 1. A plain gradient (parts == 1) takes an instantiation
// without the parts' loop, so it runs the code of the one-part kernel.
template <bool VEC, bool SUM>
__global__ void __launch_bounds__(THREADS)
prox_step_kernel(const float* __restrict__ z, const float* __restrict__ g,
                 int parts, const float* __restrict__ bo, int B, int p,
                 Params pr, float* __restrict__ beta,
                 float* __restrict__ zn) {
  const int64_t total = (int64_t)B * p;
  const int64_t quads = (total + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {
    const int64_t e0 = 4 * q;
    if (VEC) {  // p % 4 == 0: the four elements belong to one query
      const int b = (int)(e0 / p);
      float step, lam, mom;
      query_params(pr, B, b, step, lam, mom);
      const float t = __fmul_rn(step, lam);
      const float4 zv = __ldg(reinterpret_cast<const float4*>(z) + q);
      float4 gv = __ldg(reinterpret_cast<const float4*>(g) + q);
      const float4 bv = __ldg(reinterpret_cast<const float4*>(bo) + q);
#pragma unroll
      for (int j = 1; j < MAX_PARTS; ++j) {  // in index order, as the chain
        if (SUM && j < parts) {
          const float4 h =
              __ldg(reinterpret_cast<const float4*>(g + j * total) + q);
          gv.x = __fadd_rn(gv.x, h.x);
          gv.y = __fadd_rn(gv.y, h.y);
          gv.z = __fadd_rn(gv.z, h.z);
          gv.w = __fadd_rn(gv.w, h.w);
        }
      }
      float4 ov, nv;
      prox1(zv.x, gv.x, bv.x, step, t, mom, ov.x, nv.x);
      prox1(zv.y, gv.y, bv.y, step, t, mom, ov.y, nv.y);
      prox1(zv.z, gv.z, bv.z, step, t, mom, ov.z, nv.z);
      prox1(zv.w, gv.w, bv.w, step, t, mom, ov.w, nv.w);
      reinterpret_cast<float4*>(beta)[q] = ov;
      reinterpret_cast<float4*>(zn)[q] = nv;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t e = e0 + k;
        if (e >= total) break;
        const int b = (int)(e / p);
        float step, lam, mom;
        query_params(pr, B, b, step, lam, mom);
        float ge = __ldg(g + e);
        for (int j = 1; SUM && j < parts; ++j)
          ge = __fadd_rn(ge, __ldg(g + j * total + e));
        prox1(__ldg(z + e), ge, __ldg(bo + e), step, __fmul_rn(step, lam), mom,
              beta[e], zn[e]);
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// g holds `parts` stacked (B, p) arrays, one after the other.
extern "C" int prox_step_f32(const float* z, const float* g, int parts,
                             const float* beta_old, int B, int p,
                             const float* params, float step, float lam,
                             float mom, float* beta_new, float* z_new,
                             void* stream) {
  if (B < 1 || p < 1 || parts < 1 || parts > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      sms = 132;
  }
  const int64_t quads = ((int64_t)B * p + 3) / 4;
  const int64_t want = (quads + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 16 * (int64_t)sms ? want : 16 * (int64_t)sms);
  const Params pr{params, step, lam, mom};
  const bool vec = p % 4 == 0 && aligned16(z) && aligned16(g) &&
                   aligned16(beta_old) && aligned16(beta_new) &&
                   aligned16(z_new);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = vec ? (parts > 1 ? prox_step_kernel<true, true>
                                 : prox_step_kernel<true, false>)
                    : (parts > 1 ? prox_step_kernel<false, true>
                                 : prox_step_kernel<false, false>);
  kernel<<<blocks, THREADS, 0, s>>>(z, g, parts, beta_old, B, p, pr, beta_new,
                                    z_new);
  return (int)cudaGetLastError();
}
