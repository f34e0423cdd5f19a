// Group screening scores for the PyTorch port (Corollary 21 LHS):
//
//     gscores[g] = || X_g^T c ||_2     for contiguous groups of m columns
//
// of a row-major float32 X (n, p), p % m == 0, and a rank-1 centre c (n,).
// Replaces the Pallas kernel group_screen_scores of
// src/repro/kernels/group_screen.py (its pallas_call at line 68).
//
// What bounds it: it reads X once (n*p*4 bytes) for 2 flops per element, so
// it is bound by the bytes of X, as the column passes of colpass.cuh are.
//
// Design: a column pass of its own (32 lanes on 32 consecutive columns,
// blockDim.y row phases, the centre staged in shared memory in CHUNK_N-row
// pieces, row phases summed in a fixed order), with a block's
// columns cut on group boundaries: a block owns gpb whole groups, gpb*m
// columns, walked 32 at a time. gpb = 32 / gcd(m, 32) makes the tile
// lcm(m, 32) columns wide (160 for m = 5, 10, 20), so every 32-column step
// is a full, 128-byte-aligned row segment; above 1024 columns a tile holds
// fewer groups. After each 32-column step the lanes of warp 0 square their
// column's dot, and lane g adds the squares of its group's columns in
// column order; the lane's running sum is the group's. Only the p/m group
// scores reach device memory: the p dots stay in registers and shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;     // columns per step: one warp-wide segment
constexpr int CHUNK_N = 128;  // centre rows staged in shared memory per step
constexpr int MAX_RY = 32;

// Row phases per block: 32 when the blocks alone cannot fill two waves of
// the card's SMs, else 8.
int row_phases_for_blocks(int blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return blocks < 2 * sms ? 32 : 8;
}

__global__ void __launch_bounds__(LANES * MAX_RY)
group_scores_kernel(const float* __restrict__ X, const float* __restrict__ c,
                    int n, int p, int m, int gpb, float* __restrict__ out) {
  __shared__ float c_s[CHUNK_N];
  __shared__ float red[MAX_RY][LANES];
  __shared__ float sq_s[LANES];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ry = blockDim.y;
  const int tid = ty * LANES + tx;
  const int nthreads = ry * LANES;
  const int groups = p / m;
  const int g0 = blockIdx.x * gpb;
  const int ng = min(gpb, groups - g0);
  const int width = ng * m;
  const float* xb = X + (size_t)g0 * m;

  float gsum = 0.f;  // warp 0, lane g < ng: the sum of squares of group g0 + g
  for (int c0 = 0; c0 < width; c0 += LANES) {
    const int lc = c0 + tx;
    const bool live = lc < width;
    float acc = 0.f;
    for (int i0 = 0; i0 < n; i0 += CHUNK_N) {
      const int rows = min(CHUNK_N, n - i0);
      __syncthreads();  // the previous piece of the centre is consumed
      for (int e = tid; e < CHUNK_N; e += nthreads) c_s[e] = e < rows ? c[i0 + e] : 0.f;
      __syncthreads();
      if (live) {
        const float* xp = xb + (size_t)i0 * p + lc;
#pragma unroll 4
        for (int i = ty; i < rows; i += ry) acc = fmaf(c_s[i], __ldg(xp + (size_t)i * p), acc);
      }
    }
    red[ty][tx] = acc;
    __syncthreads();
    if (ty == 0) {
      float d = 0.f;
      for (int y = 0; y < ry; ++y) d += red[y][tx];
      sq_s[tx] = live ? d * d : 0.f;
      __syncwarp();
      if (tx < ng) {
        const int lo = max(tx * m, c0);
        const int hi = min((tx + 1) * m, c0 + LANES);
        for (int l = lo; l < hi; ++l) gsum += sq_s[l - c0];
      }
      __syncwarp();  // sq_s is read before the next step writes it
    }
    __syncthreads();  // red is read before the next step writes it
  }
  if (ty == 0 && tx < ng) out[g0 + tx] = sqrtf(gsum);
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// Launches on the given stream, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" int group_screen_scores_f32(const float* X, const float* c, int n,
                                       int p, int m, float* gscores,
                                       void* stream) {
  if (n < 0 || p < 1 || m < 1 || p % m) return (int)cudaErrorInvalidValue;
  int gpb = LANES / gcd(m, LANES);
  if ((long long)gpb * m > 1024) gpb = m >= 1024 ? 1 : 1024 / m;
  const int blocks = (p / m + gpb - 1) / gpb;
  const dim3 block(LANES, row_phases_for_blocks(blocks));
  group_scores_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      X, c, n, p, m, gpb, gscores);
  return (int)cudaGetLastError();
}
