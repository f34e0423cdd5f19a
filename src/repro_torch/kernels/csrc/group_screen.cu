// Group screening scores for the PyTorch port (Corollary 21 LHS):
//
//     gscores[g] = || X_g^T c ||_2     for contiguous groups of m columns
//
// of a row-major float32 X (n, p), p % m == 0, and a rank-1 centre c (n,).
// Replaces the Pallas kernel group_screen_scores of
// src/repro/kernels/group_screen.py (its pallas_call at line 68).
//
// What bounds it: it reads X once (n*p*4 bytes) for 2 flops per element, so
// it is bound by the bytes of X, as the screens are. It is the column pass
// of colpass.cuh with the GROUP epilogue: tiles of whole groups (120
// columns for m = 5, 10, 20), float4 loads where p % 4 == 0 and X is
// aligned, the centre staged once, and the group norms taken from the
// tile's dots in shared memory, so only the p / m scores reach device
// memory. The launch plan (vec, tile, split, stage_rows) comes from the
// caller (group_plan in group_screen.py). Launches on the given stream,
// does not synchronise, and returns the launch's cudaError_t (0 on
// success).
#include "colpass.cuh"

extern "C" int group_screen_scores_f32(const float* X, const float* c, int n,
                                       int p, int m, int vec, int tile,
                                       int split, int stage_rows,
                                       float* gscores, void* stream) {
  colpass::Epilogue ep{nullptr, 0.f,     0.f,     0.f, nullptr,
                       nullptr, gscores, nullptr, m};
  return colpass::launch<colpass::GROUP>(
      X, c, n, p, 1, colpass::Plan{vec, tile, split, stage_rows}, ep,
      static_cast<cudaStream_t>(stream));
}
