// Fused FISTA iteration tail for the PyTorch port (see colpass.cuh): one
// pass over X computes g = R X and applies the soft-threshold and the
// momentum step per column, so the gradient never reaches device memory.
//
//   fista_step_f32   X float
//   fista_step_bf16  X the bf16 copy of a solve bucket (the mixed-precision
//                    solve's iterations): 8 columns a lane, one 16-byte
//                    load, each value widened exactly where it meets r;
//                    R, Z, beta_old, the sums, beta' and z' stay float
//
// Replaces the Pallas kernel fista_step of
// src/repro/kernels/solver_step.py (its float and bf16 X). The launch plan
// (vec, tile, split, stage_rows) comes from the caller (launch_plan in
// edpp_screen.py). Launches on the given stream, does not synchronise, and
// returns the launch's cudaError_t (0 on success).
#include "colpass.cuh"

extern "C" int fista_step_f32(const float* X, const float* R, const float* Z,
                              const float* beta_old, int n, int p, int B,
                              int vec, int tile, int split, int stage_rows,
                              const float* params, float step, float lam,
                              float mom, float* beta_new, float* z_new,
                              void* stream) {
  colpass::Epilogue ep{params, step, lam, mom, Z, beta_old, beta_new, z_new};
  return colpass::launch<colpass::FISTA>(
      X, R, n, p, B, colpass::Plan{vec, tile, split, stage_rows}, ep,
      static_cast<cudaStream_t>(stream));
}

extern "C" int fista_step_bf16(const __nv_bfloat16* X, const float* R,
                               const float* Z, const float* beta_old, int n,
                               int p, int B, int vec, int tile, int split,
                               int stage_rows, const float* params,
                               float step, float lam, float mom,
                               float* beta_new, float* z_new, void* stream) {
  colpass::Epilogue ep{params, step, lam, mom, Z, beta_old, beta_new, z_new};
  return colpass::launch<colpass::FISTA>(
      X, R, n, p, B, colpass::Plan{vec, tile, split, stage_rows}, ep,
      static_cast<cudaStream_t>(stream));
}
