// Fused FISTA iteration tail for the PyTorch port (see colpass.cuh): one
// pass over X computes g = R X and applies the soft-threshold and the
// momentum step per column, so the gradient never reaches device memory.
//
// Replaces the Pallas kernel fista_step of
// src/repro/kernels/solver_step.py. The launch plan (vec, tile, split,
// stage_rows) comes from the caller (launch_plan in edpp_screen.py).
// Launches on the given stream, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
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
