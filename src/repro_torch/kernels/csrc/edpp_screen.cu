// Screening passes over X for the PyTorch port (see colpass.cuh):
//
//   edpp_screen_scores_f32  scores = |C X| + rho ||x_j||, sumsq = ||x_j||^2
//   screen_matvec_f32       dot = C X
//   screen_matvec_bf16      dot = C X^ for a bf16 copy X^ of X: the mixed-
//                           precision screen's wide pass (8 columns a lane,
//                           one 16-byte load; float sums, float C and dot)
//
// Replace the Pallas kernels of src/repro/kernels/edpp_screen.py
// (edpp_screen_scores and screen_matvec). The launch plan (vec, tile,
// split, stage_rows) comes from the caller (launch_plan in
// edpp_screen.py). Each function launches on the given stream, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
#include "colpass.cuh"

extern "C" int edpp_screen_scores_f32(const float* X, const float* C, int n,
                                      int p, int B, int vec, int tile,
                                      int split, int stage_rows,
                                      const float* rho_dev, float rho,
                                      float* scores, float* sumsq,
                                      void* stream) {
  colpass::Epilogue ep{rho_dev, rho, 0.f, 0.f, nullptr, nullptr, scores, sumsq};
  return colpass::launch<colpass::SCORES>(
      X, C, n, p, B, colpass::Plan{vec, tile, split, stage_rows}, ep,
      static_cast<cudaStream_t>(stream));
}

extern "C" int screen_matvec_f32(const float* X, const float* C, int n, int p,
                                 int B, int vec, int tile, int split,
                                 int stage_rows, float* dot, void* stream) {
  colpass::Epilogue ep{nullptr, 0.f, 0.f, 0.f, nullptr, nullptr, dot, nullptr};
  return colpass::launch<colpass::MATVEC>(
      X, C, n, p, B, colpass::Plan{vec, tile, split, stage_rows}, ep,
      static_cast<cudaStream_t>(stream));
}

extern "C" int screen_matvec_bf16(const __nv_bfloat16* X, const float* C,
                                  int n, int p, int B, int vec, int tile,
                                  int split, int stage_rows, float* dot,
                                  void* stream) {
  colpass::Epilogue ep{nullptr, 0.f, 0.f, 0.f, nullptr, nullptr, dot, nullptr};
  return colpass::launch<colpass::MATVEC>(
      X, C, n, p, B, colpass::Plan{vec, tile, split, stage_rows}, ep,
      static_cast<cudaStream_t>(stream));
}
