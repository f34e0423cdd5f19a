// Screening passes over X for the PyTorch port (see colpass.cuh):
//
//   edpp_screen_scores_f32  scores = |C X| + rho ||x_j||, sumsq = ||x_j||^2
//   screen_matvec_f32       dot = C X
//
// Replace the Pallas kernels of src/repro/kernels/edpp_screen.py
// (edpp_screen_scores and screen_matvec). Each function launches on the
// given stream, does not synchronise, and returns the launch's
// cudaError_t (0 on success).
#include "colpass.cuh"

extern "C" int edpp_screen_scores_f32(const float* X, const float* C, int n,
                                      int p, int B, const float* rho_dev,
                                      float rho, float* scores, float* sumsq,
                                      void* stream) {
  colpass::Epilogue ep{rho_dev, rho, 0.f, 0.f, nullptr, nullptr, scores, sumsq};
  return colpass::launch<colpass::SCORES>(X, C, n, p, B, ep,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int screen_matvec_f32(const float* X, const float* C, int n, int p,
                                 int B, float* dot, void* stream) {
  colpass::Epilogue ep{nullptr, 0.f, 0.f, 0.f, nullptr, nullptr, dot, nullptr};
  return colpass::launch<colpass::MATVEC>(X, C, n, p, B, ep,
                                          static_cast<cudaStream_t>(stream));
}
