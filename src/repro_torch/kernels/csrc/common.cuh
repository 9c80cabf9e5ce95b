// Shared by the BM25 kernels: the C export macro, the error string entry
// point every library carries, and the BM25 impact in the reference's
// association (src/repro/search/bm25.py:114-115, kernels/bm25_block.py:34-36):
//
//     impact = (idf * tf) / fma(k1, (1 - b) + (b * dl) / avgdl, tf)
//
// Built with --fmad=false and IEEE division, every step rounds once — the
// same roundings the eager PyTorch twin makes, one op at a time. The one
// fused multiply-add is explicit: the reference's XLA CPU build contracts
// tf + k1 * norm into an FMA, and the twin emulates it exactly (ref.fma_f32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// omb = 1 - b, computed once by the caller in float32.
__device__ __forceinline__ float bm25_impact(float tf, float dl, float idf, float k1,
                                             float b, float omb, float avgdl) {
  const float norm = omb + (b * dl) / avgdl;
  return (idf * tf) / fmaf(k1, norm, tf);
}
