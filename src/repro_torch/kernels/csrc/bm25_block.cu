// K3 — BM25 impacts over gathered postings blocks.
//
// Replaces: src/repro/kernels/bm25_block.py::_bm25_kernel (the pallas_call in
// bm25_block_scores, bm25_block.py:61).
//
// Computes, elementwise over (rows, B) with rows = Q*T*M:
//     out = (idf[row / M] * tf) / (tf + k1 * ((1 - b) + (b * dl) / avgdl))
//
// Bound on an H100: bytes. Each posting reads 1 B of tf and 4 B of dl and
// writes 4 B of impact — 9 B for 6 flops, far under the card's f32 ridge
// (~20 flop/B against HBM) — so the least time is 9 B * n / 3.35 TB/s. At the
// main path's shapes (T=16, M=64, B=128: 131,072 postings a query) that is
// ~0.35 us a query, and one launch (~2-3 us) dominates until Q is large.
//
// Design: one thread per posting in a grid-stride loop; consecutive threads
// touch consecutive postings, so tf, dl and out are coalesced; idf is one
// float per row of B lanes and stays in L1. The TPU kernel tiled 8 rows of
// 128 lanes per grid step into VMEM; here there is nothing to stage.
#include "common.cuh"

__global__ void bm25_block_kernel(const uint8_t* __restrict__ tf,
                                  const float* __restrict__ dl,
                                  const float* __restrict__ idf,
                                  float* __restrict__ out, long long n, int B, int M,
                                  float k1, float b, float avgdl) {
  const float omb = 1.0f - b;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long row = i / B;
    out[i] = bm25_impact((float)tf[i], dl[i], idf[row / M], k1, b, omb, avgdl);
  }
}

// tf (n,) u8, dl (n,) f32, idf (n / (M*B),) f32, out (n,) f32 — n = Q*T*M*B.
REPRO_EXPORT int bm25_block_scores_launch(const void* tf, const void* dl, const void* idf,
                                          void* out, long long n, int B, int M, float k1,
                                          float b, float avgdl, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  bm25_block_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tf, (const float*)dl, (const float*)idf, (float*)out, n, B, M, k1, b,
      avgdl);
  return (int)cudaGetLastError();
}
