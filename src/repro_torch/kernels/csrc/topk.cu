// K2 — chunked top-k over a long score vector, one launch per pass.
//
// Replaces: src/repro/kernels/topk.py::_local_topk_kernel (the pallas_call in
// topk, topk.py:70) and, run again over the survivors, the lax.top_k merge
// that follows it (topk.py:82).
//
// Computes, for each (query row, chunk of `chunk` scores): k rounds of
// (max, first index of the max, mask the winner to -inf). A round whose max
// is -inf emits the sentinel id n_live — the pad-lane guard of topk.py:46 —
// never a padded index. Ties go to the lowest index, as first-occurrence
// argmax and lax.top_k give them.
//
// The merge is the same kernel over the (Q, n_chunks*k) survivors with
// `ids_in` set: positions map back to ids. Survivors lie in chunk order and,
// within a chunk, equal values in index order, so the lowest position among
// equal values is the lowest id: the merge keeps lax.top_k's tie order.
//
// Bound on an H100: bytes — every score is read once (4 B) against a few
// compares per element per round; 1,000,000 scores a query is 4 MB, ~1.2 us
// at 3.35 TB/s. This simple version is bound by its k block-wide reductions
// instead: each round is a shared-memory pass plus two barriers.
//
// Design: one block of 512 threads per (chunk, query). The chunk is staged
// into dynamic shared memory once (16,384 f32 = 64 KB by default, which needs
// the opt-in above 48 KB), then each round is a strided scan, a warp-shuffle
// reduction of (value, index) pairs and a cross-warp reduction.
#include <limits.h>
#include <math.h>

#include "common.cuh"

#define TOPK_THREADS 512

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, bv, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
}

// scores: row q starts at scores + q*row_stride and holds n live values.
// ids_in (nullable): row q starts at ids_in + q*row_stride.
// out_vals / out_ids: (Q, n_chunks*k), chunk c of row q at (q*n_chunks + c)*k.
__global__ void topk_rounds_kernel(const float* __restrict__ scores,
                                   const int* __restrict__ ids_in, long long row_stride,
                                   long long n, int chunk, int k, int n_live, int n_chunks,
                                   float* __restrict__ out_vals, int* __restrict__ out_ids) {
  extern __shared__ float s[];
  __shared__ float warp_v[TOPK_THREADS / 32];
  __shared__ int warp_i[TOPK_THREADS / 32];
  const int c = blockIdx.x;
  const long long q = blockIdx.y;
  const long long base = (long long)c * chunk;
  const float* row = scores + q * row_stride;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    const long long g = base + j;
    s[j] = g < n ? row[g] : -INFINITY;
  }
  __syncthreads();
  float* ov = out_vals + (q * n_chunks + c) * k;
  int* oi = out_ids + (q * n_chunks + c) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
      const float v = s[j];
      if (better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      const int n_warps = blockDim.x >> 5;
      bv = lane < n_warps ? warp_v[lane] : -INFINITY;
      bi = lane < n_warps ? warp_i[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        ov[r] = bv;
        if (bv == -INFINITY) {
          oi[r] = n_live;
        } else {
          oi[r] = ids_in ? ids_in[q * row_stride + base + bi] : (int)(base + bi);
        }
        s[bi] = -INFINITY;
      }
    }
    __syncthreads();
  }
}

REPRO_EXPORT int topk_rounds_launch(const void* scores, const void* ids_in,
                                    long long row_stride, long long n, int Q, int chunk,
                                    int k, int n_live, void* out_vals, void* out_ids,
                                    void* stream) {
  const int n_chunks = n > 0 ? (int)((n + chunk - 1) / chunk) : 1;
  if (Q <= 0 || k <= 0) return 0;
  const size_t smem = (size_t)chunk * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_chunks, Q);
  topk_rounds_kernel<<<grid, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int*)ids_in, row_stride, n, chunk, k, n_live, n_chunks,
      (float*)out_vals, (int*)out_ids);
  return (int)cudaGetLastError();
}
