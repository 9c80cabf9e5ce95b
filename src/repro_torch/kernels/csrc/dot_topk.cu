// K4 — dense-tier scoring fused with each chunk's top-k, one launch for a
// whole micro-batch of queries.
//
// Replaces: src/repro/kernels/dot_topk.py::_dot_topk_kernel (the pallas_call
// in dot_topk, dot_topk.py:69), which dot_topk_batch (dot_topk.py:90)
// dispatches once per query. The merge that follows it there (lax.top_k,
// dot_topk.py:86) is K2's kernel over this kernel's survivors (topk.cu).
//
// Computes, for every (query q, row r < N):
//
//     s[q, r] = (((0 + c[r,0]*q[0]) + c[r,1]*q[1]) + ...) + c[r,D-1]*q[D-1]
//
// in float32, each product and each sum rounded once (--fmad=false, and the
// intrinsics below say so again). The order depends on D alone: a query's
// bits do not depend on its batch neighbours, on Q, on N or on where the
// row lies — the plain twin (ref.py::dot_scores_f32) writes the same order.
// No TF32 and no tensor cores: both would reorder the sum.
//
// Then, per 1024-row chunk and query: rows >= N are -inf, and k rounds of
// (max, first index of the max, mask the winner to -inf) emit the chunk's
// top k, descending, equal values in row order. A round whose max is -inf
// emits the sentinel id N.
//
// Bound on an H100: at Q=1 bytes — every row is read once, N*D*4 bytes
// (250,000 x 768 rows: 768 MB, 0.23 ms at 3.35 TB/s); at Q=64 operations —
// 2*Q*N*D float32 operations on the CUDA cores (24.6 GFLOP, 0.37 ms at
// 67 TFLOP/s; without FMA a product and a sum are two instructions).
//
// Design: one block of 256 threads per (group of QG queries, chunk of 1024
// rows); blockIdx.x is the query group, so the groups of one chunk run side
// by side and read its rows from device memory once between them. Each
// thread owns 4 rows and all QG queries of its group (4*QG accumulators in
// registers). The rows are staged through shared memory 8 columns at a time
// (coalesced 32-byte row segments; padded pitch, so the 32 lanes reading
// consecutive rows hit 32 banks), the group's queries beside them. The
// chunk's QG x 1024 scores then stay in shared memory, and each warp takes
// whole queries for the k selection rounds (warp shuffles, no block
// barrier). QG is Q rounded up to a power of two, at most 16, so a lone
// query does not pay for fifteen empty ones.
#include <limits.h>
#include <math.h>

#include "common.cuh"

#define DOT_THREADS 256
#define DOT_CHUNK 1024                      // rows per block
#define DOT_ROWS (DOT_CHUNK / DOT_THREADS)  // rows per thread
#define DOT_TD 8                            // columns per staged tile
#define DOT_PITCH (DOT_TD + 1)

__device__ __forceinline__ bool dot_better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int QG>
__global__ void __launch_bounds__(DOT_THREADS, 2)
    dot_topk_chunks_kernel(const float* __restrict__ queries, const float* __restrict__ cands,
                           int Q, long long N, int D, int k, int n_chunks,
                           float* __restrict__ out_vals, int* __restrict__ out_ids) {
  extern __shared__ float smem[];
  float* scores = smem;                           // [QG][DOT_CHUNK]
  float* cs = scores + QG * DOT_CHUNK;            // [DOT_CHUNK][DOT_PITCH]
  float* qs = cs + DOT_CHUNK * DOT_PITCH;         // [DOT_TD][QG]
  const int q0 = blockIdx.x * QG;
  const int c = blockIdx.y;
  const long long base = (long long)c * DOT_CHUNK;
  const int tid = threadIdx.x;

  float acc[DOT_ROWS][QG];
#pragma unroll
  for (int i = 0; i < DOT_ROWS; ++i)
#pragma unroll
    for (int q = 0; q < QG; ++q) acc[i][q] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DOT_TD) {
    const int td = min(DOT_TD, D - d0);
#pragma unroll 8
    for (int e = tid; e < DOT_CHUNK * DOT_TD; e += DOT_THREADS) {
      const int r = e / DOT_TD, j = e % DOT_TD;
      const long long row = base + r;
      cs[r * DOT_PITCH + j] = (row < N && j < td) ? cands[row * D + d0 + j] : 0.0f;
    }
    for (int e = tid; e < DOT_TD * QG; e += DOT_THREADS) {
      const int j = e / QG, q = e % QG;
      qs[e] = (q0 + q < Q && j < td) ? queries[(long long)(q0 + q) * D + d0 + j] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < td; ++j) {   // only real columns: no +0 terms, no sign flips
      float cv[DOT_ROWS];
#pragma unroll
      for (int i = 0; i < DOT_ROWS; ++i) cv[i] = cs[(tid + i * DOT_THREADS) * DOT_PITCH + j];
#pragma unroll
      for (int q = 0; q < QG; ++q) {
        const float qv = qs[j * QG + q];
#pragma unroll
        for (int i = 0; i < DOT_ROWS; ++i) acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(cv[i], qv));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < DOT_ROWS; ++i) {
    const int r = tid + i * DOT_THREADS;
    const bool live = base + r < N;
#pragma unroll
    for (int q = 0; q < QG; ++q) scores[q * DOT_CHUNK + r] = live ? acc[i][q] : -INFINITY;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int qq = warp; qq < QG && q0 + qq < Q; qq += DOT_THREADS / 32) {
    float* s = scores + qq * DOT_CHUNK;
    const long long slot = ((long long)(q0 + qq) * n_chunks + c) * k;
    for (int r = 0; r < k; ++r) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int j = lane; j < DOT_CHUNK; j += 32) {
        const float v = s[j];
        if (dot_better(v, j, bv, bi)) {
          bv = v;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, bv, off);
        const int i = __shfl_xor_sync(0xffffffffu, bi, off);
        if (dot_better(v, i, bv, bi)) {
          bv = v;
          bi = i;
        }
      }
      if (lane == 0) {
        out_vals[slot + r] = bv;
        if (bv == -INFINITY) {
          out_ids[slot + r] = (int)N;
        } else {
          out_ids[slot + r] = (int)(base + bi);
          s[bi] = -INFINITY;
        }
      }
      __syncwarp();
    }
  }
}

template <int QG>
static int launch(const float* queries, const float* cands, int Q, long long N, int D, int k,
                  float* out_vals, int* out_ids, cudaStream_t stream) {
  const int n_chunks = N > 0 ? (int)((N + DOT_CHUNK - 1) / DOT_CHUNK) : 1;
  const size_t smem = (size_t)(QG * DOT_CHUNK + DOT_CHUNK * DOT_PITCH + DOT_TD * QG) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot_topk_chunks_kernel<QG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Q + QG - 1) / QG, n_chunks);
  dot_topk_chunks_kernel<QG><<<grid, DOT_THREADS, smem, stream>>>(
      queries, cands, Q, N, D, k, n_chunks, out_vals, out_ids);
  return (int)cudaGetLastError();
}

// queries (Q, D) and cands (N, D) contiguous float32; out_vals / out_ids
// (Q, n_chunks * k), chunk c of query q at (q * n_chunks + c) * k.
// qg: queries per block, one of 1, 2, 4, 8, 16. k <= DOT_CHUNK.
REPRO_EXPORT int dot_topk_chunks_launch(const void* queries, const void* cands, int Q,
                                        long long N, int D, int k, int qg, void* out_vals,
                                        void* out_ids, void* stream) {
  if (Q <= 0 || k <= 0) return 0;
  const float* qp = (const float*)queries;
  const float* cp = (const float*)cands;
  float* ov = (float*)out_vals;
  int* oi = (int*)out_ids;
  cudaStream_t st = (cudaStream_t)stream;
  switch (qg) {
    case 1: return launch<1>(qp, cp, Q, N, D, k, ov, oi, st);
    case 2: return launch<2>(qp, cp, Q, N, D, k, ov, oi, st);
    case 4: return launch<4>(qp, cp, Q, N, D, k, ov, oi, st);
    case 8: return launch<8>(qp, cp, Q, N, D, k, ov, oi, st);
    case 16: return launch<16>(qp, cp, Q, N, D, k, ov, oi, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
