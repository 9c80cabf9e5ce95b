// K1 — block-max pruned BM25 scoring, phase 1 of 2: impacts, theta, keep
// mask and the term-ordered accumulation. The top-k over the accumulator is
// K2's kernel (topk.cu), launched by the same Python wrapper.
//
// Replaces: src/repro/kernels/bm25_pruned.py::_pruned_kernel (the pallas_call
// in bm25_pruned_topk, bm25_pruned.py:172).
//
// Per query (one block each):
//  1. first-block impacts: each term's m = 0 block, T*B postings, impacts as
//     in bm25_block.cu, zero on pad lanes (doc >= n_docs);
//  2. theta = the k-th best per-doc total over those postings, 0 when T*B < k,
//     computed exactly as theta_lower_bound does (bm25_pruned.py:66-88):
//     stable sort by doc id, inclusive cumsum c, p = c - v, start_p = cummax
//     of p at group starts, totals = c - start_p at group ends. The cumsum's
//     rounding decides theta, so it follows one pinned order — rows of 16
//     summed left to right, row totals scanned the same way, then added back
//     (the order XLA's CPU backend uses for cumsum) — which the twin in
//     kernels/ref.py reproduces op for op;
//  3. keep(t, m) = valid(t, m) && (m == 0 || bound(t, m) * safety >= theta),
//     bound(t, m) = ub(t, m) + (sum_t' ub(t', 0) - ub(t, 0)), the sum taken
//     left to right; touched = sum of keep;
//  4. acc[doc] += impact for every kept, live posting, one term at a time in
//     term order with a barrier between terms. A doc occurs at most once per
//     term, so no two threads ever add to one address at once: no atomics,
//     and every doc's sum is ((0 + x_t0) + x_t1) + ..., the order of the
//     reference's flat scatter-add. Pads, invalid, skipped and zero-impact
//     postings are SKIPPED, never added as +0.0: invalid rows alias block 0
//     (bm25.py:94), and a racing load-add-store of +0.0 could undo a real
//     add. Skipping is bitwise the same as adding +0.0 to a non-negative sum.
//
// Bound on an H100: bytes. Per query it must read the T*M*B postings (tf 1 B,
// dl 4 B, doc 4 B: 1.2 MB at T=16, M=64, B=128) and write the accumulator
// that K2 then reads (4 MB each way at 1M docs): ~2.8 us at 3.35 TB/s with
// the zero fill. This first version runs one block per query, so a lone
// query uses one SM: latency of the scattered read-modify-writes and the
// serial theta pass bound it, not bandwidth.
#include <math.h>

#include "common.cuh"

#define PRUNED_THREADS 1024
#define SCAN_ROW 16
#define MAX_SCAN_LEVELS 8

struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a > b ? a : b; }
};

// In-place inclusive scan of x[0..n) in shared memory: rows of SCAN_ROW
// combined left to right, the row totals scanned recursively the same way,
// then each row from the second on combined with the scanned total of the
// rows before it. `scratch` holds the row totals of every level.
template <typename Op>
__device__ void scan_rows(float* x, int n, float* scratch, Op op) {
  float* level[MAX_SCAN_LEVELS + 1];
  int len[MAX_SCAN_LEVELS + 1];
  int top = 0;
  level[0] = x;
  len[0] = n;
  float* next = scratch;
  while (len[top] > SCAN_ROW && top < MAX_SCAN_LEVELS) {
    float* a = level[top];
    const int m = len[top];
    const int rows = (m + SCAN_ROW - 1) / SCAN_ROW;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float acc = a[r * SCAN_ROW];
      for (int j = 1; j < SCAN_ROW; ++j) {
        const int i = r * SCAN_ROW + j;
        if (i < m) {
          acc = op(acc, a[i]);
          a[i] = acc;
        }
      }
      next[r] = acc;
    }
    __syncthreads();
    ++top;
    level[top] = next;
    len[top] = rows;
    next += rows;
  }
  if (threadIdx.x == 0) {
    float* a = level[top];
    for (int j = 1; j < len[top]; ++j) a[j] = op(a[j - 1], a[j]);
  }
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    float* a = level[l];
    const float* s = level[l + 1];
    for (int i = threadIdx.x + SCAN_ROW; i < len[l]; i += blockDim.x)
      a[i] = op(a[i], s[i / SCAN_ROW - 1]);
    __syncthreads();
  }
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ void bitonic_sort(uint64_t* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const uint64_t a = keys[i], b = keys[j];
          if ((a > b) == up) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline int scan_scratch_floats(int n) {
  int total = 0;
  while (n > SCAN_ROW) {
    n = (n + SCAN_ROW - 1) / SCAN_ROW;
    total += n;
  }
  return total;
}

// Inputs are (Q, T, M, B) postings (tf u8, dl f32, docs i32), idf_q (Q, T),
// ub and valid (Q, T, M); acc (Q, n_docs + 1) arrives zeroed.
__global__ void __launch_bounds__(PRUNED_THREADS)
pruned_accumulate_kernel(const uint8_t* __restrict__ tf, const float* __restrict__ dl,
                         const int* __restrict__ docs, const float* __restrict__ idf_q,
                         const float* __restrict__ ub, const uint8_t* __restrict__ valid,
                         float* __restrict__ acc, int* __restrict__ touched, int T, int M,
                         int B, int Lp, int k, int n_docs, float k1, float b, float avgdl,
                         float safety) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = T * B;
  uint64_t* keys = (uint64_t*)smem;            // Lp
  float* vals = (float*)(keys + Lp);           // L: first-block impacts, then cumsum
  float* sv = vals + L;                        // L: impacts in doc order
  float* mx = sv + L;                          // L: start_p
  int* sd = (int*)(mx + L);                    // L: doc ids in sorted order
  float* scratch = (float*)(sd + L);           // scan row totals
  uint8_t* keep = (uint8_t*)(scratch + scan_scratch_floats(L));  // T*M
  __shared__ float theta_s, first_sum_s;
  __shared__ int touched_s;

  const long long q = blockIdx.x;
  const long long R = (long long)T * M * B;
  const uint8_t* tfq = tf + q * R;
  const float* dlq = dl + q * R;
  const int* dq = docs + q * R;
  const float* iq = idf_q + q * T;
  const float* ubq = ub + q * T * M;
  const uint8_t* vq = valid + q * T * M;
  float* accq = acc + q * (long long)(n_docs + 1);
  const float omb = 1.0f - b;
  const int tid = threadIdx.x;

  // 1. first-block impacts, keyed (doc, position) for a stable sort by doc
  for (int i = tid; i < Lp; i += blockDim.x) {
    if (i < L) {
      const int t = i / B;
      const long long p = (long long)t * M * B + (i % B);
      const int d = dq[p];
      const float imp = bm25_impact((float)tfq[p], dlq[p], iq[t], k1, b, omb, avgdl);
      vals[i] = d < n_docs ? imp : 0.0f;
      keys[i] = ((uint64_t)(uint32_t)d << 32) | (uint32_t)i;
    } else {
      keys[i] = ~0ull;
    }
  }
  if (tid == 0) {
    touched_s = 0;
    float s = ubq[0];
    for (int t = 1; t < T; ++t) s = s + ubq[(long long)t * M];
    first_sum_s = s;
    theta_s = 0.0f;
  }
  __syncthreads();

  // 2. theta
  if (L >= k) {
    bitonic_sort(keys, Lp);
    for (int j = tid; j < L; j += blockDim.x) {
      const uint64_t key = keys[j];
      sd[j] = (int)(key >> 32);
      sv[j] = vals[(uint32_t)key];
    }
    __syncthreads();
    for (int j = tid; j < L; j += blockDim.x) vals[j] = sv[j];
    __syncthreads();
    scan_rows(vals, L, scratch, AddOp());            // c
    for (int j = tid; j < L; j += blockDim.x) {
      const bool is_start = j == 0 || sd[j] != sd[j - 1];
      mx[j] = is_start ? vals[j] - sv[j] : -INFINITY;  // p = c - v at starts
    }
    __syncthreads();
    scan_rows(mx, L, scratch, MaxOp());              // start_p
    for (int j = tid; j < L; j += blockDim.x) {
      const bool is_end = j == L - 1 || sd[j] != sd[j + 1];
      const float tot = (is_end && sd[j] < n_docs) ? vals[j] - mx[j] : 0.0f;
      // totals are >= +0: descending order of the float is ascending ~bits
      keys[j] = ((uint64_t)(~__float_as_uint(tot)) << 32) | (uint32_t)j;
    }
    __syncthreads();
    bitonic_sort(keys, Lp);
    if (tid == 0) theta_s = __uint_as_float(~(uint32_t)(keys[k - 1] >> 32));
    __syncthreads();
  }
  const float theta = theta_s;

  // 3. keep mask and touched
  const float first_sum = first_sum_s;
  for (int i = tid; i < T * M; i += blockDim.x) {
    const int t = i / M, m = i % M;
    const float bound = ubq[i] + (first_sum - ubq[(long long)t * M]);
    const bool kp = vq[i] != 0 && (m == 0 || bound * safety >= theta);
    keep[i] = kp;
    if (kp) atomicAdd(&touched_s, 1);
  }
  __syncthreads();
  if (tid == 0) touched[q] = touched_s;

  // 4. term-ordered accumulation of kept, live, non-zero impacts
  const int MB = M * B;
  for (int t = 0; t < T; ++t) {
    const float idf = iq[t];
    for (int i = tid; i < MB; i += blockDim.x) {
      if (!keep[t * M + i / B]) continue;
      const long long p = (long long)t * MB + i;
      const int d = dq[p];
      const uint8_t f = tfq[p];
      if ((unsigned)d >= (unsigned)n_docs || f == 0) continue;
      const float imp = bm25_impact((float)f, dlq[p], idf, k1, b, omb, avgdl);
      if (imp != 0.0f) accq[d] = accq[d] + imp;
    }
    __syncthreads();
  }
}

static int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Shared memory the kernel needs for T*B first-block postings and T*M blocks.
REPRO_EXPORT long long bm25_pruned_smem_bytes(int T, int M, int B) {
  const int L = T * B;
  return (long long)next_pow2(L) * 8 + (long long)L * 16 +
         (long long)scan_scratch_floats(L) * 4 + (long long)T * M;
}

REPRO_EXPORT int bm25_pruned_accumulate_launch(const void* tf, const void* dl,
                                               const void* docs, const void* idf_q,
                                               const void* ub, const void* valid, void* acc,
                                               void* touched, int Q, int T, int M, int B,
                                               int k, int n_docs, float k1, float b,
                                               float avgdl, float safety, void* stream) {
  if (Q <= 0) return 0;
  const size_t smem = (size_t)bm25_pruned_smem_bytes(T, M, B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pruned_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pruned_accumulate_kernel<<<Q, PRUNED_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)tf, (const float*)dl, (const int*)docs, (const float*)idf_q,
      (const float*)ub, (const uint8_t*)valid, (float*)acc, (int*)touched, T, M, B,
      next_pow2(T * B), k, n_docs, k1, b, avgdl, safety);
  return (int)cudaGetLastError();
}
