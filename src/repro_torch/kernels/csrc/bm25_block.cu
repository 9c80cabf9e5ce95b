// K3 — BM25 impacts over gathered postings blocks: one kernel, two entry
// points, both launched from the template below.
//
// Replaces: src/repro/kernels/bm25_block.py::_bm25_kernel (the pallas_call in
// bm25_block_scores, bm25_block.py:61), and, for the main path, the eager
// steps src/repro/search/bm25.py::bm25_impacts runs around it (the doc_len
// gather and the live mask, bm25.py:101-117).
//
// Over rows = Q*T*M rows of B postings, row r's idf at idf[r / M]:
//   bm25_block_scores_launch (the reference's signature, dl given):
//     out = (idf * tf) / fma(k1, (1 - b) + (b * dl) / avgdl, tf)
//   bm25_block_impacts_launch (the main path; dl gathered in the kernel):
//     out = valid[r] && doc < n_docs && tf != 0 ? that impact with
//           dl = doc_len[doc] : +0.0
//
// Bound on an H100: bytes. The reference-shaped call moves 9 B a posting
// (tf 1, dl 4, out 4); the fused one tf 1 and doc 4 of each valid row's
// posting, out 4 of every posting, and each distinct doc_len entry once
// (4 MB at 1M docs: the table stays in the 50 MB L2). ~1 flop a byte, far
// under the card's f32 ridge, so the arithmetic is free. The eager chain the
// fused call replaces (clamp, widening to int64, the gather into a dl
// tensor, the mask and torch.where) moved ~60 B a posting in ~10 launches.
//
// Design: a thread takes 4 consecutive postings of one row: one 4-byte load
// of tf, one 16-byte load of doc ids (or of dl), 4 doc_len reads through
// the read-only path, all in flight before the arithmetic, one 16-byte
// streaming store. One valid byte and one idf a row; a row whose valid byte
// is 0 reads nothing else. Index arithmetic is 32-bit (the wrapper checks that
// the postings fit): two integer divisions per 4 postings. One group a
// thread and as many blocks as groups, so that blocks that finish early
// make room for new ones; blocks shrink to 64 threads so that a single
// query's 32,768 groups still spread over the SMs. (8 or 16 postings a
// thread, and a grid-stride loop over one wave of blocks, were slower on
// the card at the main path's shapes, most where few rows are valid.) A
// group that spans two rows (B no multiple of 4), the tail past the last
// full group, and every posting when a pointer is not 16-byte aligned go
// through the same kernel's scalar path. Arithmetic is bm25_impact
// (common.cuh), built with --fmad=false and IEEE division: the same
// roundings as the twins in kernels/ref.py.
#include "common.cuh"

#define K3_VEC 4                // postings a thread takes at a time
#define K3_MAX_THREADS 256
#define K3_MIN_THREADS 64

struct K3Args {
  const uint8_t* tf;
  const float* dl;              // scores: (n,) f32
  const int* docs;              // impacts: (n,) i32 doc ids
  const uint8_t* valid;         // impacts: (n / B,) bool, one a row
  const float* doc_len;         // impacts: (n_docs + 1,) f32
  const float* idf;             // (n / (M*B),) f32
  float* out;
  unsigned n, B, M;
  int n_docs;
  float k1, b, omb, avgdl;
};

// One posting, the scalar path.
template <bool FUSED>
__device__ __forceinline__ float k3_posting(const K3Args& a, unsigned i) {
  const unsigned row = i / a.B;
  if (FUSED) {
    if (!a.valid[row]) return 0.0f;
    const int d = a.docs[i];
    const uint8_t f = a.tf[i];
    if ((unsigned)d >= (unsigned)a.n_docs || f == 0) return 0.0f;
    return bm25_impact((float)f, __ldg(a.doc_len + d), a.idf[row / a.M], a.k1, a.b, a.omb,
                       a.avgdl);
  }
  return bm25_impact((float)a.tf[i], a.dl[i], a.idf[row / a.M], a.k1, a.b, a.omb, a.avgdl);
}

// Thread v takes group v of K3_VEC postings, for v < n_vec (0 when a pointer
// is not 16-byte aligned), and posting K3_VEC * n_vec + v by the scalar path.
template <bool FUSED>
__global__ void __launch_bounds__(K3_MAX_THREADS)
bm25_block_kernel(const K3Args a, unsigned n_vec) {
  const unsigned v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < n_vec) {
    const unsigned i0 = v * K3_VEC;
    const unsigned row = i0 / a.B;
    float o[K3_VEC];
    if ((i0 + K3_VEC - 1) / a.B != row) {        // spans two rows
#pragma unroll
      for (int j = 0; j < K3_VEC; ++j) o[j] = k3_posting<FUSED>(a, i0 + j);
    } else if (FUSED && !a.valid[row]) {
#pragma unroll
      for (int j = 0; j < K3_VEC; ++j) o[j] = 0.0f;
    } else {
      const float w = a.idf[row / a.M];
      const unsigned t4 = __ldcs(reinterpret_cast<const unsigned*>(a.tf + i0));
      const uint8_t* f = reinterpret_cast<const uint8_t*>(&t4);
      if (FUSED) {
        const int4 d4 = __ldcs(reinterpret_cast<const int4*>(a.docs + i0));
        const int* d = reinterpret_cast<const int*>(&d4);
        bool live[K3_VEC];
        float x[K3_VEC];
#pragma unroll
        for (int j = 0; j < K3_VEC; ++j) {       // every gather in flight first
          live[j] = (unsigned)d[j] < (unsigned)a.n_docs && f[j] != 0;
          x[j] = live[j] ? __ldg(a.doc_len + d[j]) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < K3_VEC; ++j)
          o[j] = live[j] ? bm25_impact((float)f[j], x[j], w, a.k1, a.b, a.omb, a.avgdl) : 0.0f;
      } else {
        const float4 l4 = __ldcs(reinterpret_cast<const float4*>(a.dl + i0));
        const float* x = reinterpret_cast<const float*>(&l4);
#pragma unroll
        for (int j = 0; j < K3_VEC; ++j)
          o[j] = bm25_impact((float)f[j], x[j], w, a.k1, a.b, a.omb, a.avgdl);
      }
    }
    __stcs(reinterpret_cast<float4*>(a.out + i0), make_float4(o[0], o[1], o[2], o[3]));
  }
  const unsigned i = n_vec * K3_VEC + v;         // < 2^31 + 2^31: no wrap
  if (i < a.n) a.out[i] = k3_posting<FUSED>(a, i);
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool FUSED>
static int k3_launch(const K3Args& a, bool vec, void* stream) {
  if (a.n == 0) return 0;
  if (a.B == 0 || a.M == 0 || a.n > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned n_vec = vec ? a.n / K3_VEC : 0;
  const unsigned tail = a.n - n_vec * K3_VEC;    // the scalar path's postings
  const unsigned work = n_vec > tail ? n_vec : tail;
  unsigned threads = K3_MAX_THREADS;
  while (threads > K3_MIN_THREADS && (work + threads - 1) / threads < (unsigned)sms) threads /= 2;
  const unsigned blocks = (work + threads - 1) / threads;
  bm25_block_kernel<FUSED><<<blocks, threads, 0, (cudaStream_t)stream>>>(a, n_vec);
  return (int)cudaGetLastError();
}

// tf (n,) u8, dl (n,) f32, idf (n / (M*B),) f32, out (n,) f32 — n = Q*T*M*B.
REPRO_EXPORT int bm25_block_scores_launch(const void* tf, const void* dl, const void* idf,
                                          void* out, long long n, int B, int M, float k1,
                                          float b, float avgdl, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || B <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  K3Args a{(const uint8_t*)tf, (const float*)dl, nullptr, nullptr, nullptr,
           (const float*)idf, (float*)out, (unsigned)n, (unsigned)B, (unsigned)M, 0,
           k1, b, 1.0f - b, avgdl};
  return k3_launch<false>(a, aligned16(tf) && aligned16(dl) && aligned16(out), stream);
}

// tf (n,) u8, docs (n,) i32, valid (n / B,) bool, doc_len (n_docs + 1,) f32,
// idf (n / (M*B),) f32, out (n,) f32.
REPRO_EXPORT int bm25_block_impacts_launch(const void* tf, const void* docs, const void* valid,
                                           const void* doc_len, const void* idf, void* out,
                                           long long n, int B, int M, int n_docs, float k1,
                                           float b, float avgdl, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || B <= 0 || M <= 0 || n_docs < 0)
    return (int)cudaErrorInvalidValue;
  K3Args a{(const uint8_t*)tf, nullptr, (const int*)docs, (const uint8_t*)valid,
           (const float*)doc_len, (const float*)idf, (float*)out, (unsigned)n, (unsigned)B,
           (unsigned)M, n_docs, k1, b, 1.0f - b, avgdl};
  return k3_launch<true>(a, aligned16(tf) && aligned16(docs) && aligned16(out), stream);
}
