// K4 — dense-tier scoring fused with each tile's top-k, one launch for a
// whole micro-batch of queries.
//
// Replaces: src/repro/kernels/dot_topk.py::_dot_topk_kernel (the pallas_call
// in dot_topk, dot_topk.py:69), which dot_topk_batch (dot_topk.py:90)
// dispatches once per query. The merge that follows it there (lax.top_k,
// dot_topk.py:86) is K2's kernel over this kernel's survivors (topk.cu).
//
// Computes, for every (query q, row r < N):
//
//     s[q, r] = fma(c[r,D-1], q[D-1], ... fma(c[r,1], q[1], fma(c[r,0], q[0], +0)))
//
// in float32, one fused multiply-add a column in d order, one rounding each.
// The order depends on D alone: a query's bits do not depend on its batch
// neighbours, on Q, on N or on where the row lies — the plain twin
// (ref.py::dot_scores_f32) writes the same chain with an exact emulation of
// the FMA (ref.fma_f32). No split-K, no TF32 and no tensor cores: each would
// reorder the sum.
//
// Then, per 128-row tile and query: rows >= N are -inf, and select.cuh's
// select (the one K2 runs) emits the tile's top min(k, 128) under (value
// desc, row asc), a -inf value with the sentinel id N. The answer does not
// depend on the tile: the top-k set under that order is the same for any
// cut of the rows, so the tile need not be the reference's 1,024.
//
// Bound on an H100: at Q=1 bytes — every row is read once, N*D*4 bytes
// (250,000 x 768 rows: 768 MB, 0.23 ms at 3.35 TB/s); at Q=64 operations —
// 2*Q*N*D float32 operations (24.6 GFLOP, 0.37 ms at 67 TFLOP/s, an FMA
// counted as two). The earlier version summed a rounded product and a
// rounded add per column, two instructions where an FMA is one, which put
// its arithmetic alone at 0.73 ms.
//
// Design: a SIMT SGEMM. One block per (128-row tile, tile of BQ queries) on
// one flat grid.x, the query tiles of a row tile side by side so that they
// read its rows from device memory once between them. BQ is Q rounded up to
// a power of two, at most 64, so a lone query does not pay for 63 empty
// ones. Each thread owns TM rows x TN queries of accumulators — 4 x 8 at BQ
// 64 in 256 threads, 1 x BQ in 128 threads at BQ <= 8 — in at most 128
// registers, so that two blocks share an SM and one's select runs beside the
// other's sums. The lanes of a warp take consecutive rows and one group of
// queries: a 16-byte read of a query's columns is a broadcast, and the rows'
// reads hit distinct banks at a 36-float pitch. The rows and the queries
// come in 32 columns at a time through a three-stage ring of shared memory
// filled by cp.async (16-byte copies when D is a multiple of 4 and the rows
// are aligned, 4-byte otherwise), two slabs' copies in flight while one is
// summed; each thread's copy sources are worked out once, not every slab.
// Then the tile's BQ x 128 scores go to shared memory (over the ring) and
// each warp takes whole queries for the select (for k <= 32 its one-warp
// path: a floor from the lanes' maxima, the few candidates ranked by
// shuffles). On an H100 the variants tried at Q 64 (256-row tiles, 4 x 16
// or 8 x 8 a thread, two stages, 512 threads) took 0.77-0.85 ms.
#include <math.h>

#include "common.cuh"
#include "select.cuh"

namespace {

constexpr int TILE = 128;        // rows a block
constexpr int BK = 32;           // columns a slab
constexpr int PITCH = BK + 4;    // floats a staged row: 16-byte aligned, conflict-free
constexpr int STAGES = 3;

// The lanes of a warp take consecutive rows and one group of TN queries: a
// 16-byte read of a query's columns is a broadcast, and the rows' reads hit
// distinct banks at the 36-float pitch.
template <int BQ>
struct Cfg {
  static constexpr int NT = BQ >= 16 ? 256 : 128;  // threads
  static constexpr int WARPS = NT / 32;
  static constexpr int TN = BQ < 8 ? BQ : 8;       // queries a thread
  static constexpr int QG = BQ / TN;               // query groups
  static constexpr int RG = NT / QG;               // threads of a query group (>= 32)
  static constexpr int TM = TILE / RG;             // rows a thread, RG apart
  static constexpr int STAGE = (TILE + BQ) * PITCH;   // floats a stage
  static constexpr size_t RING = (size_t)STAGES * STAGE * sizeof(float);
  static constexpr size_t SCORES = (size_t)BQ * TILE * sizeof(float);
};

constexpr size_t WARP_SCRATCH = sizeof(SelectScratch<32>) + TILE * sizeof(uint2);

template <int BQ>
size_t smem_bytes() {
  const size_t select = Cfg<BQ>::SCORES + Cfg<BQ>::WARPS * WARP_SCRATCH;
  return Cfg<BQ>::RING > select ? Cfg<BQ>::RING : select;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// src_bytes 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's share of a slab's copies: with 16-byte copies (D % 4 == 0)
// it copies columns ct..ct+3 of rows rt, rt + RS, ... of the tile and of
// the query group, the same rows every slab, so their sources are worked
// out once; rows >= N and queries >= Q are filled with zeros.
template <int BQ>
struct SlabCopies {
  static constexpr int RS = Cfg<BQ>::NT / (BK / 4);   // rows one round of the block's copies covers
  static constexpr int UC = TILE / RS;                // rounds over the tile's rows
  static constexpr int UQ = (BQ + RS - 1) / RS;       // rounds over the queries
  const float* c_src;   // the tile's row r0 + rt, column ct
  const float* q_src;   // the group's query q0 + rt, column ct
  long long c_step;     // RS rows of cands, in floats
  unsigned c_ok, q_ok;  // bit u: row rt + u * RS is live
  int rt, ct;

  __device__ SlabCopies(const float* queries, const float* cands, int Q, long long N, int D,
                        long long r0, int q0) {
    const int t = threadIdx.x;
    rt = t / (BK / 4);
    ct = t % (BK / 4) * 4;
    c_src = cands + (r0 + rt) * D + ct;
    q_src = queries + (long long)(q0 + rt) * D + ct;
    c_step = (long long)RS * D;
    c_ok = q_ok = 0;
#pragma unroll
    for (int u = 0; u < UC; ++u) c_ok |= (unsigned)(r0 + rt + u * RS < N) << u;
#pragma unroll
    for (int u = 0; u < UQ; ++u) q_ok |= (unsigned)(q0 + rt + u * RS < Q) << u;
  }
};

// Stage columns [d0, d0 + td) of the tile's rows and of the group's queries;
// rows >= N and queries >= Q are zeros. Columns >= td are left as they are:
// the sums never read them.
template <int BQ>
__device__ __forceinline__ void load_slab(float* cs, const SlabCopies<BQ>& sp,
                                          const float* __restrict__ queries,
                                          const float* __restrict__ cands, int Q, long long N,
                                          int D, long long r0, int q0, int d0, int td,
                                          bool vec) {
  using SP = SlabCopies<BQ>;
  constexpr int NT = Cfg<BQ>::NT;
  float* qs = cs + TILE * PITCH;
  const int t = threadIdx.x;
  if (vec) {
    if (sp.ct < td) {
#pragma unroll
      for (int u = 0; u < SP::UC; ++u) {
        const bool ok = (sp.c_ok >> u) & 1;
        cp_async16(cs + (sp.rt + u * SP::RS) * PITCH + sp.ct,
                   ok ? sp.c_src + u * sp.c_step + d0 : cands, ok ? 16 : 0);
      }
#pragma unroll
      for (int u = 0; u < SP::UQ; ++u) {
        if (sp.rt + u * SP::RS < BQ) {
          const bool ok = (sp.q_ok >> u) & 1;
          cp_async16(qs + (sp.rt + u * SP::RS) * PITCH + sp.ct,
                     ok ? sp.q_src + u * sp.c_step + d0 : queries, ok ? 16 : 0);
        }
      }
    }
  } else {
    for (int e = t; e < TILE * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      if (c < td) {
        const bool ok = r0 + r < N;
        cp_async4(cs + r * PITCH + c, cands + (ok ? r0 + r : 0) * D + d0 + c, ok ? 4 : 0);
      }
    }
    for (int e = t; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      if (c < td) {
        const bool ok = q0 + r < Q;
        cp_async4(qs + r * PITCH + c, queries + (long long)(ok ? q0 + r : 0) * D + d0 + c,
                  ok ? 4 : 0);
      }
    }
  }
}

// Four columns kk..kk+3 into the thread's accumulators, in d order: its
// rows' 16 bytes held, each query's 16 bytes (a broadcast) read in turn.
template <int BQ>
__device__ __forceinline__ void fma4(float (&acc)[Cfg<BQ>::TM][Cfg<BQ>::TN], const float* qs,
                                     const float* cr, int kk) {
  using C = Cfg<BQ>;
  float4 cv[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
    cv[i] = *reinterpret_cast<const float4*>(cr + i * C::RG * PITCH + kk);
#pragma unroll
  for (int j = 0; j < C::TN; ++j) {
    const float4 qv = *reinterpret_cast<const float4*>(qs + j * PITCH + kk);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      float a = acc[i][j];
      a = fmaf(cv[i].x, qv.x, a);
      a = fmaf(cv[i].y, qv.y, a);
      a = fmaf(cv[i].z, qv.z, a);
      a = fmaf(cv[i].w, qv.w, a);
      acc[i][j] = a;
    }
  }
}

template <int BQ>
__global__ void __launch_bounds__(Cfg<BQ>::NT, 2)
    dot_topk_tiles_kernel(const float* __restrict__ queries, const float* __restrict__ cands,
                          int Q, long long N, int D, int k_t, int n_tiles, int n_qtiles,
                          int vec, float* __restrict__ out_vals, int* __restrict__ out_ids) {
  using C = Cfg<BQ>;
  extern __shared__ __align__(16) float smem[];
  const long long tile = blockIdx.x / n_qtiles;
  const int qt = (int)(blockIdx.x - tile * n_qtiles);
  const long long r0 = tile * TILE;
  const int q0 = qt * BQ;
  const int t = threadIdx.x;
  const int rg = t % C::RG, qg = t / C::RG;   // the thread's first row, its query group

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.0f;

  const int n_slabs = (D + BK - 1) / BK;
  const SlabCopies<BQ> sp(queries, cands, Q, N, D, r0, q0);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_slabs)
      load_slab<BQ>(smem + st * C::STAGE, sp, queries, cands, Q, N, D, r0, q0, st * BK,
                    min(BK, D - st * BK), vec);
    cp_async_commit();
  }
  for (int slab = 0; slab < n_slabs; ++slab) {
    cp_async_wait<STAGES - 2>();         // this slab has landed
    __syncthreads();                     // and every thread is done with the stage refilled next
    const int nx = slab + STAGES - 1;
    if (nx < n_slabs)
      load_slab<BQ>(smem + (nx % STAGES) * C::STAGE, sp, queries, cands, Q, N, D, r0, q0,
                    nx * BK, min(BK, D - nx * BK), vec);
    cp_async_commit();
    const float* cs = smem + (slab % STAGES) * C::STAGE;
    const float* qs = cs + TILE * PITCH + qg * C::TN * PITCH;
    const float* cr = cs + rg * PITCH;
    const int td = min(BK, D - slab * BK);
    if (vec) {
      if (td == BK) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) fma4<BQ>(acc, qs, cr, kk);
      } else {
        for (int kk = 0; kk < td; kk += 4) fma4<BQ>(acc, qs, cr, kk);   // td % 4 == 0
      }
    } else {
      for (int kk = 0; kk < td; ++kk) {   // only real columns: no +0 terms, no sign flips
        float qv[C::TN];
#pragma unroll
        for (int j = 0; j < C::TN; ++j) qv[j] = qs[j * PITCH + kk];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          const float cv = cr[i * C::RG * PITCH + kk];
#pragma unroll
          for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(cv, qv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring becomes the scores

  float* S = smem;                       // [BQ][TILE]
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = rg + i * C::RG;
    const bool live = r0 + r < N;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) S[(qg * C::TN + j) * TILE + r] = live ? acc[i][j] : -INFINITY;
  }
  __syncthreads();

  const int warp = t >> 5, lane = t & 31;
  char* scratch = reinterpret_cast<char*>(S + BQ * TILE) + warp * WARP_SCRATCH;
  auto* sc = reinterpret_cast<SelectScratch<32>*>(scratch);
  uint2* surv = reinterpret_cast<uint2*>(sc + 1);
  for (int qq = warp; qq < BQ && q0 + qq < Q; qq += C::WARPS) {
    const float* s = S + qq * TILE;
    const long long slot = ((long long)(q0 + qq) * n_tiles + tile) * k_t;
    auto key_at = [&](int j) { return order_key(s[j]); };
    select_topk<32>(key_at, TILE, k_t, 0u, lane, sc, surv, [&](int r, int p) {
      const float v = s[p];
      out_vals[slot + r] = v;
      out_ids[slot + r] = v == -INFINITY ? (int)N : (int)(r0 + p);
    });
  }
}

template <int BQ>
int launch(const float* queries, const float* cands, int Q, long long N, int D, int k_t,
           int vec, float* out_vals, int* out_ids, cudaStream_t stream) {
  const long long n_tiles = N > 0 ? (N + TILE - 1) / TILE : 1;
  const int n_qtiles = (Q + BQ - 1) / BQ;
  const size_t smem = smem_bytes<BQ>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot_topk_tiles_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = n_tiles * n_qtiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dot_topk_tiles_kernel<BQ><<<(unsigned)blocks, Cfg<BQ>::NT, smem, stream>>>(
      queries, cands, Q, N, D, k_t, (int)n_tiles, n_qtiles, vec, out_vals, out_ids);
  return (int)cudaGetLastError();
}

}  // namespace

// queries (Q, D) and cands (N, D) contiguous float32; out_vals / out_ids
// (Q, n_tiles * k_t) with n_tiles = ceil(N / 128) (1 when N = 0), tile t of
// query q at (q * n_tiles + t) * k_t. bq: queries per block, a power of two
// from 1 to 64. k_t <= 128. vec: D % 4 == 0 and both bases 16-byte aligned.
REPRO_EXPORT int dot_topk_tiles_launch(const void* queries, const void* cands, int Q,
                                       long long N, int D, int k_t, int bq, int vec,
                                       void* out_vals, void* out_ids, void* stream) {
  if (Q <= 0 || k_t <= 0) return 0;
  if (k_t > TILE || D < 0) return (int)cudaErrorInvalidValue;
  const float* qp = (const float*)queries;
  const float* cp = (const float*)cands;
  float* ov = (float*)out_vals;
  int* oi = (int*)out_ids;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bq) {
    case 1: return launch<1>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    case 2: return launch<2>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    case 4: return launch<4>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    case 8: return launch<8>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    case 16: return launch<16>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    case 32: return launch<32>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    case 64: return launch<64>(qp, cp, Q, N, D, k_t, vec, ov, oi, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
