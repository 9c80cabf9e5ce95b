// K5 — FlashAttention forward on f32: causal / GQA / sliding window / kv_len.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call in flash_attention, flash_attention.py:128), for f32 inputs;
// bf16 inputs take csrc/flash_attention_bf16.cu (tensor cores, split-KV).
//
// Computes, per (batch, kv head) and per query row r of the G = Hq / Hkv
// query heads folded into rows (r = g * Sq + s):
//     qpos  = r % Sq + (Skv - Sq)                (queries end the kv axis)
//     s_j   = (q_r . k_j) * scale,  -inf where masked:
//             causal: j <= qpos; window W: j > qpos - W; kv_len: j < kv_len
//     out_r = sum_j softmax(s)_j v_j, and 0 for a row with no visible key,
// with the online softmax over kv tiles of 64 keys: an f32 running max m,
// denominator l and accumulator acc per row, exactly the reference's update
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); a = exp(m - m') (0 if m = -inf)
//     l' = a * l + sum_j p_j;  acc' = acc * a + sum_j p_j v_j.
// With an lse buffer, each row's log-sum-exp m + log(l) (natural log; -inf
// for a row that sees no key: m = -inf, log 0 = -inf) is written beside it.
//
// Order. Every sum runs in one fixed order with one rounding per step
// (__fmul_rn / __fadd_rn, no contraction): a score sums q_d * k_d over d
// from 0 to D - 1 from +0; sum_j p_j and sum_j p_j v_j run over the tile's
// keys in order from +0. The plain twin (ref.flash_attention_ref) takes the
// same steps one eager op at a time, so on the card the two agree to the bit.
// Tiles that are wholly masked for every row of a block are skipped: such a
// tile leaves m, l and acc unchanged bit for bit (a = exp(0) = 1, p = 0).
//
// Bound on an H100: operations at long sequences (4 * D flops per visible
// pair against 67 TFLOP/s f32 on the CUDA cores), bytes at decode. Products
// and sums run on the CUDA cores in f32, unfused to keep the twin's bits.
//
// Design: one block of 256 threads per (batch * kv head, tile of BQ rows),
// on one flat grid.x (bh * row tiles + tile: no 65,535 limit on bh).
// The Q tile (f32), then each K and V tile of 64 keys, are staged in shared
// memory; a thread holds an RM x CN patch of the BQ x 64 scores in registers
// and, for the p . V product, up to DVMAX / (256 / BQ) output columns of one
// row. BQ is 64 for prefill and 4 or 16 for decode, where the rows are only
// the G folded heads. The TPU kernel walked a sequential kv grid axis with
// m, l, acc in VMEM scratch; here the kv loop runs inside the block.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;

template <int BQ, int RM, int DVMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int n_tiles, int rows, int q_seq, int kv_seq, int D, int Dv, int causal,
                 int window, int kv_len, float scale) {
  constexpr int TR = BQ / RM;         // thread rows of the score patch grid
  constexpr int TC = THREADS / TR;    // thread columns
  constexpr int CN = BK / TC;         // score columns a thread holds
  constexpr int TPR = THREADS / BQ;   // threads sharing one row in p . V
  constexpr int NV = DVMAX / TPR;     // output columns a thread holds
  static_assert(TR * RM == BQ && TC * CN == BK && TPR * BQ == THREADS, "tile shape");

  extern __shared__ float smem[];
  const int DP = D + 1;                     // odd row pitch: no bank conflicts
  float* qs = smem;                         // BQ x DP
  float* ks = qs + BQ * DP;                 // BK x DP
  float* vs = ks + BK * DP;                 // BK x Dv
  float* ps = vs + BK * Dv;                 // BQ x (BK + 1): scores, then p
  float* m_s = ps + BQ * (BK + 1);          // BQ running max
  float* l_s = m_s + BQ;                    // BQ running denominator
  float* a_s = l_s + BQ;                    // BQ this tile's rescale
  float* ms_s = a_s + BQ;                   // BQ this tile's m' (0 if -inf)

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x / n_tiles;
  const int r0 = (int)(blockIdx.x - bh * n_tiles) * BQ;
  const int n_rows = min(BQ, rows - r0);
  const int off = kv_seq - q_seq;
  const float* qb = q + (bh * rows + r0) * (long long)D;
  const float* kb = k + bh * kv_seq * (long long)D;
  const float* vb = v + bh * kv_seq * (long long)Dv;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qs[r * DP + d] = r < n_rows ? qb[(long long)r * D + d] : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  // The keys any row of this block may see: [k_lo, k_hi).
  const int r_last = r0 + n_rows - 1;
  int q_lo = off, q_hi = q_seq - 1 + off;
  if (r0 / q_seq == r_last / q_seq) {
    q_lo = r0 % q_seq + off;
    q_hi = r_last % q_seq + off;
  }
  int k_hi = min(kv_len, kv_seq);
  if (causal) k_hi = min(k_hi, q_hi + 1);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;

  const int tr = tid / TC, tc = tid - (tid / TC) * TC;   // score patch
  const int pr = tid / TPR, pl = tid - (tid / TPR) * TPR;  // p . V row and lane
  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.0f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done with ks, vs, ps
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      ks[j * DP + d] = k0 + j < kv_seq ? kb[(long long)(k0 + j) * D + d] : 0.0f;
    }
    for (int i = tid; i < BK * Dv; i += THREADS) {
      const int j = i / Dv;
      vs[i] = k0 + j < kv_seq ? vb[(long long)k0 * Dv + i] : 0.0f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < CN; ++b) s[a][b] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int a = 0; a < RM; ++a) qv[a] = qs[(tr + TR * a) * DP + d];
#pragma unroll
      for (int b = 0; b < CN; ++b) kv[b] = ks[(tc + TC * b) * DP + d];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < CN; ++b) s[a][b] = __fadd_rn(s[a][b], __fmul_rn(qv[a], kv[b]));
    }
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int r = tr + TR * a;
      const int qpos = (r0 + r) % q_seq + off;
#pragma unroll
      for (int b = 0; b < CN; ++b) {
        const int c = tc + TC * b, kpos = k0 + c;
        bool ok = r < n_rows && kpos < kv_seq && kpos < kv_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[a][b] = ok ? __fmul_rn(s[a][b], scale) : -INFINITY;
        ps[r * (BK + 1) + c] = s[a][b];
      }
    }
    __syncthreads();

    if (tid < BQ) {                       // row max, the new m and the rescale
      float m_cur = -INFINITY;
      for (int j = 0; j < BK; ++j) m_cur = fmaxf(m_cur, ps[tid * (BK + 1) + j]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, m_cur);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      a_s[tid] = m_prev == -INFINITY ? 0.0f : expf(__fsub_rn(m_prev, m_safe));
      ms_s[tid] = m_safe;
      m_s[tid] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int r = tr + TR * a;
      const float m_safe = ms_s[r];
#pragma unroll
      for (int b = 0; b < CN; ++b) {
        const int c = tc + TC * b;
        ps[r * (BK + 1) + c] = s[a][b] == -INFINITY ? 0.0f : expf(__fsub_rn(s[a][b], m_safe));
      }
    }
    __syncthreads();

    if (tid < BQ) {                       // l' = a * l + sum_j p_j
      float sp = 0.0f;
      for (int j = 0; j < BK; ++j) sp = __fadd_rn(sp, ps[tid * (BK + 1) + j]);
      l_s[tid] = __fadd_rn(__fmul_rn(a_s[tid], l_s[tid]), sp);
    }
    const float alpha = a_s[pr];
    const float* prow = ps + pr * (BK + 1);
#pragma unroll
    for (int i = 0; i < NV; ++i) {        // acc' = acc * a + sum_j p_j v_j
      const int c = pl + TPR * i;
      if (c < Dv) {
        float pv = 0.0f;
        for (int j = 0; j < BK; ++j) pv = __fadd_rn(pv, __fmul_rn(prow[j], vs[j * Dv + c]));
        acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha), pv);
      }
    }
  }
  __syncthreads();

  if (lse != nullptr && tid < n_rows)      // m and l of row tid are its own writes
    lse[bh * rows + r0 + tid] = __fadd_rn(m_s[tid], logf(l_s[tid]));
  if (pr < n_rows) {
    const float l = l_s[pr];
    float* orow = o + (bh * rows + r0 + pr) * (long long)Dv;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = pl + TPR * i;
      if (c < Dv) orow[c] = l > 0.0f ? __fdiv_rn(acc[i], l) : 0.0f;
    }
  }
}

template <int BQ, int RM, int DVMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int rows,
           int q_seq, int kv_seq, int D, int Dv, int causal, int window, int kv_len, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<BQ, RM, DVMAX>;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * Dv + BQ * (BK + 1) + 4 * BQ);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (rows + BQ - 1) / BQ;
  kernel<<<(unsigned)((long long)bh * n_tiles), THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, n_tiles, rows,
      q_seq, kv_seq, D, Dv, causal, window, kv_len, scale);
  return (int)cudaGetLastError();
}

template <int DVMAX>
int launch_rows(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int rows,
                int q_seq, int kv_seq, int D, int Dv, int causal, int window, int kv_len,
                float scale, cudaStream_t stream) {
  if (rows <= 4)
    return launch<4, 1, DVMAX>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                               kv_len, scale, stream);
  if (rows <= 16)
    return launch<16, 1, DVMAX>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                                kv_len, scale, stream);
  return launch<64, 4, DVMAX>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                              kv_len, scale, stream);
}

}  // namespace

// q (bh, rows, D), k (bh, kv_seq, D), v (bh, kv_seq, Dv), o (bh, rows, Dv), all
// contiguous f32; rows = G * q_seq. lse (bh, rows) f32, or null: no lse. window
// <= 0: no window. kv_len: valid keys (kv_seq when the caller gave none). D, Dv <=
// 256; bh * row tiles < 2^31.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bh, int rows, int q_seq, int kv_seq,
                                        int D, int Dv, int causal, int window, int kv_len,
                                        float scale, void* stream) {
  if (bh <= 0 || rows <= 0) return 0;
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return Dv <= 128 ? launch_rows<128>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                      window, kv_len, scale, s)
                   : launch_rows<256>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                      window, kv_len, scale, s);
}
