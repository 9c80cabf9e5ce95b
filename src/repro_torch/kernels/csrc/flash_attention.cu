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
// Three facts let the kernel reorganise the work without moving a bit: a
// sum from +0 is never -0, so adding a +0 term (a zero-padded d, a key of
// p = 0) leaves it as it is; a tile no row of a block sees leaves m, l and
// acc as they are (a = exp(0) = 1, p = 0), so it is skipped; and max is
// exact in any order, so a row's max is reduced across threads by shuffles.
//
// Bound on an H100: operations at long sequences (4 * D flops per visible
// pair against 67 TFLOP/s f32 on the CUDA cores), bytes where the rows are
// few and short (bst: each of q, k, v, o moved once). Products and sums
// stay unfused to keep the twin's bits, so a multiply-add is two
// instructions and the kernel's own ceiling on operations is half the f32
// rate; the tensor cores (TF32) would change the bits.
//
// Two paths, chosen by the wrapper from the shape (flash_attention.py::
// simt_path) and passed in. What held the first, single design back: a block
// of 256 threads per (batch * kv head, 64-row tile) on a flat grid, so at
// bst's 21 rows and 21 keys 441 of a tile's 4,096 scores were real and a
// bulk call paid the staging and five barriers a tile 2,097,152 times;
// the row max and the row sum were two 64-step loops on 64 of the 256
// threads; p . V took two shared loads a multiply-add; and K and V were
// staged element by element, each tile's load waiting on the last one's
// math.
//
// * short (all keys in one tile, Skv <= 64; at most 256 folded rows; D, Dv
//   <= SHORT_DMAX): one thread a folded row, as many (batch * kv head)s a
//   block as their rows fill 256 threads (12 of bst's 21 rows). Their Q, K
//   and V rows are three runs of memory, staged by 16-byte cp.async; the
//   block is persistent and walks the chunks with the next one in flight.
//   A thread keeps its q row in registers and its scores in its own column
//   of shared memory (40 registers; 44 KB a block at bst's shape, so five
//   blocks share an SM): the max, exp(s - m),
//   then sum p and sum p v over the keys in order, the first tile's a = 0
//   terms as the twin takes them, the division and the lse, stored as
//   16-byte vectors where Dv allows. Bound by bytes at bst's shape; the
//   kernel issues ~1,000 instructions a row (expf, IEEE division).
// * tiled (the rest: bert4rec's 200 keys, the LM's f32 check and decode):
//   a block of 256 threads per (batch * kv head, tile of BQ = 16 * RM
//   rows), 64-key tiles (the twin's sums restart from +0 every 64 keys).
//   Q, K and V rows are staged by cp.async (16-byte copies where D and Dv
//   are multiples of 4) at a pitch of 4 (mod 8) floats, so that 8 threads
//   reading 8 rows' float4 hit 8 distinct bank groups; the next K/V tile
//   is in flight while this one is computed, where two stages fit two
//   blocks on an SM. Thread (tr, tc) of 16 x 16 holds rows tr * RM .. + RM
//   - 1 for both products: an RM x 4 patch of scores (keys tc + 16 b, four
//   d at a time from float4 loads of q and k) and an RM x NC patch of p . V
//   (columns tc + 16 b); the row max is a 16-lane shuffle, m, a and l live
//   in registers, sum p is taken in the p . V pass beside the columns (one
//   add a key and row), a row's mask is one compare against its run of
//   keys, and a half-warp whose rows all lie past the block's end computes
//   nothing — no serial row loop, two barriers a tile. Bound by operations
//   (half the f32 rate, unfused); the kernel stays latency-bound at two or
//   three blocks an SM (registers, shared memory).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BK = 64;                 // keys a tile: the twin's FLASH_BK
constexpr int THREADS = 256;
constexpr int SHORT_DMAX = 32;         // D and Dv on the short path
constexpr int MAX_D = 256;             // D and Dv on the tiled path
constexpr int SHORT_BUF = 24 * 1024;   // bytes of Q, K and V a short chunk stages (one
                                       // group, up to 48 KB, where a group needs more)
constexpr int SMEM_MAX = 232448;       // an H100 block's shared memory
constexpr int SMEM_TWO = 113 * 1024;   // a block that leaves room for a second

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared; src_bytes 0 fills the destination with zeros
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

// The keys a query at qpos sees are one run [lo, lo + span): causal ends it
// at qpos, the window starts it at qpos - window + 1, kv_len ends it. A key
// is visible iff (unsigned)(kpos - lo) < span: one compare a pair.
struct KeyRun {
  int lo;
  unsigned span;
};
__device__ __forceinline__ KeyRun key_run(int qpos, int kv_end, int causal, int window) {
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = causal ? min(kv_end, qpos + 1) : kv_end;
  return {lo, (unsigned)max(hi - lo, 0)};
}
__device__ __forceinline__ bool sees(KeyRun run, int kpos) {
  return (unsigned)(kpos - run.lo) < run.span;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------- short path

// n floats from g to s (16-byte aligned) by cp.async: 16-byte copies where g
// is 16-byte aligned, the tail and an unaligned g 4 bytes at a time
__device__ __forceinline__ void stage_flat(float* s, const float* g, int n, int tid, int nt) {
  int i0 = 0;
  if (aligned16(g)) {
    i0 = n & ~3;
    for (int i = 4 * tid; i < i0; i += 4 * nt) cp_async16(s + i, g + i, 16);
  }
  for (int i = i0 + tid; i < n; i += nt) cp_async4(s + i, g + i, 4);
}

// A chunk is `groups` consecutive (batch * kv head)s; its Q rows, K rows
// and V rows are three contiguous runs of memory, staged into a buffer of
// `buf` floats as [Q | K | V], each run from a multiple of 4 floats.
struct ShortChunk {
  int qn, kn;        // the Q and K runs' room, floats
};

// A row's scores s_j = (q . k_j) * scale, -inf off its run, each summed over
// d in order from +0, into ss[j * stride]; returns their max. VEC: D % 4 == 0.
template <int DM, bool VEC>
__device__ __forceinline__ float short_scores(const float (&qr)[DM], const float* kr, float* ss,
                                              int stride, KeyRun run, int kv_seq, int D,
                                              float scale) {
  float m = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < kv_seq; ++j, kr += D) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < DM; d += 4) {
      if (d < D) {
        if (VEC) {
          const float4 t = *reinterpret_cast<const float4*>(kr + d);
          acc = __fadd_rn(acc, __fmul_rn(qr[d], t.x));
          acc = __fadd_rn(acc, __fmul_rn(qr[d + 1], t.y));
          acc = __fadd_rn(acc, __fmul_rn(qr[d + 2], t.z));
          acc = __fadd_rn(acc, __fmul_rn(qr[d + 3], t.w));
        } else {
#pragma unroll
          for (int e = d; e < d + 4; ++e)
            if (e < D) acc = __fadd_rn(acc, __fmul_rn(qr[e], kr[e]));
        }
      }
    }
    const float sj = sees(run, j) ? __fmul_rn(acc, scale) : -INFINITY;
    ss[j * stride] = sj;
    m = fmaxf(m, sj);
  }
  return m;
}

// p_j = exp(s_j - m) (0 off the run); pv = sum_j p_j v_j and the returned
// sum_j p_j, both over the keys in order from +0. VEC: Dv % 4 == 0.
template <int DM, bool VEC>
__device__ __forceinline__ float short_pv(float (&pv)[DM], const float* vr, const float* ss,
                                          int stride, float m, int kv_seq, int Dv) {
  const float m_safe = isfinite(m) ? m : 0.0f;
  float psum = 0.0f;
#pragma unroll
  for (int e = 0; e < DM; ++e) pv[e] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < kv_seq; ++j, vr += Dv) {
    const float sj = ss[j * stride];
    const float p = sj == -INFINITY ? 0.0f : expf(__fsub_rn(sj, m_safe));
    psum = __fadd_rn(psum, p);
#pragma unroll
    for (int e = 0; e < DM; e += 4) {
      if (e < Dv) {
        if (VEC) {
          const float4 t = *reinterpret_cast<const float4*>(vr + e);
          pv[e] = __fadd_rn(pv[e], __fmul_rn(p, t.x));
          pv[e + 1] = __fadd_rn(pv[e + 1], __fmul_rn(p, t.y));
          pv[e + 2] = __fadd_rn(pv[e + 2], __fmul_rn(p, t.z));
          pv[e + 3] = __fadd_rn(pv[e + 3], __fmul_rn(p, t.w));
        } else {
#pragma unroll
          for (int f = e; f < e + 4; ++f)
            if (f < Dv) pv[f] = __fadd_rn(pv[f], __fmul_rn(p, vr[f]));
        }
      }
    }
  }
  return psum;
}

// Persistent: a block walks the chunks blockIdx.x, + gridDim.x, ..., the
// next chunk in flight (cp.async, two buffers) while this one is computed.
// A thread's scores go to its own column of shared memory (kv_seq x the
// threads that hold a row, after the buffers): registers stay few, so many
// blocks share an SM. DM >= D, Dv (a multiple of 4).
template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   long long bh, int groups, int buf, ShortChunk ch, int rows, int q_seq,
                   int kv_seq, int D, int Dv, int causal, int window, int kv_end, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long chunks = (bh + groups - 1) / groups;
  const int gi = tid / rows, r = tid - gi * rows;
  const KeyRun run = key_run(r % q_seq + (kv_seq - q_seq), kv_end, causal, window);
  const bool vec = (D & 3) == 0, vvec = (Dv & 3) == 0;   // rows 16-byte aligned in smem
  const int lanes = groups * rows;             // threads that hold a row
  float* ss = smem + 2 * buf + tid;            // this thread's scores, stride lanes
  auto issue = [&](long long c, int b) {
    if (c < chunks) {
      const long long g0 = c * groups;
      const int ng = (int)min((long long)groups, bh - g0);
      float* base = smem + b * buf;
      stage_flat(base, q + g0 * rows * D, ng * rows * D, tid, nt);
      stage_flat(base + ch.qn, k + g0 * kv_seq * D, ng * kv_seq * D, tid, nt);
      stage_flat(base + ch.qn + ch.kn, v + g0 * kv_seq * Dv, ng * kv_seq * Dv, tid, nt);
    }
    cp_async_commit();                         // one group a chunk, empty or not
  };

  long long c = blockIdx.x;
  issue(c, 0);
  for (int it = 0; c < chunks; c += gridDim.x, ++it) {
    const int b = it & 1;
    issue(c + gridDim.x, b ^ 1);
    cp_async_wait<1>();                        // this chunk has landed
    __syncthreads();
    const long long g0 = c * groups;
    if (gi < min((long long)groups, bh - g0)) {
      const float* base = smem + b * buf;
      const float* qs = base + tid * D;
      float qr[DM];
#pragma unroll
      for (int d = 0; d < DM; d += 4) {
        if (vec && d < D) {
          const float4 t = *reinterpret_cast<const float4*>(qs + d);
          qr[d] = t.x, qr[d + 1] = t.y, qr[d + 2] = t.z, qr[d + 3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qr[d + e] = d + e < D ? qs[d + e] : 0.0f;
        }
      }
      const float* kr = base + ch.qn + gi * kv_seq * D;
      const float* vr = base + ch.qn + ch.kn + gi * kv_seq * Dv;
      const float m = vec ? short_scores<DM, true>(qr, kr, ss, lanes, run, kv_seq, D, scale)
                          : short_scores<DM, false>(qr, kr, ss, lanes, run, kv_seq, D, scale);
      // one tile: m' = max(-inf, max_j s_j), a = 0, l' = 0 * 0 + sum p, acc' = 0 * 0 + sum p v
      float pv[DM];
      const float psum = vvec ? short_pv<DM, true>(pv, vr, ss, lanes, m, kv_seq, Dv)
                              : short_pv<DM, false>(pv, vr, ss, lanes, m, kv_seq, Dv);
      const float zero = 0.0f;
      const float l = __fadd_rn(__fmul_rn(zero, zero), psum);
      const long long row = (g0 + gi) * rows + r;
      if (lse != nullptr) lse[row] = __fadd_rn(m, logf(l));
#pragma unroll
      for (int e = 0; e < DM; ++e)
        pv[e] = l > 0.0f ? __fdiv_rn(__fadd_rn(__fmul_rn(zero, zero), pv[e]), l) : 0.0f;
      float* og = o + row * Dv;
      if (vvec && aligned16(o)) {
#pragma unroll
        for (int e = 0; e < DM; e += 4)
          if (e < Dv)
            *reinterpret_cast<float4*>(og + e) = make_float4(pv[e], pv[e + 1], pv[e + 2],
                                                             pv[e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < DM; ++e)
          if (e < Dv) og[e] = pv[e];
      }
    }
    __syncthreads();                           // buffer b is free for the chunk after next
  }
  cp_async_wait<0>();
}

template <int DM>
int launch_short(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                 int rows, int q_seq, int kv_seq, int D, int Dv, int causal, int window,
                 int kv_end, float scale, cudaStream_t stream) {
  auto kernel = flash_short_kernel<DM>;
  auto room = [](int n) { return (n + 3) & ~3; };
  const int per = rows * D + kv_seq * (D + Dv);          // floats a group stages
  const int groups = max(1, min(THREADS / rows, SHORT_BUF / (int)sizeof(float) / per));
  const ShortChunk ch{room(groups * rows * D), room(groups * kv_seq * D)};
  const int buf = ch.qn + ch.kn + room(groups * kv_seq * Dv);
  const int threads = (groups * rows + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (2 * (size_t)buf + (size_t)kv_seq * groups * rows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = ((long long)bh + groups - 1) / groups;
  const long long blocks = min(chunks, (long long)sms * max(per_sm, 1));
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(q, k, v, o, lse, bh, groups, buf, ch, rows,
                                                      q_seq, kv_seq, D, Dv, causal, window,
                                                      kv_end, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- tiled path

// n rows of w floats (row-major at stride w) from g into s at pitch `pitch`,
// wp >= w floats a row (a multiple of 4); rows >= valid and columns >= w
// become 0. vec: 16-byte copies (w % 4 == 0, g 16-byte aligned).
__device__ __forceinline__ void stage_rows(float* s, int pitch, const float* g, int w, int wp,
                                           int n, int valid, bool vec, int tid) {
  if (vec) {
    const int cpr = wp >> 2;
    for (int i = tid; i < n * cpr; i += THREADS) {
      const int r = i / cpr, c = (i - r * cpr) << 2;
      const bool ok = r < valid;
      cp_async16(s + r * pitch + c, ok ? g + (long long)r * w + c : g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < n * wp; i += THREADS) {
      const int r = i / wp, c = i - r * wp;
      const bool ok = r < valid && c < w;
      cp_async4(s + r * pitch + c, ok ? g + (long long)r * w + c : g, ok ? 4 : 0);
    }
  }
}

// Blocks an SM holds, and the d loop's unroll: three of 85 registers and
// the loop unrolled twice at bert4rec's widths (RM 4, Dv <= 32: 61 KB of
// shared memory a block); else two of 128 registers and no unroll (three
// would spill, a larger unroll would pass 128 registers).
template <int RM, int NC>
constexpr bool kTiledNarrow = RM == 4 && NC <= 2;

// RM rows a thread (BQ = 16 RM a block), NC p . V columns a thread (Dv <= 16 NC).
template <int RM, int NC>
__global__ void __launch_bounds__(THREADS, kTiledNarrow<RM, NC> ? 3 : 2)
flash_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   int n_tiles, int rows, int q_seq, int kv_seq, int D, int Dv, int causal,
                   int window, int kv_end, float scale, int P, int PV, int stages) {
  constexpr int BQ = 16 * RM;
  constexpr int PS = BQ + 4;                   // ps pitch: 4 (mod 8) floats
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 3) & ~3, Dvp = (Dv + 3) & ~3;
  float* qs = smem;                            // BQ x P: the Q tile, rows
  float* ks = qs + BQ * P;                     // stages x BK x P: K tiles, rows
  float* vs = ks + stages * BK * P;            // stages x BK x PV: V tiles, rows
  float* ps = vs + stages * BK * PV;           // BK x PS: this tile's p, key-major

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const long long bh = blockIdx.x / n_tiles;
  const int r0 = (int)(blockIdx.x - bh * n_tiles) * BQ;
  const int n_rows = min(BQ, rows - r0);
  const int off = kv_seq - q_seq;
  const float* qb = q + (bh * rows + r0) * (long long)D;
  const float* kb = k + bh * kv_seq * (long long)D;
  const float* vb = v + bh * kv_seq * (long long)Dv;
  const bool kvec = (D & 3) == 0 && aligned16(q) && aligned16(k);
  const bool vvec = (Dv & 3) == 0 && aligned16(v);

  // The keys any row of this block may see: [k_lo, k_hi).
  const int r_last = r0 + n_rows - 1;
  int q_lo = off, q_hi = q_seq - 1 + off;
  if (r0 / q_seq == r_last / q_seq) {
    q_lo = r0 % q_seq + off;
    q_hi = r_last % q_seq + off;
  }
  int k_hi = kv_end;
  if (causal) k_hi = min(k_hi, q_hi + 1);
  const int key0 = (window > 0 ? max(0, q_lo - window + 1) : 0) / BK * BK;
  const int n = k_hi > key0 ? (k_hi - key0 + BK - 1) / BK : 0;

  // A thread whose rows all lie past the block's last row (bert4rec's
  // fourth tile of 64 holds 8 of its 200 rows) stages and waits at the
  // barriers, and computes nothing: its scores, p and sums are read by no
  // other thread. Its 16 lanes share tr, so a half-warp is idle or not.
  const bool idle = tr * RM >= n_rows;
  const unsigned half = 0xffffu << (tid & 16);
  KeyRun run[RM];                              // a row past the block's end sees no key
#pragma unroll
  for (int a = 0; a < RM; ++a)
    run[a] = tr * RM + a < n_rows
                 ? key_run((r0 + tr * RM + a) % q_seq + off, kv_end, causal, window)
                 : KeyRun{0, 0u};
  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < NC; ++b) acc[a][b] = 0.0f;
  }

  stage_rows(qs, P, qb, D, Dp, BQ, n_rows, kvec, tid);
  if (n > 0) {
    stage_rows(ks, P, kb + (long long)key0 * D, D, Dp, BK, kv_seq - key0, kvec, tid);
    stage_rows(vs, PV, vb + (long long)key0 * Dv, Dv, Dvp, BK, kv_seq - key0, vvec, tid);
  }
  cp_async_commit();

  for (int it = 0; it < n; ++it) {
    cp_async_wait<0>();
    __syncthreads();          // tile `it` has landed; every thread is done with tile it - 1
    const int st = stages == 2 ? (it & 1) : 0;
    const int k0 = key0 + it * BK;
    if (stages == 2 && it + 1 < n) {           // the next tile into the other stage
      const int k1 = k0 + BK;
      stage_rows(ks + (st ^ 1) * BK * P, P, kb + (long long)k1 * D, D, Dp, BK, kv_seq - k1,
                 kvec, tid);
      stage_rows(vs + (st ^ 1) * BK * PV, PV, vb + (long long)k1 * Dv, Dv, Dvp, BK,
                 kv_seq - k1, vvec, tid);
      cp_async_commit();
    }
    const int bk = min(BK, kv_seq - k0);       // the twin's tile: keys past Skv are not in it
    const int nb = min(4, (bk + 15) >> 4);     // column groups with a key
    const float* kt = ks + st * BK * P;
    const float* vt = vs + st * BK * PV;

    // scores: s[a][b] = sum_d q[row a][d] * k[key tc + 16 b][d], d in order from +0
    float s[RM][4];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
#pragma unroll (kTiledNarrow<RM, NC> ? 2 : 1)
    for (int d = 0; d < (idle ? 0 : Dp); d += 4) {
      float4 qv[RM], kv[4];
#pragma unroll
      for (int a = 0; a < RM; ++a)
        qv[a] = *reinterpret_cast<const float4*>(qs + (tr * RM + a) * P + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < nb) kv[b] = *reinterpret_cast<const float4*>(kt + (tc + 16 * b) * P + d);
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < nb) {
            s[a][b] = __fadd_rn(s[a][b], __fmul_rn(qv[a].x, kv[b].x));
            s[a][b] = __fadd_rn(s[a][b], __fmul_rn(qv[a].y, kv[b].y));
            s[a][b] = __fadd_rn(s[a][b], __fmul_rn(qv[a].z, kv[b].z));
            s[a][b] = __fadd_rn(s[a][b], __fmul_rn(qv[a].w, kv[b].w));
          }
    }

    // mask and scale; the row max over the 16 lanes of a row; m, a; p into ps
    float alpha[RM];
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      if (idle) break;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {        // keys past kv_seq lie past every run's end
        s[a][b] = sees(run[a], k0 + tc + 16 * b) ? __fmul_rn(s[a][b], scale) : -INFINITY;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int x = 8; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(half, mx, x));
      const float m_new = fmaxf(m[a], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      alpha[a] = m[a] == -INFINITY ? 0.0f : expf(__fsub_rn(m[a], m_safe));
      m[a] = m_new;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        s[a][b] = s[a][b] == -INFINITY ? 0.0f : expf(__fsub_rn(s[a][b], m_safe));
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (idle) break;
      float* pc = ps + (tc + 16 * b) * PS + tr * RM;
      if (RM == 4) {
        *reinterpret_cast<float4*>(pc) = make_float4(s[0][b], s[RM > 1 ? 1 : 0][b],
                                                     s[RM > 2 ? 2 : 0][b], s[RM > 3 ? 3 : 0][b]);
      } else {
#pragma unroll
        for (int a = 0; a < RM; ++a) pc[a] = s[a][b];
      }
    }
    __syncthreads();

    // p . V over the tile's keys in order from +0, and sum p beside it
    float psum[RM], pv[RM][NC];
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      psum[a] = 0.0f;
#pragma unroll
      for (int b = 0; b < NC; ++b) pv[a][b] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < (idle ? 0 : bk); ++j) {
      float p[RM];
      const float* pj = ps + j * PS + tr * RM;
      if (RM == 4) {
        const float4 t = *reinterpret_cast<const float4*>(pj);
        p[0] = t.x, p[RM > 1 ? 1 : 0] = t.y, p[RM > 2 ? 2 : 0] = t.z, p[RM > 3 ? 3 : 0] = t.w;
      } else {
#pragma unroll
        for (int a = 0; a < RM; ++a) p[a] = pj[a];
      }
#pragma unroll
      for (int a = 0; a < RM; ++a) psum[a] = __fadd_rn(psum[a], p[a]);
      const float* vj = vt + j * PV + tc;
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        if (tc + 16 * b < Dv) {
          const float x = vj[16 * b];
#pragma unroll
          for (int a = 0; a < RM; ++a) pv[a][b] = __fadd_rn(pv[a][b], __fmul_rn(p[a], x));
        }
      }
    }
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      if (idle) break;
      l[a] = __fadd_rn(__fmul_rn(alpha[a], l[a]), psum[a]);
#pragma unroll
      for (int b = 0; b < NC; ++b) acc[a][b] = __fadd_rn(__fmul_rn(acc[a][b], alpha[a]), pv[a][b]);
    }

    if (stages == 1 && it + 1 < n) {           // one stage: the next tile after this one
      __syncthreads();
      const int k1 = k0 + BK;
      stage_rows(ks, P, kb + (long long)k1 * D, D, Dp, BK, kv_seq - k1, kvec, tid);
      stage_rows(vs, PV, vb + (long long)k1 * Dv, Dv, Dvp, BK, kv_seq - k1, vvec, tid);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();        // no copy outlives the block (n = 0: the Q tile's)

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int r = tr * RM + a;
    if (r < n_rows) {
      const long long row = bh * rows + r0 + r;
      if (lse != nullptr && tc == 0) lse[row] = __fadd_rn(m[a], logf(l[a]));
      float* orow = o + row * Dv;
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const int c = tc + 16 * b;
        if (c < Dv) orow[c] = l[a] > 0.0f ? __fdiv_rn(acc[a][b], l[a]) : 0.0f;
      }
    }
  }
}

// a row pitch of w floats rounded up to 4, and then to 4 (mod 8): 8 threads
// reading float4 at the same column of 8 consecutive rows hit 8 bank groups
int bank_pitch(int w) {
  const int p = (w + 3) & ~3;
  return (p / 4) % 2 ? p : p + 4;
}

template <int RM, int NC>
int launch_tiled(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                 int rows, int q_seq, int kv_seq, int D, int Dv, int causal, int window,
                 int kv_end, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * RM;
  auto kernel = flash_tiled_kernel<RM, NC>;
  const int P = bank_pitch(D), PV = (Dv + 3) & ~3;
  auto bytes = [&](int stages) {
    return sizeof(float) * ((size_t)BQ * P + (size_t)stages * BK * (P + PV) + BK * (BQ + 4));
  };
  const int stages = bytes(2) <= (size_t)SMEM_TWO ? 2 : 1;
  const size_t smem = bytes(stages);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (rows + BQ - 1) / BQ;
  kernel<<<(unsigned)((long long)bh * n_tiles), THREADS, smem, stream>>>(
      q, k, v, o, lse, n_tiles, rows, q_seq, kv_seq, D, Dv, causal, window, kv_end, scale, P,
      PV, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// q (bh, rows, D), k (bh, kv_seq, D), v (bh, kv_seq, Dv), o (bh, rows, Dv), all
// contiguous f32; rows = G * q_seq. lse (bh, rows) f32, or null: no lse. window
// <= 0: no window. kv_len: valid keys (kv_seq when the caller gave none). path 0:
// short (kv_seq <= 64, rows <= 256, D and Dv <= 32), 1: tiled (D, Dv <= 256;
// bh * row tiles < 2^31).
REPRO_EXPORT int flash_attention_launch(const void* q_, const void* k_, const void* v_,
                                        void* o_, void* lse_, int bh, int rows, int q_seq,
                                        int kv_seq, int D, int Dv, int causal, int window,
                                        int kv_len, int path, float scale, void* stream) {
  if (bh <= 0 || rows <= 0) return 0;
  // kv_seq 0 is no error: either path then sees no key, and every row is 0
  // with lse -inf, as the twin's
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_D || kv_seq < 0) return (int)cudaErrorInvalidValue;
  const float *q = (const float*)q_, *k = (const float*)k_, *v = (const float*)v_;
  float *o = (float*)o_, *lse = (float*)lse_;
  cudaStream_t s = (cudaStream_t)stream;
  const int kv_end = max(0, min(kv_len, kv_seq));
  if (path == 0) {
    if (kv_seq > BK || rows > THREADS || D > SHORT_DMAX || Dv > SHORT_DMAX)
      return (int)cudaErrorInvalidValue;
    const int w = max(D, Dv);
    if (w <= 4)
      return launch_short<4>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                window, kv_end, scale, s);
    if (w <= 8)
      return launch_short<8>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                window, kv_end, scale, s);
    if (w <= 16)
      return launch_short<16>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                 window, kv_end, scale, s);
    return launch_short<32>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                               kv_end, scale, s);
  }
  if (path != 1) return (int)cudaErrorInvalidValue;
  if (Dv > 128)            // 16 columns a thread: one row a thread keeps the registers
    return launch_tiled<1, 16>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                               kv_end, scale, s);
  const int nc = (Dv + 15) / 16;
  if (rows <= 16) {
    if (nc <= 2)
      return launch_tiled<1, 2>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                window, kv_end, scale, s);
    if (nc <= 5)
      return launch_tiled<1, 5>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal,
                                window, kv_end, scale, s);
    return launch_tiled<1, 8>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                              kv_end, scale, s);
  }
  if (nc <= 2)
    return launch_tiled<4, 2>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                              kv_end, scale, s);
  if (nc <= 5)
    return launch_tiled<4, 5>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                              kv_end, scale, s);
  return launch_tiled<4, 8>(q, k, v, o, lse, bh, rows, q_seq, kv_seq, D, Dv, causal, window,
                            kv_end, scale, s);
}
