// K5 on bf16 — FlashAttention forward on the tensor cores (prefill) and
// split over the kv axis (decode).
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// pallas_call in flash_attention, flash_attention.py:128), for bf16 inputs.
// f32 inputs take csrc/flash_attention.cu, which keeps the twin's bits.
//
// Computes what flash_attention.cu computes, per (batch, kv head) and per
// folded query row r = g * Sq + s at position r % Sq + (Skv - Sq): causal,
// sliding-window and kv_len masks, softmax over the visible keys with an
// f32 running max, denominator and accumulator, 0 for a row that sees no
// key, bf16 out. Scores are kept in the log2 domain (scale * log2 e folded
// into one multiply, exp2 for exp): the same softmax, other roundings.
//
// Not bitwise. The tensor cores sum in an order of their own and P is
// rounded to bf16 before P . V; split-KV merges the softmax in another
// order. Both are held to a tolerance against the twin on the card.
//
// Prefill: flash_tc_fwd_kernel. Bound on an H100: operations (4 * D flops
// per visible pair; ~0.69 TFLOP a layer of h2o-danube at 4 x 6144 tokens,
// window 4096, against 989 TFLOP/s bf16). Design: one block per (tile of
// 128 folded rows, batch * kv head) on one flat grid.x, the row tiles of one
// (b, kv head) next to each other (its K/V stay in L2), the longest tiles
// first. S = Q . K^T and O += P . V run as mma.sync.m16n8k16 (bf16
// operands, f32 accumulators in registers), Q's fragments held in
// registers, K and V tiles of 64 keys fed from shared memory by ldmatrix (V
// transposed by ldmatrix.trans). At D <= 80 a block is 4 warps of 32 rows
// (two m16 tiles: each K or V fragment read from shared memory feeds two
// products, and those reads are what bounds the products here); wider
// heads take 8 warps of 16 rows, as registers allow. K/V arrive by
// cp.async in a two-stage ring, so the next tile's copy overlaps this
// tile's products. The online softmax stays in registers: a row's max and
// sum by two shuffles within the 4 threads that hold it; P is packed to bf16
// straight from the S accumulators into P . V's A fragments. D and Dv are
// padded with zeros to 64, 80, 128 or 256 in shared memory, or, for D in
// (128, 192] with Dv <= 128 (MLA's qk 192 and v 128), D to 192 and Dv to
// 128 apart: padding both to 256 wasted a quarter of Q . K^T and half of
// P . V there. Key tiles that
// no row of the block sees are skipped; tiles every row sees wholly skip
// the mask arithmetic. (wgmma with TMA-fed tiles is the next step.)
//
// Decode: flash_split_fwd_kernel + flash_split_combine_kernel. Bound:
// bytes (the ring of K and V read once a step). Design: the kv range
// [k_begin, kv_end) cut into splits of whole 128-key tiles, one block of 8
// warps per (batch * kv head, split), as many splits as fill the card once
// at two blocks an SM (the wrapper's split_plan: 4 tiles a split, 32 heads x
// 8 splits = 256 blocks at 4,096 slots). A block streams its split through
// a two-stage shared-memory ring by 16-byte cp.async, the next tile in
// flight while one is used; the <= 16 folded rows are one m16 tile, and
// each warp takes 16 keys of every tile: S = Q . K^T and O += P . V by
// mma.sync as in the prefill kernel, an online softmax in registers, the
// warps' states merged in warp order at the end (D > 128: 4 warps and
// 64-key tiles, to fit shared memory). Each split writes (m, l, acc[Dv]) to
// f32 scratch; a second launch merges the splits in split order by the
// log-sum-exp rule (fixed order, no atomics: deterministic), divides by l
// and writes bf16 (0 where l = 0). Decode does ~4 flops a byte, far below
// the 295 where the tensor cores would be the limit; they are used because
// the products then cost next to nothing between two tiles' copies (the
// same split on the CUDA cores in f32 was slower than the copies alone by
// half).
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TC_BQ = 128;             // folded rows a block
constexpr int TC_BK = 64;              // keys a tile
constexpr int TC_STAGES = 2;           // the prefill's K/V ring
constexpr int SPLIT_STAGES = 2;        // split-KV's shared-memory ring
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22, subnormals flushed to
// 0): exp2f's extra range handling cost ~5 % of the prefill kernel on an
// H100.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [0, n) of a row-major (stride w) bf16 matrix starting at g into
// shared memory at pitch `pitch`, `wp` columns a row: rows >= valid and
// columns >= w become 0. vec: 16-byte cp.async (w % 8 == 0, g 16-byte
// aligned, wp % 8 == 0); else plain element copies.
__device__ __forceinline__ void stage_rows(bf16* s, int pitch, const bf16* g, int w, int wp,
                                           int n, int valid, bool vec, int tid, int threads) {
  if (vec) {
    const int cpr = wp / 8;
    for (int i = tid; i < n * cpr; i += threads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = r < valid && c < w;
      cp_async16(s + r * pitch + c, ok ? g + (long long)r * w + c : g, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < n * wp; i += threads) {
      const int r = i / wp, c = i - r * wp;
      s[r * pitch + c] = r < valid && c < w ? g[(long long)r * w + c] : zero;
    }
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// Tile i of a K/V ring of T-key tiles (keys key0 + i * T on, those past
// `end` zero) into stage i % STAGES, if there is a tile i (i < n); then one
// cp.async group closed, empty or not, so that each tile is one group. K
// rows are padded to P columns, V rows to PV.
template <int P, int PV, int T, int STAGES>
__device__ __forceinline__ void ring_issue(bf16* ks, bf16* vs, const bf16* kb, const bf16* vb,
                                           int i, int n, int key0, int end, int D, int Dv,
                                           bool vec, int tid, int threads) {
  if (i < n) {
    constexpr int PITCH = P + 8, PITCH_V = PV + 8;
    const int key = key0 + i * T, st = i % STAGES;
    stage_rows(ks + st * T * PITCH, PITCH, kb + (long long)key * D, D, P, T, end - key, vec,
               tid, threads);
    stage_rows(vs + st * T * PITCH_V, PITCH_V, vb + (long long)key * Dv, Dv, PV, T, end - key,
               vec, tid, threads);
  }
  cp_async_commit();
}

// a and b reduced over the 4 threads (lane % 4) that hold one row of an
// m16n8 accumulator
__device__ __forceinline__ void quad_max(float& a, float& b) {
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, sh));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, sh));
  }
}
__device__ __forceinline__ void quad_sum(float& a, float& b) {
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, sh);
    b += __shfl_xor_sync(0xffffffffu, b, sh);
  }
}

// One online-softmax step of an m16 row tile over NS 8-key n-tiles of
// scores s (log2 domain, -inf where masked), rows a (lane / 4) and b (+ 8):
// the new running max (a row that has seen nothing yet keeps 0 as its
// shift), l and the NV n-tiles of acc rescaled by 2^(m_prev - m_new), the
// tile's Σp added to this thread's part of l (summed over the quad at the
// end), and P rounded to bf16 into P . V's A fragments, two n-tiles each.
template <int NS, int NV>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float& m_a, float& m_b,
                                             float& l_a, float& l_b, float (&acc)[NV][4],
                                             uint32_t (&pa)[NS / 2][4]) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
  }
  quad_max(mx_a, mx_b);
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  const float ms_a = mn_a == -INFINITY ? 0.0f : mn_a;
  const float ms_b = mn_b == -INFINITY ? 0.0f : mn_b;
  const float al_a = exp2_approx(m_a - ms_a), al_b = exp2_approx(m_b - ms_b);
  m_a = mn_a;
  m_b = mn_b;
  float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    s[n][0] = exp2_approx(s[n][0] - ms_a);
    s[n][1] = exp2_approx(s[n][1] - ms_a);
    s[n][2] = exp2_approx(s[n][2] - ms_b);
    s[n][3] = exp2_approx(s[n][3] - ms_b);
    ps_a += s[n][0] + s[n][1];
    ps_b += s[n][2] + s[n][3];
  }
  l_a = l_a * al_a + ps_a;
  l_b = l_b * al_b + ps_b;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    acc[n][0] *= al_a;
    acc[n][1] *= al_a;
    acc[n][2] *= al_b;
    acc[n][3] *= al_b;
  }
#pragma unroll
  for (int j = 0; j < NS / 2; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

// MT m16 tiles of rows a warp, 8 / MT warps: a block is TC_BQ rows either
// way; MT = 2 reads each K and V fragment once for two row tiles. Q and K
// padded to P columns, V and O to PV.
template <int P, int MT, int PV = P>
__global__ void __launch_bounds__(32 * (8 / MT), P <= 80 ? 2 : 1)
flash_tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int n_tiles, int rows,
                    int q_seq, int kv_seq, int D, int Dv, int causal, int window, int kv_len,
                    float scale_log2, int vec) {
  constexpr int THREADS = 32 * (8 / MT);
  constexpr int PITCH = P + 8;         // 16 bytes of pad: ldmatrix rows hit distinct banks
  constexpr int KSTEPS = P / 16;       // k-steps of S = Q . K^T
  constexpr int NS = TC_BK / 8;        // 8-key n-tiles of S
  constexpr int PITCH_V = PV + 8;
  constexpr int NV = PV / 8;           // 8-column n-tiles of O
  constexpr bool Q_REGS = P * MT <= 128;   // hold Q's fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // TC_BQ x PITCH
  bf16* ks = qs + TC_BQ * PITCH;                  // TC_STAGES x TC_BK x PITCH
  bf16* vs = ks + TC_STAGES * TC_BK * PITCH;      // TC_STAGES x TC_BK x PITCH_V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = blockIdx.x / n_tiles;
  const int tile = n_tiles - 1 - (int)(blockIdx.x - bh * n_tiles);   // longest first
  const int r0 = tile * TC_BQ;
  const int n_rows = min(TC_BQ, rows - r0);
  const int off = kv_seq - q_seq;
  const bf16* qb = q + (bh * rows + r0) * (long long)D;
  const bf16* kb = k + bh * kv_seq * (long long)D;
  const bf16* vb = v + bh * kv_seq * (long long)Dv;

  // The keys any row of this block may see: [k_lo, k_hi).
  const int r_last = r0 + n_rows - 1;
  int q_lo = off, q_hi = q_seq - 1 + off;
  if (r0 / q_seq == r_last / q_seq) {
    q_lo = r0 % q_seq + off;
    q_hi = r_last % q_seq + off;
  }
  const int kv_end = min(kv_len, kv_seq);
  int k_hi = kv_end;
  if (causal) k_hi = min(k_hi, q_hi + 1);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_first = (k_lo / TC_BK) * TC_BK;
  const int n_kt = k_first < k_hi ? (k_hi - k_first + TC_BK - 1) / TC_BK : 0;

  // this thread's rows of the accumulator layout, in row tile mt:
  // ra = the tile's first row + lane / 4, rb = ra + 8
  const int g = lane >> 2, t = lane & 3;
  int ra[MT], qpos_a[MT], qpos_b[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    ra[mt] = (warp * MT + mt) * 16 + g;
    qpos_a[mt] = (r0 + ra[mt]) % q_seq + off;
    qpos_b[mt] = (r0 + ra[mt] + 8) % q_seq + off;
  }

  float acc[MT][NV][4];
  float m_a[MT], m_b[MT], l_a[MT], l_b[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.0f;
    m_a[mt] = m_b[mt] = -INFINITY;
    l_a[mt] = l_b[mt] = 0.0f;
  }

  if (n_kt > 0) stage_rows(qs, PITCH, qb, D, P, TC_BQ, n_rows, vec, tid, THREADS);
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st)            // the ring's first tiles
    ring_issue<P, PV, TC_BK, TC_STAGES>(ks, vs, kb, vb, st, n_kt, k_first, kv_end, D, Dv, vec,
                                        tid, THREADS);

  uint32_t qf[MT][Q_REGS ? KSTEPS : 1][4];
  const bf16* q_frag = qs + (warp * MT * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = k_first + it * TC_BK;
    // the tile TC_STAGES - 1 on, into the free stage
    ring_issue<P, PV, TC_BK, TC_STAGES>(ks, vs, kb, vb, it + TC_STAGES - 1, n_kt, k_first,
                                        kv_end, D, Dv, vec, tid, THREADS);
    cp_async_wait<TC_STAGES - 1>();      // this tile (and Q) have landed
    __syncthreads();
    if (Q_REGS && it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (Q_REGS ? KSTEPS : 0); ++kk)
          ldmatrix_x4(qf[mt][kk], q_frag + mt * 16 * PITCH + kk * 16);
    }
    const bf16* kst = ks + (it % TC_STAGES) * TC_BK * PITCH;
    const bf16* vst = vs + (it % TC_STAGES) * TC_BK * PITCH_V;

    // S = Q . K^T: ldmatrix x4 gives b0/b1 of two 8-key n-tiles
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.0f;
    const bf16* k_frag = kst + ((lane & 7) + ((lane >> 4) << 3)) * PITCH + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[mt][Q_REGS ? kk : 0][i];
        } else {
          ldmatrix_x4(a[mt], q_frag + mt * 16 * PITCH + kk * 16);
        }
      }
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, k_frag + nn * 16 * PITCH + kk * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * nn], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * nn + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // scale into the log2 domain; mask unless every row sees the whole tile
    const bool full = k0 + TC_BK <= kv_end && (!causal || k0 + TC_BK - 1 <= q_lo) &&
                      (window <= 0 || k0 > q_hi - window);
    uint32_t pa[MT][TC_BK / 16][4];      // P in bf16: P . V's A fragments
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e] * scale_log2;
          if (!full) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = e < 2 ? qpos_a[mt] : qpos_b[mt];
            if (!(kpos < kv_end && visible(kpos, qpos, causal, window))) x = -INFINITY;
          }
          s[mt][n][e] = x;
        }
      }

      // online softmax in registers: the 4 threads of a row hold its 64 keys
      softmax_step<NS, NV>(s[mt], m_a[mt], m_b[mt], l_a[mt], l_b[mt], acc[mt], pa[mt]);
    }

    // O += P . V
    const bf16* v_frag = vst + (lane & 15) * PITCH_V + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < TC_BK / 16; ++j) {
#pragma unroll
      for (int nn = 0; nn < NV / 2; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_frag + j * 16 * PITCH_V + nn * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * nn], pa[mt][j], b[0], b[1]);
          mma_bf16(acc[mt][2 * nn + 1], pa[mt][j], b[2], b[3]);
        }
      }
    }
    __syncthreads();                     // this stage is free for a later tile
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float la = l_a[mt], lb = l_b[mt];
    quad_sum(la, lb);
    const float inv_a = la > 0.0f ? 1.0f / la : 0.0f;
    const float inv_b = lb > 0.0f ? 1.0f / lb : 0.0f;
    const int rb = ra[mt] + 8;
    bf16* oa = o + (bh * rows + r0 + ra[mt]) * (long long)Dv;
    bf16* ob = o + (bh * rows + r0 + rb) * (long long)Dv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int c = n * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < Dv) {
          if (ra[mt] < n_rows) oa[c + e] = __float2bfloat16_rn(acc[mt][n][e] * inv_a);
          if (rb < n_rows) ob[c + e] = __float2bfloat16_rn(acc[mt][n][2 + e] * inv_b);
        }
      }
    }
  }
}

// One block of WARPS warps per (batch * kv head, split of `split` keys, a
// multiple of DT = 16 WARPS); the <= 16 folded rows, padded to one m16
// tile. The split streams through a SPLIT_STAGES-deep shared-memory ring a
// DT-key tile at a time; warp w takes keys [16 w, 16 w + 16) of every tile
// with its own online softmax in registers, S = Q . K^T and O += P . V on
// the tensor cores as in the prefill kernel. The warps' (m, l, acc) merge
// in warp order at the end into the split's partial.
template <int P, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_split_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int n_split, int split, int rows, int q_seq,
                       int kv_seq, int D, int Dv, int causal, int window, int k_begin,
                       int kv_end, float scale_log2, int vec) {
  constexpr int THREADS = 32 * WARPS, DT = 16 * WARPS;
  constexpr int PITCH = P + 8;
  constexpr int KSTEPS = P / 16, NV = P / 8;
  constexpr bool Q_REGS = P <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // 16 x PITCH
  bf16* ks = qs + 16 * PITCH;                              // SPLIT_STAGES x DT x PITCH
  bf16* vs = ks + SPLIT_STAGES * DT * PITCH;               // SPLIT_STAGES x DT x PITCH
  float* mrg = reinterpret_cast<float*>(ks);               // at the end: WARPS x 16 x (P + 2)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = blockIdx.x / n_split;
  const int sp = (int)(blockIdx.x - bh * n_split);
  const int s0 = k_begin + sp * split;
  const int s_end = min(s0 + split, kv_end);
  const int n_t = (s_end - s0 + DT - 1) / DT;
  const int off = kv_seq - q_seq;
  const bf16* kb = k + bh * kv_seq * (long long)D;
  const bf16* vb = v + bh * kv_seq * (long long)Dv;

  stage_rows(qs, PITCH, q + bh * rows * (long long)D, D, P, 16, rows, vec, tid, THREADS);
#pragma unroll
  for (int st = 0; st < SPLIT_STAGES - 1; ++st)         // the ring's first tiles
    ring_issue<P, P, DT, SPLIT_STAGES>(ks, vs, kb, vb, st, n_t, s0, s_end, D, Dv, vec, tid,
                                       THREADS);

  const int g = lane >> 2, t = lane & 3;
  const int qpos_a = g % q_seq + off, qpos_b = (g + 8) % q_seq + off;
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  uint32_t qf[Q_REGS ? KSTEPS : 1][4];
  const bf16* q_frag = qs + (lane & 15) * PITCH + (lane >> 4) * 8;

  for (int it = 0; it < n_t; ++it) {
    ring_issue<P, P, DT, SPLIT_STAGES>(ks, vs, kb, vb, it + SPLIT_STAGES - 1, n_t, s0, s_end, D,
                                       Dv, vec, tid, THREADS);
    cp_async_wait<SPLIT_STAGES - 1>();   // tile `it` (and Q) have landed
    __syncthreads();
    if (Q_REGS && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (Q_REGS ? KSTEPS : 0); ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
    }
    const int cur = it % SPLIT_STAGES;
    const bf16* kst = ks + cur * DT * PITCH + warp * 16 * PITCH;   // this warp's 16 keys
    const bf16* vst = vs + cur * DT * PITCH + warp * 16 * PITCH;
    const int k0 = s0 + it * DT + warp * 16;

    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    const bf16* k_frag = kst + ((lane & 7) + ((lane >> 4) << 3)) * PITCH + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if (Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[Q_REGS ? kk : 0][i];
      } else {
        ldmatrix_x4(a, q_frag + kk * 16);
      }
      uint32_t b[4];
      ldmatrix_x4(b, k_frag + kk * 16);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        const bool ok = (lo ? g : g + 8) < rows && kpos < s_end &&
                        visible(kpos, lo ? qpos_a : qpos_b, causal, window);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
      }
    }

    uint32_t pa[1][4];
    softmax_step<2, NV>(s, m_a, m_b, l_a, l_b, acc, pa);
    const bf16* v_frag = vst + (lane & 15) * PITCH + (lane >> 4) * 8;
#pragma unroll
    for (int nn = 0; nn < NV / 2; ++nn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_frag + nn * 16);
      mma_bf16(acc[2 * nn], pa[0], b[0], b[1]);
      mma_bf16(acc[2 * nn + 1], pa[0], b[2], b[3]);
    }
    __syncthreads();                     // this stage is free for the tile SPLIT_STAGES on
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free: it holds the warps' states now

  quad_sum(l_a, l_b);
  float* mw = mrg + warp * 16 * (P + 2);                 // row r: acc[P], m, l
  if (t == 0) {
    mw[g * (P + 2) + P] = m_a;
    mw[g * (P + 2) + P + 1] = l_a;
    mw[(g + 8) * (P + 2) + P] = m_b;
    mw[(g + 8) * (P + 2) + P + 1] = l_b;
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int c = n * 8 + 2 * t;
    mw[g * (P + 2) + c] = acc[n][0];
    mw[g * (P + 2) + c + 1] = acc[n][1];
    mw[(g + 8) * (P + 2) + c] = acc[n][2];
    mw[(g + 8) * (P + 2) + c + 1] = acc[n][3];
  }
  __syncthreads();

  // the warps merged in order: M = max m_w, l = sum e^(m_w - M) l_w, acc likewise
  const long long part = (bh * n_split + sp) * rows;
  for (int i = tid; i < rows * (Dv + 1); i += THREADS) {
    const int r = i / (Dv + 1), c = i - r * (Dv + 1);    // c == Dv: the row's (m, l)
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mrg[(w * 16 + r) * (P + 2) + P]);
    const float ms = mx == -INFINITY ? 0.0f : mx;
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* row = mrg + (w * 16 + r) * (P + 2);
      x += exp2_approx(row[P] - ms) * row[c < Dv ? c : P + 1];
    }
    if (c < Dv) {
      part_acc[(part + r) * Dv + c] = x;
    } else {
      part_ml[(part + r) * 2] = mx;
      part_ml[(part + r) * 2 + 1] = x;
    }
  }
}

// One block per (batch * kv head, folded row): the splits merged in order.
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_split_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                           bf16* __restrict__ o, int n_split, int rows, int Dv) {
  const long long bhr = blockIdx.x;                  // bh * rows + r
  const long long bh = bhr / rows;
  const int r = (int)(bhr - bh * rows);
  float mx = -INFINITY;
  for (int sp = 0; sp < n_split; ++sp)
    mx = fmaxf(mx, part_ml[((bh * n_split + sp) * rows + r) * 2]);
  const float ms = mx == -INFINITY ? 0.0f : mx;
  for (int c = threadIdx.x; c < Dv; c += COMBINE_THREADS) {
    float l = 0.0f, a = 0.0f;
    for (int sp = 0; sp < n_split; ++sp) {
      const long long p = (bh * n_split + sp) * rows + r;
      const float w = exp2_approx(part_ml[p * 2] - ms);    // 0 for a split this row never saw
      l = fmaf(w, part_ml[p * 2 + 1], l);
      a = fmaf(w, part_acc[p * Dv + c], a);
    }
    o[bhr * Dv + c] = __float2bfloat16_rn(l > 0.0f ? a / l : 0.0f);
  }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory past 48 KB, once
// for the largest size it has been launched with (`granted` is the caller's
// own static: no runtime call on later launches, so a CUDA graph can
// capture them).
template <typename K>
cudaError_t set_smem(K kernel, size_t smem, size_t& granted) {
  if (smem <= 48 * 1024 || smem <= granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int P, int MT, int PV = P>
int launch_tc(const void* q, const void* k, const void* v, void* o, int bh, int rows, int q_seq,
              int kv_seq, int D, int Dv, int causal, int window, int kv_len, float scale_log2,
              int vec, cudaStream_t stream) {
  auto kernel = flash_tc_fwd_kernel<P, MT, PV>;
  const size_t smem = sizeof(bf16) * ((size_t)(TC_BQ + TC_STAGES * TC_BK) * (P + 8) +
                                      (size_t)TC_STAGES * TC_BK * (PV + 8));
  static size_t granted = 0;
  const cudaError_t err = set_smem(kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (rows + TC_BQ - 1) / TC_BQ;
  kernel<<<(unsigned)((long long)bh * n_tiles), 32 * (8 / MT), smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, n_tiles, rows, q_seq, kv_seq,
      D, Dv, causal, window, kv_len, scale_log2, vec);
  return (int)cudaGetLastError();
}

// 8 warps (128-key tiles) up to P = 128; 4 (64-key tiles) at P = 256, whose
// ring of 128-key tiles would not fit shared memory.
template <int P, int WARPS = P <= 128 ? 8 : 4>
int launch_split(const void* q, const void* k, const void* v, float* part_acc, float* part_ml,
                 int bh, int n_split, int split, int rows, int q_seq, int kv_seq, int D, int Dv,
                 int causal, int window, int k_begin, int kv_end, float scale_log2, int vec,
                 cudaStream_t stream) {
  auto kernel = flash_split_fwd_kernel<P, WARPS>;
  const size_t ring = sizeof(bf16) * (16 + 2 * SPLIT_STAGES * 16 * WARPS) * (P + 8);
  const size_t merge = sizeof(float) * WARPS * 16 * (P + 2) + sizeof(bf16) * 16 * (P + 8);
  const size_t smem = ring > merge ? ring : merge;
  static size_t granted = 0;
  const cudaError_t err = set_smem(kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long long)bh * n_split), 32 * WARPS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, part_acc, part_ml, n_split, split, rows,
      q_seq, kv_seq, D, Dv, causal, window, k_begin, kv_end, scale_log2, vec);
  return (int)cudaGetLastError();
}

bool vec_ok(const void* q, const void* k, const void* v, int D, int Dv) {
  return D % 8 == 0 && Dv % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

}  // namespace

// Prefill on the tensor cores. q (bh, rows, D), k (bh, kv_seq, D), v (bh,
// kv_seq, Dv), o (bh, rows, Dv), contiguous bf16; rows = G * q_seq. window
// <= 0: no window. kv_len: valid keys. D, Dv <= 256. scale_log2 = scale *
// log2(e).
REPRO_EXPORT int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                                           void* o, int bh, int rows, int q_seq, int kv_seq,
                                           int D, int Dv, int causal, int window, int kv_len,
                                           float scale_log2, void* stream) {
  if (bh <= 0 || rows <= 0) return 0;
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256) return (int)cudaErrorInvalidValue;
  const int vec = vec_ok(q, k, v, D, Dv);
  const int p = max(D, Dv);
  cudaStream_t s = (cudaStream_t)stream;
  auto tc = p <= 64                ? &launch_tc<64, 2>
            : p <= 80              ? &launch_tc<80, 2>
            : p <= 128             ? &launch_tc<128, 1>
            : D <= 192 && Dv <= 128 ? &launch_tc<192, 1, 128>
                                   : &launch_tc<256, 1>;
  return tc(q, k, v, o, bh, rows, q_seq, kv_seq, D, Dv, causal, window, kv_len, scale_log2, vec,
            s);
}

// Decode, split over the kv axis: keys [k_begin, kv_end) in n_split splits of
// `split` keys, a multiple of 128 (k_begin + split * n_split >= kv_end), rows
// <= 16. part_acc (bh, n_split, rows, Dv) and part_ml (bh, n_split, rows, 2)
// are f32 scratch.
REPRO_EXPORT int flash_attention_split_launch(const void* q, const void* k, const void* v,
                                              void* o, void* part_acc, void* part_ml, int bh,
                                              int n_split, int split, int rows, int q_seq,
                                              int kv_seq, int D, int Dv, int causal,
                                              int window, int k_begin, int kv_end,
                                              float scale_log2, void* stream) {
  if (bh <= 0 || rows <= 0) return 0;
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || rows > 16 || split < 128 || split % 128)
    return (int)cudaErrorInvalidValue;
  const int vec = vec_ok(q, k, v, D, Dv);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split > 0) {
    const int p = max(D, Dv);
    auto split_kernel = p <= 64    ? &launch_split<64>
                        : p <= 80  ? &launch_split<80>
                        : p <= 128 ? &launch_split<128>
                                   : &launch_split<256>;
    const int err = split_kernel(q, k, v, (float*)part_acc, (float*)part_ml, bh, n_split, split,
                                 rows, q_seq, kv_seq, D, Dv, causal, window, k_begin, kv_end,
                                 scale_log2, vec, s);
    if (err != 0) return err;
  }
  flash_split_combine_kernel<<<(unsigned)((long long)bh * rows), COMBINE_THREADS, 0, s>>>(
      (const float*)part_acc, (const float*)part_ml, (bf16*)o, n_split, rows, Dv);
  return (int)cudaGetLastError();
}
