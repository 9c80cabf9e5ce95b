// K2 — chunked top-k over a long score vector, one launch per pass.
//
// Replaces: src/repro/kernels/topk.py::_local_topk_kernel (the pallas_call in
// topk, topk.py:70) and, run again over the survivors, the lax.top_k merge
// that follows it (topk.py:82).
//
// Computes, for each (query row, chunk of `chunk` scores), the chunk's top k
// under (value desc, index asc), in that order. A -inf value gets the
// sentinel id n_live — the pad-lane guard of topk.py:46 — never a padded
// index; a chunk with fewer than k live scores is padded with -inf. Ties go
// to the lowest index, as lax.top_k gives them. NaN lies outside the
// contract (select.cuh).
//
// The merge is the same kernel over the (Q, n_chunks*k) survivors with
// `ids_in` set: positions map back to ids. Survivors lie in chunk order and,
// within a chunk, equal values in index order, so the lowest position among
// equal values is the lowest id: the merge keeps lax.top_k's tie order.
//
// Bound on an H100: bytes — every score is read once (4 B) against a few
// integer operations per element; bert4rec's 512 x 2^20 logits are 2.1 GB,
// 0.64 ms at 3.35 TB/s. The earlier version took k rounds of (block-wide
// max, first argmax, mask) per chunk: k scans and 2k barriers, work that grew
// with k (29 ms at k = 100 on that shape, 4.7x torch.topk).
//
// Design: one block of 256 threads per (chunk, query), on one flat grid.x
// (query * n_chunks + chunk: no 65,535 limit on Q). A chunk of up to 8,192
// scores, 32 a thread, is loaded into registers (and shared memory) with
// 4-byte loads, all 32 in flight at once (rows such as K1's
// acc[:, :n_docs], stride n_docs + 1, or bert4rec's 1,048,578-wide logits are
// not 16-byte aligned); a longer chunk (k > 4,096) goes through shared
// memory alone. Each thread keeps the largest key it loaded. For
// k <= 256 the k-th largest of those 256 maxima is a floor that at least k
// elements reach (select.cuh, step 0). One pass over the registers counts
// the elements above the floor and at it per (32-score part, warp), and a
// scan of those counts gives each part its first place in position order
// (a longer chunk takes warp-contiguous segments of shared memory instead).
// Then:
//  - fewer than k above it (a sparse row's run of 0.0): those and the first
//    ones at it by position are the top k, written straight to the
//    survivors;
//  - at most 1,024 above it (a logit row: ~2 %): they are gathered in
//    position order and, when at most 256, ranked against each other (a
//    few compares a thread), else radix-selected (select.cuh) alone;
//  - else select.cuh's radix select runs on the chunk in shared memory,
//    over the elements at or above the floor.
// The k survivors are then ranked. So a chunk costs its loads and two passes
// over registers in the common cases, and the work no longer grows with k
// but for the k·k rank compares. (Radix passes over a whole 16,384-score
// chunk in shared memory took 2.3 ms at bert4rec's shape on an H100, where
// loading it took 0.78 ms.)
#include <math.h>

#include "common.cuh"
#include "select.cuh"

#define TOPK_THREADS 256
#define TOPK_WARPS (TOPK_THREADS / 32)
#define TOPK_SLOTS 32                             // scores a thread holds in registers
#define TOPK_REG_CHUNK (TOPK_THREADS * TOPK_SLOTS)  // the largest chunk held in registers
#define TOPK_CANDIDATES 1024   // elements above the floor that are selected apart

static_assert(TOPK_SLOTS * TOPK_WARPS == TOPK_THREADS, "one (part, warp) count a thread");

// Dynamic shared memory: the staged chunk, the select's scratch, the
// threads' maxima, the (part, warp) counts, the candidates (key, position),
// k survivors.
static size_t topk_smem(int chunk, int k) {
  return ((size_t)chunk + 3) / 4 * 16 + sizeof(SelectScratch<TOPK_THREADS>) +
         3 * TOPK_THREADS * sizeof(unsigned) + (TOPK_CANDIDATES + (size_t)k) * sizeof(uint2);
}

// scores: row q starts at scores + q*row_stride and holds n live values.
// ids_in (nullable): row q starts at ids_in + q*row_stride.
// out_vals / out_ids: (Q, n_chunks*k), chunk c of row q at (q*n_chunks + c)*k.
// REG: chunk <= TOPK_REG_CHUNK, each thread holding its scores in registers.
// Four blocks an SM (at most 64 registers a thread) let one block's loads
// run beside the others' selects: 7 % faster at bert4rec's shape than three.
template <bool REG>
__global__ void __launch_bounds__(TOPK_THREADS, 4)
    topk_select_kernel(const float* __restrict__ scores, const int* __restrict__ ids_in,
                       long long row_stride, long long n, int chunk, int k, int n_live,
                       int n_chunks, float* __restrict__ out_vals, int* __restrict__ out_ids) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;
  auto* sc = reinterpret_cast<SelectScratch<TOPK_THREADS>*>(smem + (chunk + 3) / 4 * 4);
  unsigned* maxk = reinterpret_cast<unsigned*>(sc + 1);
  unsigned* cnt = maxk + TOPK_THREADS;
  uint2* cand = reinterpret_cast<uint2*>(cnt + 2 * TOPK_THREADS);
  uint2* surv = cand + TOPK_CANDIDATES;
  const long long q = blockIdx.x / n_chunks;           // the chunks of a row side by side
  const int c = (int)(blockIdx.x - q * n_chunks);
  const long long base = (long long)c * chunk;
  const long long left = n - base;
  const int m_live = left < chunk ? (int)(left > 0 ? left : 0) : chunk;
  const int m = m_live > k ? m_live : k;
  const float* row = scores + q * row_stride + base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  float* ov = out_vals + (q * n_chunks + c) * k;
  int* oi = out_ids + (q * n_chunks + c) * k;
  const int* id_row = ids_in ? ids_in + q * row_stride + base : nullptr;
  auto out = [&](int r, int p) {
    const float v = s[p];
    ov[r] = v;
    oi[r] = v == -INFINITY ? n_live : (id_row ? id_row[p] : (int)(base + p));
  };

  // Stage the chunk (positions m_live..m-1 are -inf), each thread keeping
  // the largest key it staged.
  float v[REG ? TOPK_SLOTS : 1];
  unsigned mk = 0;
  if constexpr (REG) {
#pragma unroll
    for (int i = 0; i < TOPK_SLOTS; ++i) {
      const int j = t + i * TOPK_THREADS;
      v[i] = j < m_live ? row[j] : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < TOPK_SLOTS; ++i) {
      const int j = t + i * TOPK_THREADS;
      if (j < m) {
        s[j] = v[i];
        mk = max(mk, order_key(v[i]));
      }
    }
  } else {
#pragma unroll 16
    for (int j = t; j < m; j += TOPK_THREADS) {
      const float x = j < m_live ? row[j] : -INFINITY;
      s[j] = x;
      mk = max(mk, order_key(x));
    }
  }
  maxk[t] = mk;
  __syncthreads();
  unsigned floor_key = 0;
  if (k <= TOPK_THREADS) {           // k maxima, each an element, reach the k-th of them
    const RadixState st = radix_passes<TOPK_THREADS>([&](int j) { return maxk[j]; },
                                                     TOPK_THREADS, k, 0u, 16, t, sc);
    floor_key = st.bits >= 32 ? st.prefix : st.prefix << (32 - st.bits);
  }

  // Count the elements above the floor and at it, and give each (part of
  // the chunk, warp) its first place among them in position order.
  int n_above, seg_g = 0, seg_e = 0;
  if constexpr (REG) {
    // part i of warp w: positions 256 i + 32 w + lane, so (i, w) order is
    // position order; (i, w)'s counts sit at cnt[8 i + w], the equal ones'
    // TOPK_THREADS further, then become exclusive prefix sums in place
#pragma unroll
    for (int i = 0; i < TOPK_SLOTS; ++i) {
      const int j = t + i * TOPK_THREADS;
      const unsigned key = order_key(v[i]);
      const unsigned gm = __ballot_sync(SELECT_FULL, j < m && key > floor_key);
      const unsigned em = __ballot_sync(SELECT_FULL, j < m && key == floor_key);
      if (lane == 0) {
        cnt[i * TOPK_WARPS + warp] = __popc(gm);
        cnt[TOPK_THREADS + i * TOPK_WARPS + warp] = __popc(em);
      }
    }
    __syncthreads();
    const unsigned cg = cnt[t], ce = cnt[TOPK_THREADS + t];
    unsigned ig = cg, ie = ce;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned a = __shfl_up_sync(SELECT_FULL, ig, off);
      const unsigned b = __shfl_up_sync(SELECT_FULL, ie, off);
      if (lane >= off) {
        ig += a;
        ie += b;
      }
    }
    if (lane == 31) {                    // the maxima are spent: the warps' sums
      maxk[warp] = ig;
      maxk[TOPK_WARPS + warp] = ie;
    }
    __syncthreads();
    unsigned pg = 0, pe = 0;
    n_above = 0;
    for (int w = 0; w < TOPK_WARPS; ++w) {
      n_above += maxk[w];
      if (w < warp) {
        pg += maxk[w];
        pe += maxk[TOPK_WARPS + w];
      }
    }
    cnt[t] = pg + ig - cg;
    cnt[TOPK_THREADS + t] = pe + ie - ce;
    __syncthreads();
  } else {
    // each warp's contiguous segment: its counts, then its first places
    const int seg = (m + TOPK_THREADS - 1) / TOPK_THREADS * 32;
    const int lo = warp * seg, hi = min(m, lo + seg);
    int n_gt = 0, n_eq = 0;
    for (int b = lo; b < lo + seg; b += 32) {
      const int j = b + lane;
      const unsigned key = j < hi ? order_key(s[j]) : 0u;
      n_gt += __popc(__ballot_sync(SELECT_FULL, j < hi && key > floor_key));
      n_eq += __popc(__ballot_sync(SELECT_FULL, j < hi && key == floor_key));
    }
    if (lane == 0) {                     // the maxima are spent: the warps' counts
      maxk[warp] = n_gt;
      maxk[TOPK_WARPS + warp] = n_eq;
    }
    __syncthreads();
    n_above = 0;
    for (int w = 0; w < TOPK_WARPS; ++w) {
      n_above += maxk[w];
      if (w < warp) {
        seg_g += maxk[w];
        seg_e += maxk[TOPK_WARPS + w];
      }
    }
  }

  // Walk the chunk once more in the same order, handing each element above
  // the floor (and at it) its place: put(j, key, above, at) with `at` the
  // element's place among those above it (at it).
  auto walk = [&](auto put) {
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < TOPK_SLOTS; ++i) {
        const int j = t + i * TOPK_THREADS;
        const unsigned key = order_key(v[i]);
        const bool g = j < m && key > floor_key, e = j < m && key == floor_key;
        const unsigned gm = __ballot_sync(SELECT_FULL, g), em = __ballot_sync(SELECT_FULL, e);
        if (g) put(j, key, true, (int)(cnt[i * TOPK_WARPS + warp] + __popc(gm & lt)));
        if (e)
          put(j, key, false, (int)(cnt[TOPK_THREADS + i * TOPK_WARPS + warp] + __popc(em & lt)));
      }
    } else {
      const int seg = (m + TOPK_THREADS - 1) / TOPK_THREADS * 32;
      const int lo = warp * seg, hi = min(m, lo + seg);
      int pg = seg_g, pe = seg_e;
      for (int b = lo; b < lo + seg; b += 32) {
        const int j = b + lane;
        const unsigned key = j < hi ? order_key(s[j]) : 0u;
        const bool g = j < hi && key > floor_key, e = j < hi && key == floor_key;
        const unsigned gm = __ballot_sync(SELECT_FULL, g), em = __ballot_sync(SELECT_FULL, e);
        if (g) put(j, key, true, pg + __popc(gm & lt));
        if (e) put(j, key, false, pe + __popc(em & lt));
        pg += __popc(gm);
        pe += __popc(em);
      }
    }
  };

  if (n_above < k) {
    // Fewer than k above the floor: they and the first k - n_above at it
    // (lowest positions) are the top k — a run of 0.0 in a sparse row.
    const int need = k - n_above;
    walk([&](int j, unsigned key, bool above, int at) {
      if (above) {
        surv[at] = make_uint2(key, (unsigned)j);
      } else if (at < need) {
        surv[n_above + at] = make_uint2(key, (unsigned)j);
      }
    });
    __syncthreads();
    rank_emit<TOPK_THREADS>(surv, k, t, out);
  } else if (n_above <= TOPK_CANDIDATES) {
    // The top k lie above the floor: gathered in position order — a logit
    // row leaves ~2 % of its chunk — they are ranked against each other when
    // there are at most 256 (a compare or a few a thread), else the radix
    // select runs on them.
    walk([&](int j, unsigned key, bool above, int at) {
      if (above) cand[at] = make_uint2(key, (unsigned)j);
    });
    __syncthreads();
    if (n_above <= TOPK_THREADS) {
      rank_emit<TOPK_THREADS>(cand, n_above, t, [&](int r, int p) {
        if (r < k) out(r, p);
      });
    } else {
      select_topk<TOPK_THREADS>([&](int j) { return cand[j].x; }, n_above, k, 0u, t, sc, surv,
                                [&](int r, int p) { out(r, (int)cand[p].y); });
    }
  } else {
    select_topk<TOPK_THREADS>([&](int j) { return order_key(s[j]); }, m, k, floor_key, t, sc,
                              surv, out);
  }
}

template <bool REG>
static int launch(const float* scores, const int* ids_in, long long row_stride, long long n,
                  int Q, int chunk, int k, int n_live, int n_chunks, float* out_vals,
                  int* out_ids, cudaStream_t stream) {
  const size_t smem = topk_smem(chunk, k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_select_kernel<REG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((long long)n_chunks * Q);
  topk_select_kernel<REG><<<blocks, TOPK_THREADS, smem, stream>>>(
      scores, ids_in, row_stride, n, chunk, k, n_live, n_chunks, out_vals, out_ids);
  return (int)cudaGetLastError();
}

REPRO_EXPORT long long topk_smem_bytes(int chunk, int k) { return (long long)topk_smem(chunk, k); }

REPRO_EXPORT int topk_select_launch(const void* scores, const void* ids_in,
                                    long long row_stride, long long n, int Q, int chunk,
                                    int k, int n_live, void* out_vals, void* out_ids,
                                    void* stream) {
  const int n_chunks = n > 0 ? (int)((n + chunk - 1) / chunk) : 1;
  if (Q <= 0 || k <= 0) return 0;
  if (k > chunk) return (int)cudaErrorInvalidValue;
  auto* f = chunk <= TOPK_REG_CHUNK ? launch<true> : launch<false>;
  return f((const float*)scores, (const int*)ids_in, row_stride, n, Q, chunk, k, n_live,
           n_chunks, (float*)out_vals, (int*)out_ids, (cudaStream_t)stream);
}
