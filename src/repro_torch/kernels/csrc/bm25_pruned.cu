// K1 — block-max pruned BM25 scoring + top-k: four kernels a call, launched
// by one C entry point. No (Q, n_docs) array exists anywhere: each query's
// docs are cut into P ranges of R docs, and a range's sums live in shared
// memory.
//
// Replaces: src/repro/kernels/bm25_pruned.py::_pruned_kernel (the pallas_call
// in bm25_pruned_topk, bm25_pruned.py:172).
//
// pruned_theta_kernel, one block per query:
//  1. first-block impacts: each term's m = 0 block, T*B postings, impacts as
//     in bm25_block.cu, zero on pad lanes (doc >= n_docs);
//  2. theta = the k-th best per-doc total over those postings, 0 when T*B < k,
//     computed exactly as theta_lower_bound does (bm25_pruned.py): stable
//     sort by doc id, inclusive cumsum c, p = c - v, start_p = cummax of p at
//     group starts, totals = c - start_p at group ends. The cumsum's rounding
//     decides theta, so it follows one pinned order — rows of 16 summed left
//     to right, row totals scanned the same way, then added back (the order
//     XLA's CPU backend uses for cumsum) — which the twin in kernels/ref.py
//     reproduces op for op. The sort is by the unique key (doc, position):
//     docs bucketed by value (n buckets over [0, n_docs)) and ranked within
//     their bucket by compares, pads (doc == n_docs) after them in position
//     order (sort_by_doc). theta itself is the k-th largest total: a floor
//     that k totals reach (the k-th largest of the warps' largest) leaves a
//     few, ranked against each other;
//  3. keep(t, m) = valid(t, m) && (m == 0 || bound(t, m) * safety >= theta),
//     bound(t, m) = ub(t, m) + (sum_t' ub(t', 0) - ub(t, 0)), the sum taken
//     left to right; touched = sum of keep; the kept blocks t*M + m listed in
//     (t, m) order, and where each term's begin.
//
// pruned_count_kernel and pruned_scatter_kernel, one block per (query,
// term), a warp walking a kept block at a time:
//  4. the kept postings that are live (doc < n_docs) with tf != 0 go to a
//     bucket in device memory, grouped by range and, within a range, by term
//     in term order: the first kernel counts each term's postings a range,
//     the second works out where each (range, term) begins and scatters
//     (doc - range start, impact) there, 8 B an entry. Impacts as in step 1.
//     Where the T*P counts do not fit in one block's shared memory (64 terms
//     over ~50M docs and more), the count kernel's P-int histogram goes to
//     device memory if it too does not fit, pruned_starts_kernel (one block
//     a query) scans the counts into the (range, term) starts, and the
//     scatter takes its term's P cursors from there, in shared memory when
//     they fit, else as integer atomics in device memory. The order of the
//     entries inside one (range, term) bucket reaches no sum: a doc occurs
//     once per term, and step 5 adds term by term.
//
// pruned_range_kernel, one block per (query, range): block (q, p) owns docs
// [p*R, min((p + 1)*R, n_docs)) as R floats in shared memory.
//  5. It reads its bucket, RANGE_UNROLL entries a thread, then adds them one
//     term at a time, in term order with a barrier between terms. A doc
//     occurs at most once per term, so no two threads ever hit one address:
//     no float atomics, and every doc's sum is ((0 + x_t0) + x_t1) + ..., the
//     order of the reference's flat scatter-add. A bit per doc says whether
//     the slot holds a sum yet (set by an integer atomicOr; the first add
//     stores x, which is 0 + x). Pads, invalid, skipped and zero-impact
//     postings are skipped, never added as +0.0: invalid rows alias block 0
//     (bm25.py:94), and skipping is bitwise the same as adding +0.0 to a sum
//     that never is -0.0.
//  6. The range's top k under (value desc, doc asc), as the twin takes it
//     from the dense accumulator, where an untouched doc holds +0.0. Only a
//     touched doc or one of the first k untouched docs by id can be in it
//     (any later untouched one has k untouched ones, equal to it and lower
//     in id, ahead of it). A floor that k of those reach — the k-th largest
//     of the warps' largest keys — leaves a few; they are ranked against
//     each other by (key desc, doc asc). Too many above the floor, and
//     select.cuh's radix select runs over the whole slice from the floor.
//     Survivors go out in descending order; a range of fewer than k docs
//     pads with (-inf, n_docs).
//  7. The query's last range block to finish (a counter in device memory,
//     after a fence) merges the P*k survivors the same way: they lie in id
//     order, so ties still go to the lowest id. It reads their values into
//     its spent slice where they fit, else from device memory. (A merge by
//     K2's kernel cost a launch and its wrapper's host time, which made a
//     single query host-bound.)
//
// Bound on an H100: bytes. Per query it must read the kept postings (tf 1 B,
// dl 4 B, doc 4 B) and the per-block inputs, and write k results. What
// holds it back is latency, not bytes: theta is one block a query, its sort
// and scans chains of shared-memory steps, and each range block's walk has
// a barrier a term.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "select.cuh"

#define THETA_THREADS 1024
#define THETA_RANK 256        // totals at or above theta's floor ranked against each other
#define BUCKET_THREADS 256
#define BUCKET_UNROLL 4       // kept blocks a warp walks at a time
#define RANGE_THREADS 1024
#define RANGE_WARPS (RANGE_THREADS / 32)
#define RANGE_UNROLL 4        // bucket entries a thread holds per round
#define RANGE_RANK 256        // candidates a range ranks against each other
#define SCAN_ROW 16
#define MAX_SCAN_LEVELS 8
#define MAX_SMEM (227 * 1024)
#define RANGE_STATIC_SMEM 1024  // the range kernel's static shared memory, rounded up
#define THETA_STATIC_SMEM 1024  // the theta kernel's, rounded up

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

__host__ __device__ inline int scan_scratch_floats(int n) {
  int total = 0;
  while (n > SCAN_ROW) {
    n = (n + SCAN_ROW - 1) / SCAN_ROW;
    total += n;
  }
  return total;
}

// Exclusive prefix count, in position order, of flag(i) over i < n, by the
// whole block; writes it to out[i] where flag(i) holds. `wsum` holds a word
// a warp.
template <class Flag>
__device__ void block_prefix_count(Flag flag, int n, int* out, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool f = i < n && flag(i);
    const unsigned bal = __ballot_sync(SELECT_FULL, f);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int before = base, chunk = 0;
    for (int w = 0; w < nw; ++w) {
      before += w < warp ? wsum[w] : 0;
      chunk += wsum[w];
    }
    if (f) out[i] = before + __popc(bal & lt);
    base += chunk;
    __syncthreads();                             // wsum is read before it is reused
  }
}

// Exclusive prefix sum, in place, of a[0..n) in shared memory, by the whole
// block: each thread scans a run of neighbouring entries. `wsum` holds a
// word a warp.
__device__ void block_exclusive_scan(int* a, int n, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  int mine = 0;
  for (int j = lo; j < hi; ++j) mine += a[j];
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(SELECT_FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < nw ? wsum[lane] : 0;
    int y = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(SELECT_FULL, y, off);
      if (lane >= off) y += v;
    }
    if (lane < nw) wsum[lane] = y - x;
  }
  __syncthreads();
  int run = wsum[warp] + incl - mine;
  for (int j = lo; j < hi; ++j) {
    const int x = a[j];
    a[j] = run;
    run += x;
  }
  __syncthreads();
}

// The doc ids d[0..n) and their values v in the order of the unique keys
// (unsigned doc, position) — a stable sort by doc — as sd and sv. A doc below
// n_docs goes to one of n buckets by value and is ranked within it by
// compares (random ids put ~1 in a bucket, a doc of several terms a few);
// pads (doc == n_docs) follow, in position order; larger ids come last,
// ranked by compares. Scratch in shared memory: mem, aux (n ints each),
// hist (n + 2), wsum (a word a warp); a doc's bucket is worked out from its
// id where it is needed, by float steps that are each monotone, so a lower
// id never lands in a later bucket. A merge sort of the 64-bit keys (warp
// runs merged by binary search) took 1.8x as long on an H100: its
// searches' shared-memory loads conflict.
__device__ void sort_by_doc(const int* d, const float* v, int n, int n_docs, int* mem, int* aux,
                            int* hist, int* wsum, int* sd, float* sv) {
  const int NB = n, PAD = n, REST = n + 1;
  const int lane = threadIdx.x & 31;
  const float scale = (float)NB / (float)n_docs;
  __shared__ int n_pad, n_rest;
  auto bucket = [&](int i) {
    const unsigned u = (unsigned)d[i];
    if (u == (unsigned)n_docs) return PAD;
    if (u > (unsigned)n_docs) return REST;
    return min(__float2int_rz(__fmul_rn(__uint2float_rn(u), scale)), NB - 1);
  };
  for (int i = threadIdx.x; i < NB + 2; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {   // counts; the pads counted a warp at a time
    const int i = i0 + threadIdx.x;
    int b = -1;
    if (i < n) {
      b = bucket(i);
      if (b != PAD) atomicAdd(&hist[b], 1);
    }
    const unsigned pads = __ballot_sync(SELECT_FULL, b == PAD);
    if (lane == 0 && pads) atomicAdd(&hist[PAD], __popc(pads));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_pad = hist[PAD];
    n_rest = hist[REST];
  }
  block_exclusive_scan(hist, NB + 2, wsum);      // bucket starts
  block_prefix_count([&](int i) { return bucket(i) == PAD; }, n, aux, wsum);  // pads' places
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int b = bucket(i);
    if (b != PAD) mem[atomicAdd(&hist[b], 1)] = i;
  }
  __syncthreads();
  // hist[b] is now the end of bucket b, so the start of b + 1, for b < NB
  const int pad0 = n - n_rest - n_pad;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int b = bucket(i);
    int pos;
    if (b == PAD) {
      pos = pad0 + aux[i];
    } else {
      const int s0 = b == REST ? n - n_rest : b > 0 ? hist[b - 1] : 0;
      const int s1 = b == REST ? n : hist[b];
      const unsigned u = (unsigned)d[i];
      int r = 0;
      for (int m = s0; m < s1; ++m) {
        const int o = mem[m];
        const unsigned uo = (unsigned)d[o];
        r += uo < u || (uo == u && o < i);
      }
      pos = s0 + r;
    }
    sd[pos] = d[i];
    sv[pos] = v[i];
  }
  __syncthreads();
}

// Dynamic shared memory of the theta kernel: the select's scratch, then two
// regions of ints. The first holds three arrays of L (impacts and c, sv,
// sd) and, once the totals are out, the select's candidates and survivors;
// the second holds the sort's input doc ids and its scratch (4 L + 2), then
// start_p and the totals (L) and the scan's row totals.
__host__ __device__ inline long long theta_first_ints(int L, int k) {
  const long long sel = 2LL * (THETA_RANK + (k < L ? k : L));
  return 3LL * L > sel ? 3LL * L : sel;
}
__host__ __device__ inline long long theta_smem(int T, int B, int k) {
  const int L = T * B;
  return (long long)sizeof(SelectScratch<THETA_THREADS>) + 4LL * theta_first_ints(L, k) +
         4LL * (4LL * L + 2);
}

// Inputs are (Q, T, M, B) postings (tf u8, dl f32, docs i32), idf_q (Q, T),
// ub and valid (Q, T, M). Writes touched[q], query q's kept blocks t*M + m
// in (t, m) order to kept[q*T*M ..], and term_start[q*(T + 1) + t], the
// index in that list of term t's first kept block (T + 1 entries).
__global__ void __launch_bounds__(THETA_THREADS)
pruned_theta_kernel(const uint8_t* __restrict__ tf, const float* __restrict__ dl,
                    const int* __restrict__ docs, const float* __restrict__ idf_q,
                    const float* __restrict__ ub, const uint8_t* __restrict__ valid,
                    int* __restrict__ touched, int* __restrict__ kept,
                    int* __restrict__ term_start, int* __restrict__ done, int T, int M, int B,
                    int k, int n_docs, float k1, float b, float avgdl, float safety) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = T * B, TM = T * M;
  auto* sc = reinterpret_cast<SelectScratch<THETA_THREADS>*>(smem);
  float* vals = reinterpret_cast<float*>(sc + 1);  // L: impacts, then c
  float* sv = vals + L;                        // L: impacts in doc order
  int* sd = (int*)(sv + L);                    // L: doc ids in sorted order
  uint2* cand = reinterpret_cast<uint2*>(vals);  // THETA_RANK, once the totals are out
  uint2* surv = cand + THETA_RANK;             // min(k, L)
  int* fd = (int*)(vals + theta_first_ints(L, k));  // L: doc ids by position
  int* mem = fd + L;                           // 2 L + L + 2: the sort's scratch
  int* aux = mem + L;
  int* hist = aux + L;
  float* mx = (float*)fd;                      // L, after the sort: start_p, then totals
  float* scratch = mx + L;                     // after the sort: the scan's row totals
  __shared__ float theta_s, first_sum_s;
  __shared__ int wsum[THETA_THREADS / 32];
  __shared__ unsigned wmax[THETA_THREADS / 32];
  __shared__ int n_cand;

  const long long q = blockIdx.x;
  const long long PB = (long long)T * M * B;
  const uint8_t* tfq = tf + q * PB;
  const float* dlq = dl + q * PB;
  const int* dq = docs + q * PB;
  const float* iq = idf_q + q * T;
  const float* ubq = ub + q * TM;
  const uint8_t* vq = valid + q * TM;
  const float omb = 1.0f - b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. first-block impacts, by position
  for (int i = tid; i < L; i += blockDim.x) {
    const int t = i / B;
    const long long p = (long long)t * M * B + (i % B);
    const int d = dq[p];
    const float imp = bm25_impact((float)tfq[p], dlq[p], iq[t], k1, b, omb, avgdl);
    vals[i] = d < n_docs ? imp : 0.0f;
    fd[i] = d;
  }
  if (tid < T) sv[tid] = ubq[(long long)tid * M];  // sv is free until the sort
  __syncthreads();
  if (tid == 0) {
    float s = sv[0];
    for (int t = 1; t < T; ++t) s = s + sv[t];
    first_sum_s = s;
    theta_s = 0.0f;
    n_cand = 0;
  }

  // 2. theta
  if (L >= k) {
    sort_by_doc(fd, vals, L, n_docs, mem, aux, hist, wsum, sd, sv);
    for (int j = tid; j < L; j += blockDim.x) vals[j] = sv[j];
    __syncthreads();
    scan_rows(vals, L, scratch, AddOp());            // c
    for (int j = tid; j < L; j += blockDim.x) {
      const bool is_start = j == 0 || sd[j] != sd[j - 1];
      mx[j] = is_start ? vals[j] - sv[j] : -INFINITY;  // p = c - v at starts
    }
    __syncthreads();
    scan_rows(mx, L, scratch, MaxOp());              // start_p
    for (int j = tid; j < L; j += blockDim.x) {      // totals, in place
      const bool is_end = j == L - 1 || sd[j] != sd[j + 1];
      mx[j] = (is_end && sd[j] < n_docs) ? vals[j] - mx[j] : 0.0f;
    }
    // theta = the k-th largest total: a floor that k totals reach — the
    // k-th largest of the warps' largest keys — leaves a few, ranked against
    // each other; select.cuh's radix select when more than THETA_RANK reach
    // it. The candidates and survivors take the place of vals, sv and sd,
    // which are spent after the barrier below.
    unsigned mk = 0u;
    for (int j = tid; j < L; j += blockDim.x) mk = max(mk, order_key(mx[j]));
    mk = __reduce_max_sync(SELECT_FULL, mk);
    if (lane == 0) wmax[warp] = mk;
    __syncthreads();
    unsigned floor_key = 0u;
    if (k <= THETA_THREADS / 32) {
      const unsigned mine_max = wmax[lane];
      int r = 0;
      for (int j = 0; j < 32; ++j) {
        const unsigned o = __shfl_sync(SELECT_FULL, mine_max, j);
        r += o > mine_max || (o == mine_max && j < lane);
      }
      const unsigned at = __ballot_sync(SELECT_FULL, r == k - 1);
      floor_key = __shfl_sync(SELECT_FULL, mine_max, __ffs(at) - 1);
    }
    for (int j = tid; j < L; j += blockDim.x) {
      const unsigned key = order_key(mx[j]);
      if (key >= floor_key) {
        const int at = atomicAdd(&n_cand, 1);
        if (at < THETA_RANK) cand[at] = make_uint2(key, (unsigned)j);
      }
    }
    __syncthreads();
    auto take = [&](int r, int j) {
      if (r == k - 1) theta_s = mx[j];
    };
    if (n_cand <= THETA_RANK) {
      rank_emit<THETA_THREADS>(cand, n_cand, tid, take);
    } else {
      select_topk<THETA_THREADS>([&](int j) { return order_key(mx[j]); }, L, k, floor_key, tid,
                                 sc, surv, take);
    }
    __syncthreads();
  }
  __syncthreads();
  const float theta = theta_s;

  // 3. keep mask, the kept blocks in (t, m) order, touched, and where each
  // term's kept blocks begin
  const float first_sum = first_sum_s;
  const unsigned lt = (1u << lane) - 1u;
  int* kq = kept + q * TM;
  int nk = 0;
  for (int i0 = 0; i0 < TM; i0 += blockDim.x) {
    const int i = i0 + tid;
    bool kp = false;
    if (i < TM) {
      const int t = i / M, m = i - t * M;
      const float bound = ubq[i] + (first_sum - ubq[(long long)t * M]);
      kp = vq[i] != 0 && (m == 0 || bound * safety >= theta);
    }
    const unsigned bal = __ballot_sync(SELECT_FULL, kp);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int before = nk, chunk = 0;
    for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
      before += w < warp ? wsum[w] : 0;
      chunk += wsum[w];
    }
    if (kp) kq[before + __popc(bal & lt)] = i;
    nk += chunk;
    __syncthreads();                             // wsum is read, kq written, before either is used
  }
  if (tid == 0) {
    touched[q] = nk;
    done[q] = 0;                                 // the range blocks' count, for the merge
  }
  for (int t = tid; t <= T; t += blockDim.x) {   // the first kept block of term t or later
    int a = 0, z = nk;
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (kq[mid] < t * M) a = mid + 1; else z = mid;
    }
    term_start[q * (T + 1) + t] = a;
  }
}

// p = d / R, by a float quotient corrected to the exact one.
__device__ __forceinline__ int range_of(int d, int R, float inv_r) {
  int p = __float2int_rz((float)d * inv_r);
  p -= p * R > d;
  p += (p + 1) * R <= d;
  return p;
}

// Calls visit(doc, posting index) for every kept, live, non-zero-tf posting
// of term t of query q: a warp takes BUCKET_UNROLL kept blocks at a time, a
// lane every 32nd posting of each.
template <class Visit>
__device__ __forceinline__ void walk_term(const uint8_t* tfq, const int* dq, const int* kq,
                                          int kb_begin, int kb_end, int B, int n_docs,
                                          Visit visit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kb0 = kb_begin + warp * BUCKET_UNROLL; kb0 < kb_end;
       kb0 += BUCKET_THREADS / 32 * BUCKET_UNROLL) {
#pragma unroll 4
    for (int l = lane; l < B; l += 32) {
      int d[BUCKET_UNROLL];
      uint8_t f[BUCKET_UNROLL];
      long long at[BUCKET_UNROLL];
#pragma unroll
      for (int u = 0; u < BUCKET_UNROLL; ++u) {
        d[u] = -1;
        if (kb0 + u < kb_end) {
          at[u] = (long long)kq[kb0 + u] * B + l;
          d[u] = dq[at[u]];
          f[u] = tfq[at[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < BUCKET_UNROLL; ++u)
        if ((unsigned)d[u] < (unsigned)n_docs && f[u] != 0) visit(d[u], at[u]);
    }
  }
}

// Block q*T + t: how many of term t's kept, live, non-zero-tf postings of
// query q fall in each range: counts[(q*T + t)*P + p]. SMEM: the histogram
// in shared memory (P ints), else integer atomics on counts itself.
template <bool SMEM>
__global__ void __launch_bounds__(BUCKET_THREADS)
pruned_count_kernel(const uint8_t* __restrict__ tf, const int* __restrict__ docs,
                    const int* __restrict__ kept, const int* __restrict__ term_start,
                    int* __restrict__ counts, int T, int M, int B, int n_docs, int R, int P) {
  extern __shared__ int hist_smem[];             // P, when SMEM
  const long long q = blockIdx.x / T;
  const int t = (int)(blockIdx.x - q * T);
  const long long PB = (long long)T * M * B;
  const int* ts = term_start + q * (T + 1);
  int* row = counts + ((long long)q * T + t) * P;
  int* hist = SMEM ? hist_smem : row;
  for (int p = threadIdx.x; p < P; p += BUCKET_THREADS) hist[p] = 0;
  __syncthreads();
  const float inv_r = 1.0f / (float)R;
  walk_term(tf + q * PB, docs + q * PB, kept + q * T * M, ts[t], ts[t + 1], B, n_docs,
            [&](int d, long long) { atomicAdd(&hist[range_of(d, R, inv_r)], 1); });
  if (SMEM) {
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += BUCKET_THREADS) row[p] = hist[p];
  }
}

// Term t's kept, live, non-zero-tf postings of query q into the bucket, each
// (doc - p*R, impact) at the cursor cur[p] of its range p (an atomicAdd).
__device__ __forceinline__ void scatter_term(const uint8_t* tf, const float* dl, const int* docs,
                                             const float* idf_q, const int* kept,
                                             const int* term_start, uint2* bucket, int* cur,
                                             long long q, int t, int T, int M, int B, int n_docs,
                                             int R, float k1, float b, float avgdl) {
  const long long PB = (long long)T * M * B;
  const float inv_r = 1.0f / (float)R, omb = 1.0f - b, idf = idf_q[q * T + t];
  const uint8_t* tfq = tf + q * PB;
  const float* dlq = dl + q * PB;
  uint2* bq = bucket + q * PB;
  walk_term(tfq, docs + q * PB, kept + q * T * M, term_start[q * (T + 1) + t],
            term_start[q * (T + 1) + t + 1], B, n_docs, [&](int d, long long at) {
              const float imp = bm25_impact((float)tfq[at], dlq[at], idf, k1, b, omb, avgdl);
              const int p = range_of(d, R, inv_r);
              bq[atomicAdd(&cur[p], 1)] = make_uint2((unsigned)(d - p * R), __float_as_uint(imp));
            });
}

// Block q*T + t: term t's postings of query q into the bucket, grouped by
// range and, within a range, by term: entry (doc - p*R, posting index) at
// bucket[q*T*M*B + start(p, t) ..]. start(p, t) = the postings of ranges
// before p, plus those of terms before t in range p; block t = 0 writes
// them all to starts[q*(P*T + 1) + p*T + t], and the total last.
__global__ void __launch_bounds__(BUCKET_THREADS)
pruned_scatter_kernel(const uint8_t* __restrict__ tf, const float* __restrict__ dl,
                      const int* __restrict__ docs, const float* __restrict__ idf_q,
                      const int* __restrict__ kept, const int* __restrict__ term_start,
                      const int* __restrict__ counts, uint2* __restrict__ bucket,
                      int* __restrict__ starts, int T, int M, int B, int n_docs, int R, int P,
                      float k1, float b, float avgdl) {
  extern __shared__ int sm[];
  int* c = sm;                                   // T*P counts, c[t*P + p]
  int* base = c + T * P;                         // P + 1: postings of the ranges before p
  int* cur = base + P + 1;                       // P: this term's cursors
  const long long q = blockIdx.x / T;
  const int t = (int)(blockIdx.x - q * T);
  const int PT = P * T;
  for (int i = threadIdx.x; i < PT; i += BUCKET_THREADS) c[i] = counts[q * PT + i];
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += BUCKET_THREADS) {
    int sum = 0;
    for (int u = 0; u < T; ++u) sum += c[u * P + p];
    base[p + 1] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    base[0] = 0;
    for (int p = 0; p < P; ++p) base[p + 1] += base[p];
  }
  __syncthreads();
  auto start = [&](int p, int tt) {
    int s = base[p];
    for (int u = 0; u < tt; ++u) s += c[u * P + p];
    return s;
  };
  for (int p = threadIdx.x; p < P; p += BUCKET_THREADS) cur[p] = start(p, t);
  if (t == 0) {
    int* st = starts + q * (PT + 1);
    for (int i = threadIdx.x; i < PT; i += BUCKET_THREADS) st[i] = start(i / T, i % T);
    if (threadIdx.x == 0) st[PT] = base[P];
  }
  __syncthreads();
  scatter_term(tf, dl, docs, idf_q, kept, term_start, bucket, cur, q, t, T, M, B, n_docs, R, k1,
               b, avgdl);
}

// Block q, where the scatter cannot hold query q's T*P counts: starts[q*(P*T
// + 1) + p*T + t] = the postings of the ranges before p plus those of the
// terms before t in range p, the total at P*T, as pruned_scatter_kernel
// computes them; the same start also replaces counts[(q*T + t)*P + p], as
// the scatter's cursor. A thread owns one range p of each round of
// BUCKET_THREADS ranges: its T counts (reads coalesced across threads), a
// block-wide exclusive scan of the ranges' totals, then its starts.
__global__ void __launch_bounds__(BUCKET_THREADS)
pruned_starts_kernel(int* __restrict__ counts, int* __restrict__ starts, int T, int P) {
  __shared__ int wsum[BUCKET_THREADS / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q = blockIdx.x;
  int* c = counts + q * T * (long long)P;
  int* st = starts + q * ((long long)P * T + 1);
  if (tid == 0) carry = 0;
  for (int p0 = 0; p0 < P; p0 += BUCKET_THREADS) {
    const int p = p0 + tid;
    int total = 0;
    if (p < P)
      for (int t = 0; t < T; ++t) total += c[(long long)t * P + p];
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(SELECT_FULL, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();                             // wsum written, carry set
    if (warp == 0) {
      int w = lane < BUCKET_THREADS / 32 ? wsum[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(SELECT_FULL, w, off);
        if (lane >= off) w += v;
      }
      if (lane < BUCKET_THREADS / 32) wsum[lane] = w;
    }
    __syncthreads();
    if (p < P) {
      int s = carry + (warp ? wsum[warp - 1] : 0) + incl - total;
      for (int t = 0; t < T; ++t) {
        const long long at = (long long)t * P + p;
        const int n = c[at];
        st[(long long)p * T + t] = s;
        c[at] = s;
        s += n;
      }
    }
    __syncthreads();                             // carry and wsum read
    if (tid == 0) carry += wsum[BUCKET_THREADS / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) st[(long long)P * T] = carry;
}

// Block q*T + t, after pruned_starts_kernel: term t's postings of query q
// into the bucket, as pruned_scatter_kernel puts them, from the cursors
// counts[(q*T + t)*P + p]. SMEM: the P cursors copied to shared memory, else
// integer atomics on counts itself.
template <bool SMEM>
__global__ void __launch_bounds__(BUCKET_THREADS)
pruned_scatter_wide_kernel(const uint8_t* __restrict__ tf, const float* __restrict__ dl,
                           const int* __restrict__ docs, const float* __restrict__ idf_q,
                           const int* __restrict__ kept, const int* __restrict__ term_start,
                           int* __restrict__ counts, uint2* __restrict__ bucket, int T, int M,
                           int B, int n_docs, int R, int P, float k1, float b, float avgdl) {
  extern __shared__ int cur_smem[];              // P, when SMEM
  const long long q = blockIdx.x / T;
  const int t = (int)(blockIdx.x - q * T);
  int* row = counts + ((long long)q * T + t) * P;
  int* cur = SMEM ? cur_smem : row;
  if (SMEM) {
    for (int p = threadIdx.x; p < P; p += BUCKET_THREADS) cur_smem[p] = row[p];
    __syncthreads();
  }
  scatter_term(tf, dl, docs, idf_q, kept, term_start, bucket, cur, q, t, T, M, B, n_docs, R, k1,
               b, avgdl);
}

// Dynamic shared memory of a range block that owns R docs.
__host__ __device__ inline long long range_smem(int T, int k, int R) {
  return (long long)sizeof(SelectScratch<RANGE_THREADS>) + 8LL * k + 8LL * RANGE_RANK +
         4LL * (T + 1) + (long long)R / 8 + 4LL * R;
}

// Block q*P + p: query q's docs [p*R, min(p*R + R, n_docs)), from its bucket.
// Writes k survivors (descending, ties to the lowest id) to
// out_*[(q*P + p)*k ..].
__global__ void __launch_bounds__(RANGE_THREADS, 1)
pruned_range_kernel(const uint2* __restrict__ bucket, const int* __restrict__ starts,
                    float* __restrict__ surv_vals, int* __restrict__ surv_ids,
                    int* __restrict__ done, float* __restrict__ out_vals,
                    int* __restrict__ out_ids, int T, int M, int B, int R, int P, int k,
                    int n_docs) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* sc = reinterpret_cast<SelectScratch<RANGE_THREADS>*>(smem);
  uint2* surv = reinterpret_cast<uint2*>(sc + 1);                   // k
  uint2* cand = surv + k;                                           // RANGE_RANK
  int* ts = reinterpret_cast<int*>(cand + RANGE_RANK);              // T + 1 term starts
  unsigned* bits = reinterpret_cast<unsigned*>(ts + T + 1);         // R / 32: slot holds a sum
  float* acc = reinterpret_cast<float*>(bits + R / 32);             // R
  __shared__ unsigned wmax[RANGE_WARPS];
  __shared__ int n_touched, n_cand, last;

  const long long q = blockIdx.x / P;
  const int p = (int)(blockIdx.x - q * P);
  const int lo = p * R;
  const int n = min(R, n_docs - lo);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* st = starts + q * ((long long)P * T + 1) + (long long)p * T;
  const int first = st[0];
  const int count = st[T] - first;
  const uint2* bq = bucket + q * ((long long)T * M * B) + first;
  const int n_words = (n + 31) / 32;

  for (int i = tid; i < n_words; i += RANGE_THREADS) bits[i] = 0u;
  for (int t = tid; t <= T; t += RANGE_THREADS) ts[t] = st[t] - first;
  if (tid == 0) {
    n_touched = 0;
    n_cand = 0;
  }
  __syncthreads();

  // 5. a round of RANGE_UNROLL entries a thread — entry c0 + u*RANGE_THREADS
  // + tid — then the round's terms in order, a barrier after each term that
  // has entries here. Entry u of every thread lies in window u of the round,
  // so a term visits only the windows that overlap it. The bits are read
  // plainly (earlier terms set them before a barrier) and set with an
  // atomicOr whose result is unused.
  auto term_of = [&](int i) {                    // the t with ts[t] <= i < ts[t + 1]
    int a = 0, z = T;
    while (z - a > 1) {
      const int mid = (a + z) >> 1;
      if (ts[mid] <= i) a = mid; else z = mid;
    }
    return a;
  };
  for (int c0 = 0; c0 < count; c0 += RANGE_THREADS * RANGE_UNROLL) {
    int slot[RANGE_UNROLL];
    float imp[RANGE_UNROLL];
#pragma unroll
    for (int u = 0; u < RANGE_UNROLL; ++u) {
      const int i = c0 + u * RANGE_THREADS + tid;
      slot[u] = -1;
      if (i < count) {
        const uint2 e = bq[i];
        imp[u] = __uint_as_float(e.y);
        if (imp[u] != 0.0f) slot[u] = (int)e.x;
      }
    }
    const int end = min(c0 + RANGE_THREADS * RANGE_UNROLL, count);
    for (int t = term_of(c0); t < T && ts[t] < end; ++t) {
      const int lo_t = max(ts[t], c0), hi_t = min(ts[t + 1], end);   // this term's entries
      if (lo_t >= hi_t) continue;
#pragma unroll
      for (int u = 0; u < RANGE_UNROLL; ++u) {
        const int i = c0 + u * RANGE_THREADS + tid;
        if (c0 + (u + 1) * RANGE_THREADS > lo_t && c0 + u * RANGE_THREADS < hi_t &&
            i >= lo_t && i < hi_t && slot[u] >= 0) {
          const int j = slot[u];
          const unsigned bit = 1u << (j & 31);
          const bool seen = bits[j >> 5] & bit;
          atomicOr(&bits[j >> 5], bit);
          acc[j] = seen ? acc[j] + imp[u] : imp[u];
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // 6. The range's top k. Thread tid owns words [w0, w1) of the bits. The
  // candidates are the touched docs and the first kz untouched ones (+0.0).
  // A floor that k candidates reach — the k-th largest of the warps'
  // largest keys, when k <= RANGE_WARPS, else 0 — leaves a few; they are
  // gathered in any order, each with its doc, and ranked against each other
  // by (key desc, doc asc). More than RANGE_RANK of them, and select.cuh's
  // radix select runs over the whole slice, from the floor.
  const int per = (n_words + RANGE_THREADS - 1) / RANGE_THREADS;
  const int w0 = min(tid * per, n_words), w1 = min(w0 + per, n_words);
  auto word_mask = [&](int w) {
    return 32 * w + 32 <= n ? SELECT_FULL : (1u << (n - 32 * w)) - 1u;
  };
  const unsigned key0 = order_key(0.0f);
  int mine = 0;
  unsigned mk = 0u;
  for (int w = w0; w < w1; ++w) {
    const unsigned set = bits[w] & word_mask(w);
    mine += __popc(set);
    for (unsigned x = set; x; x &= x - 1) mk = max(mk, order_key(acc[32 * w + __ffs(x) - 1]));
  }
  mine = __reduce_add_sync(SELECT_FULL, mine);
  mk = __reduce_max_sync(SELECT_FULL, mk);
  if (lane == 0) {
    wmax[warp] = mk;
    atomicAdd(&n_touched, mine);
  }
  __syncthreads();
  const int kz = min(k, n - n_touched);          // untouched candidates
  const int kk = min(k, n);                      // survivors this range has
  unsigned floor_key = 0u;
  if (k <= RANGE_WARPS) {                        // the k-th largest warp maximum
    const unsigned mine_max = lane < RANGE_WARPS ? wmax[lane] : 0u;
    int r = 0;
    for (int j = 0; j < 32; ++j) {
      const unsigned o = __shfl_sync(SELECT_FULL, mine_max, j);
      r += j < RANGE_WARPS && (o > mine_max || (o == mine_max && j < lane));
    }
    const unsigned at = __ballot_sync(SELECT_FULL, lane < RANGE_WARPS && r == k - 1);
    floor_key = __shfl_sync(SELECT_FULL, mine_max, __ffs(at) - 1);
  }
  auto gather = [&](unsigned key, int j) {
    const int at = atomicAdd(&n_cand, 1);
    if (at < RANGE_RANK) cand[at] = make_uint2(key, (unsigned)j);
  };
  for (int w = w0; w < w1; ++w) {
    const unsigned set = bits[w] & word_mask(w);
    for (unsigned x = set; x; x &= x - 1) {
      const int j = 32 * w + __ffs(x) - 1;
      const unsigned key = order_key(acc[j]);
      if (key >= floor_key) gather(key, j);
    }
  }
  if (warp == 0 && kz > 0 && key0 >= floor_key) {  // the first kz untouched docs
    int need = kz;
    for (int w = lane; need > 0 && w - lane < n_words; w += 32) {
      const unsigned z = w < n_words ? word_mask(w) & ~bits[w] : 0u;
      const int c = __popc(z);
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(SELECT_FULL, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned x = z;
      for (int take = min(c, need - (incl - c)); take > 0; --take, x &= x - 1)
        gather(key0, 32 * w + __ffs(x) - 1);
      need -= __shfl_sync(SELECT_FULL, incl, 31);
    }
  }
  __syncthreads();
  const int nc = n_cand;
  float* ov = surv_vals + (q * P + p) * (long long)k;
  int* oi = surv_ids + (q * P + p) * (long long)k;
  auto touched_slot = [&](int j) { return (bits[j >> 5] >> (j & 31)) & 1u; };
  auto emit = [&](int r, int j) {
    ov[r] = touched_slot(j) ? acc[j] : 0.0f;
    oi[r] = lo + j;
  };
  if (nc <= RANGE_RANK) {
    rank_emit<RANGE_THREADS>(cand, nc, tid, [&](int r, int j) {
      if (r < kk) emit(r, j);
    });
  } else {
    select_topk<RANGE_THREADS>(
        [&](int j) { return touched_slot(j) ? order_key(acc[j]) : key0; }, n, kk, floor_key,
        tid, sc, surv, emit);
  }
  for (int r = kk + tid; r < k; r += RANGE_THREADS) {
    ov[r] = -INFINITY;
    oi[r] = n_docs;
  }

  // 7. The query's last range block to finish merges the P*k survivors. They
  // lie in id order — ranges in order, each range's in (value desc, id asc)
  // — so the lowest position among equal values is the lowest id. Their
  // values are read into the spent slice where they fit, else from device
  // memory.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&done[q], 1) == P - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_all = P * k;
  const float* sv = surv_vals + q * (long long)n_all;
  const int* si = surv_ids + q * (long long)n_all;
  const bool in_slice = n_all <= R;
  if (in_slice)
    for (int i = tid; i < n_all; i += RANGE_THREADS) acc[i] = __ldcg(sv + i);
  __syncthreads();
  auto val = [&](int i) { return in_slice ? acc[i] : __ldcg(sv + i); };
  auto put = [&](int r, int i) {
    out_vals[q * k + r] = val(i);
    out_ids[q * k + r] = __ldcg(si + i);
  };
  if (n_all <= RANGE_RANK) {
    for (int i = tid; i < n_all; i += RANGE_THREADS) cand[i] = make_uint2(order_key(val(i)), i);
    __syncthreads();
    rank_emit<RANGE_THREADS>(cand, n_all, tid, [&](int r, int i) {
      if (r < k) put(r, i);
    });
  } else {
    select_topk<RANGE_THREADS>([&](int i) { return order_key(val(i)); }, n_all, k, 0u, tid, sc,
                               surv, put);
  }
}

// Shared memory the theta kernel needs for T*B first-block postings and k,
// its static shared memory included.
REPRO_EXPORT long long bm25_pruned_theta_smem_bytes(int T, int B, int k) {
  return theta_smem(T, B, k) + THETA_STATIC_SMEM;
}

// Shared memory pruned_scatter_kernel needs for T terms and P ranges.
static long long scatter_smem(int T, int P) { return 4LL * ((long long)T * P + 2LL * P + 1); }

// Docs a range block owns: the most that fit in one block's shared memory
// beside T term starts and k survivors, a multiple of 32 (0 if none fit).
REPRO_EXPORT int bm25_pruned_range_docs(int T, int k) {
  const long long avail = MAX_SMEM - RANGE_STATIC_SMEM - range_smem(T, k, 0);
  if (avail <= 0) return 0;
  return (int)(avail * 8 / 33 / 32 * 32);        // 4 B + 1 bit a doc
}

// Every kernel may take all the shared memory a block can have beside its
// static shared memory: set once.
static cudaError_t allow_smem() {
  static const cudaError_t err = [] {
    const void* kernels[] = {(const void*)pruned_theta_kernel,
                             (const void*)pruned_count_kernel<true>,
                             (const void*)pruned_scatter_kernel,
                             (const void*)pruned_scatter_wide_kernel<true>,
                             (const void*)pruned_range_kernel};
    for (const void* f : kernels) {
      cudaFuncAttributes a;
      cudaError_t e = cudaFuncGetAttributes(&a, f);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SMEM - (int)a.sharedSizeBytes);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return err;
}

// Scratch: kept (Q, T*M) i32, term_start (Q, T + 1) i32, counts (Q, T, P)
// i32, bucket (Q, T*M*B) uint2, starts (Q, P*T + 1) i32, survivors (Q, P*k)
// f32 and i32, done (Q,) i32. Outputs: touched (Q,) i32, out_vals / out_ids
// (Q, k). R docs a range, P = ceil(n_docs / R). The count and scatter
// kernels keep their counts or cursors in shared memory only where they
// take at most smem_budget bytes (the wrapper passes all a block can have).
REPRO_EXPORT int bm25_pruned_launch(const void* tf, const void* dl, const void* docs,
                                    const void* idf_q, const void* ub, const void* valid,
                                    void* kept, void* term_start, void* counts, void* bucket,
                                    void* starts, void* surv_vals, void* surv_ids, void* done,
                                    void* touched, void* out_vals, void* out_ids, int Q, int T,
                                    int M, int B, int k, int n_docs, int R, int smem_budget,
                                    float k1, float b, float avgdl, float safety,
                                    void* stream) {
  if (Q <= 0) return 0;
  if (R <= 0 || R % 32 != 0 || k <= 0 || n_docs <= 0) return (int)cudaErrorInvalidValue;
  const int P = (n_docs + R - 1) / R;
  if ((long long)P * k > INT_MAX || (long long)P * T >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned qt = (unsigned)((long long)Q * T);
  pruned_theta_kernel<<<Q, THETA_THREADS, (size_t)theta_smem(T, B, k), s>>>(
      (const uint8_t*)tf, (const float*)dl, (const int*)docs, (const float*)idf_q,
      (const float*)ub, (const uint8_t*)valid, (int*)touched, (int*)kept, (int*)term_start,
      (int*)done, T, M, B, k, n_docs, k1, b, avgdl, safety);
  // the count and scatter kernels have no static shared memory
  const long long budget = smem_budget < MAX_SMEM ? smem_budget : MAX_SMEM;
  const bool hist_smem = 4LL * P <= budget;      // the count's histogram, the wide scatter's cursors
  if (hist_smem)
    pruned_count_kernel<true><<<qt, BUCKET_THREADS, 4 * (size_t)P, s>>>(
        (const uint8_t*)tf, (const int*)docs, (const int*)kept, (const int*)term_start,
        (int*)counts, T, M, B, n_docs, R, P);
  else
    pruned_count_kernel<false><<<qt, BUCKET_THREADS, 0, s>>>(
        (const uint8_t*)tf, (const int*)docs, (const int*)kept, (const int*)term_start,
        (int*)counts, T, M, B, n_docs, R, P);
  if (scatter_smem(T, P) <= budget) {
    pruned_scatter_kernel<<<qt, BUCKET_THREADS, (size_t)scatter_smem(T, P), s>>>(
        (const uint8_t*)tf, (const float*)dl, (const int*)docs, (const float*)idf_q,
        (const int*)kept, (const int*)term_start, (const int*)counts, (uint2*)bucket,
        (int*)starts, T, M, B, n_docs, R, P, k1, b, avgdl);
  } else {
    pruned_starts_kernel<<<Q, BUCKET_THREADS, 0, s>>>((int*)counts, (int*)starts, T, P);
    if (hist_smem)
      pruned_scatter_wide_kernel<true><<<qt, BUCKET_THREADS, 4 * (size_t)P, s>>>(
          (const uint8_t*)tf, (const float*)dl, (const int*)docs, (const float*)idf_q,
          (const int*)kept, (const int*)term_start, (int*)counts, (uint2*)bucket, T, M, B,
          n_docs, R, P, k1, b, avgdl);
    else
      pruned_scatter_wide_kernel<false><<<qt, BUCKET_THREADS, 0, s>>>(
          (const uint8_t*)tf, (const float*)dl, (const int*)docs, (const float*)idf_q,
          (const int*)kept, (const int*)term_start, (int*)counts, (uint2*)bucket, T, M, B,
          n_docs, R, P, k1, b, avgdl);
  }
  pruned_range_kernel<<<(unsigned)((long long)Q * P), RANGE_THREADS,
                        (size_t)range_smem(T, k, R), s>>>(
      (const uint2*)bucket, (const int*)starts, (float*)surv_vals, (int*)surv_ids, (int*)done,
      (float*)out_vals, (int*)out_ids, T, M, B, R, P, k, n_docs);
  return (int)cudaGetLastError();
}
