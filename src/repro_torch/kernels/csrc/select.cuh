// The top-k select shared by K2 (topk.cu) and K4 (dot_topk.cu): a radix
// select over order-preserving 32-bit keys, run by a group of NT threads (a
// whole block in K2, one warp in K4) on the keys key_at(0..n) of n floats
// in shared memory.
//
// Contract: the k largest of the n (1 <= k <= n) under the total order
// (value desc, position asc), handed to `emit(rank, position)` with rank
// 0..k-1 in that order. The set is unique, so any way of finding it gives
// the bits of the twin's stable descending sort (ref.topk_ref).
//
// Keys: a float's bits b become b ^ 0x80000000 when b's sign is clear and
// ~b when it is set, so that key order is float order; -0.0 is first mapped
// to +0.0, so the two zeros tie and go by position, as in the twin's sort.
// The caller writes the value from its own array, never one rebuilt from the
// key, so a -0.0 comes back as -0.0. NaN lies outside the contract: a NaN
// with its sign clear keys above +inf and one with its sign set below -inf,
// where the twin sorts every NaN first.
//
// Steps:
//  0. (optional) A floor: a key that at least k elements reach, so that the
//     passes below may skip every element under it. K2 takes the k-th
//     largest of its threads' maxima (two passes of step 1 over them); a
//     row of logits then leaves ~2 % of its chunk above the floor.
//  1. Up to four passes of 8 bits from the top: a histogram of the next
//     digit over the elements at or above the floor whose higher bits
//     equal the prefix found so far, then a scan of the 256 bins from the
//     top for the digit that holds rank `need`. A warp whose participants
//     share one digit — the BM25 accumulator's run of 0.0, a logit row's few
//     exponents — adds them with one shared-memory atomic (redux.sync finds
//     that out); the others add one each.
//     A pass ends the select early when its bin is taken whole (its count
//     equals the rank still needed), and jumps to the last when all the
//     pass's participants hold one key (a run of ties).
//  2. Survivors: every element above the prefix, then the first `need` equal
//     to it in position order (a warp-contiguous sweep: ballots within a
//     warp, the warps' counts summed in warp order). When the bin is taken
//     whole, order does not matter and the equal ones go in with the rest.
//  3. Each survivor's rank is the number of survivors ahead of it under
//     (key desc, position asc): k·k compares from shared memory, shared by
//     up to 32 neighbouring lanes a survivor, no barrier.
#pragma once

#include <stdint.h>

#define SELECT_FULL 0xFFFFFFFFu

// Order-preserving key of a float; -0.0 keys as +0.0.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Scratch of one select group, in shared memory. Survivors go to a separate
// uint2 (key, position) array of k entries.
template <int NT>
struct alignas(16) SelectScratch {
  unsigned hist[256];
  unsigned warp_eq[NT / 32];
  unsigned prefix;
  int need;
  int done;
  unsigned lo;        // the least and the greatest participating key of a pass
  unsigned hi;
  int n_greater;
  int n_equal;
};

// Where the radix passes stopped: the k-th key has the top `bits` bits
// `prefix`, `need` of the elements with that prefix are in the top k, and
// `done` when that is all of them.
struct RadixState {
  unsigned prefix;
  int bits;
  int need;
  bool done;
};

template <int NT>
__device__ __forceinline__ void group_sync() {
  if constexpr (NT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Step 1 over the keys key_at(j), j < n, at or above `floor_key`, until `done`
// or `max_bits` bits are fixed. Run by all NT threads of the group; t is the
// thread's index in it. Every loop runs the same number of times on every
// lane of a warp, as the full-mask warp intrinsics require. The fields of
// `sc` a pass writes after its first barrier are read only before its last.
template <int NT, class KeyAt>
__device__ RadixState radix_passes(KeyAt key_at, int n, int k, unsigned floor_key,
                                   int max_bits, int t, SelectScratch<NT>* sc) {
  const int lane = t & 31, warp = t >> 5;
  unsigned* h = sc->hist;
  RadixState st{0u, 0, k, false};
  while (!st.done && st.bits < max_bits) {
    const int shift = 24 - st.bits;
    for (int i = t; i < 256; i += NT) h[i] = 0u;
    if (t == 0) {
      sc->lo = 0xFFFFFFFFu;
      sc->hi = 0u;
    }
    group_sync<NT>();
    for (int b = 0; b < n; b += NT) {
      const int j = b + t;
      const unsigned key = j < n ? key_at(j) : 0u;
      const bool part = j < n && key >= floor_key &&
                        (st.bits == 0 || (key >> (32 - st.bits)) == st.prefix);
      const unsigned pm = __ballot_sync(SELECT_FULL, part);
      if (pm) {
        const unsigned digit = (key >> shift) & 0xFFu;
        const unsigned dlo = __reduce_min_sync(SELECT_FULL, part ? digit : 0x100u);
        const unsigned dhi = __reduce_max_sync(SELECT_FULL, part ? digit : 0u);
        const unsigned klo = __reduce_min_sync(SELECT_FULL, part ? key : 0xFFFFFFFFu);
        const unsigned khi = __reduce_max_sync(SELECT_FULL, part ? key : 0u);
        if (lane == __ffs(pm) - 1) {
          if (dlo == dhi) atomicAdd(&h[dlo], (unsigned)__popc(pm));
          atomicMin(&sc->lo, klo);
          atomicMax(&sc->hi, khi);
        }
        if (dlo != dhi && part) atomicAdd(&h[digit], 1u);
      }
    }
    group_sync<NT>();
    if (warp == 0) {
      // lane l holds digits 255 - 8l down to 248 - 8l; lanes scan from the top
      unsigned c[8], tot = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        c[m] = h[255 - 8 * lane - m];
        tot += c[m];
      }
      unsigned incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(SELECT_FULL, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned above = incl - tot;
      if (above < (unsigned)st.need && (unsigned)st.need <= incl) {
        int digit = -1;
        unsigned cnt = 0;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (digit < 0) {
            if (above + c[m] >= (unsigned)st.need) {
              digit = 255 - 8 * lane - m;
              cnt = c[m];
            } else {
              above += c[m];
            }
          }
        }
        const int need = st.need - (int)above;
        sc->need = need;
        if (sc->lo == sc->hi) {          // one key among all participants: the k-th
          sc->prefix = sc->lo;
          sc->done = 2 | (cnt == (unsigned)need);   // bit 1: the key is complete
        } else {
          sc->prefix = (st.prefix << 8) | (unsigned)digit;
          sc->done = cnt == (unsigned)need;
        }
      }
    }
    group_sync<NT>();
    st.prefix = sc->prefix;
    st.need = sc->need;
    st.done = (sc->done & 1) != 0;
    st.bits = (sc->done & 2) ? 32 : st.bits + 8;
  }
  return st;
}

// Step 3 on the k survivors (key, position) in surv, in any order: emit
// each with its rank under (key desc, position asc). P neighbouring lanes
// share a survivor's k compares.
template <int NT, class Emit>
__device__ void rank_emit(const uint2* surv, int k, int t, Emit emit) {
  const int lane = t & 31;
  int P = 1;
  while (P < 32 && 2 * P * k <= NT) P *= 2;
  const int part = lane % P;
  for (int i0 = 0; i0 < k * P; i0 += NT) {
    const int i = (i0 + t) / P;
    const uint2 me = surv[i < k ? i : 0];
    int r = 0;
    if (i < k) {
      for (int j = part; j < k; j += P) {
        const uint2 o = surv[j];
        r += (o.x > me.x) | ((o.x == me.x) & (o.y < me.y));
      }
    }
    for (int off = P / 2; off > 0; off >>= 1) r += __shfl_down_sync(SELECT_FULL, r, off, P);
    if (i < k && part == 0) emit(r, (int)me.y);
  }
  group_sync<NT>();
}

// One warp, k <= 32: the k-th largest of the lanes' maxima is a floor that
// k elements reach (a bitonic sort of the 32 maxima by shuffles); when at
// most 32 elements reach it, they are the candidates, ranked against each
// other by shuffles. Returns false, with the floor, when more reach it.
// buf holds 32 entries.
template <class KeyAt, class Emit>
__device__ bool warp_select_small(KeyAt key_at, int n, int k, int lane, uint2* buf,
                                  unsigned& floor_key, Emit emit) {
  const unsigned lt = (1u << lane) - 1u;
  unsigned v = 0;
  for (int j = lane; j < n; j += 32) v = max(v, key_at(j));
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned o = __shfl_xor_sync(SELECT_FULL, v, stride);
      const bool desc = (lane & size) == 0, lower = (lane & stride) == 0;
      v = lower == desc ? max(v, o) : min(v, o);
    }
  }
  floor_key = __shfl_sync(SELECT_FULL, v, k - 1);
  int c = 0;
  for (int b = 0; b < n; b += 32) {
    const int j = b + lane;
    const unsigned key = j < n ? key_at(j) : 0u;
    const bool cand = j < n && key >= floor_key;
    const unsigned m = __ballot_sync(SELECT_FULL, cand);
    const int at = c + __popc(m & lt);
    if (cand && at < 32) buf[at] = make_uint2(key, (unsigned)j);
    c += __popc(m);
  }
  if (c > 32) return false;
  __syncwarp();
  const uint2 me = lane < c ? buf[lane] : make_uint2(0u, 0u);
  int r = 0;
  for (int i = 0; i < c; ++i) {
    const unsigned ok = __shfl_sync(SELECT_FULL, me.x, i);
    const unsigned op = __shfl_sync(SELECT_FULL, me.y, i);
    r += (ok > me.x) | ((ok == me.x) & (op < me.y));
  }
  if (lane < c && r < k) emit(r, (int)me.y);
  __syncwarp();
  return true;
}

template <int NT, class KeyAt, class Emit>
__device__ void select_topk(KeyAt key_at, int n, int k, unsigned floor_key, int t,
                            SelectScratch<NT>* sc, uint2* surv, Emit emit) {
  const int lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if constexpr (NT == 32) {
    if (k <= 32) {
      unsigned fk;
      if (warp_select_small(key_at, n, k, lane, surv, fk, emit)) return;
      floor_key = max(floor_key, fk);
    }
  }
  const RadixState st = radix_passes<NT>(key_at, n, k, floor_key, 32, t, sc);
  const unsigned prefix = st.prefix;
  const int need = st.need;

  // 2. survivors: above the prefix, then `need` equal to it (and at or
  // above the floor, as every element the passes counted)
  const int sh = 32 - st.bits;
  const int n_greater = k - need;
  if (t == 0) {
    sc->n_greater = 0;
    sc->n_equal = 0;
  }
  group_sync<NT>();
  const int seg = (n + NT - 1) / NT * 32;         // a warp's contiguous segment
  const int lo = warp * seg, hi = min(n, lo + seg);
  unsigned n_eq = 0;
  for (int b = lo; b < lo + seg; b += 32) {
    const int j = b + lane;
    const bool in = j < hi;
    const unsigned key = in ? key_at(j) : 0u;
    const bool g = in && (key >> sh) > prefix;
    const bool e = in && key >= floor_key && (key >> sh) == prefix;
    const unsigned gm = __ballot_sync(SELECT_FULL, g), em = __ballot_sync(SELECT_FULL, e);
    if (gm) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&sc->n_greater, __popc(gm));
      base = __shfl_sync(SELECT_FULL, base, 0);
      if (g) surv[base + __popc(gm & lt)] = make_uint2(key, (unsigned)j);
    }
    if (st.done && em) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&sc->n_equal, __popc(em));
      base = __shfl_sync(SELECT_FULL, base, 0);
      if (e) surv[n_greater + base + __popc(em & lt)] = make_uint2(key, (unsigned)j);
    }
    n_eq += __popc(em);
  }
  if (!st.done) {                                  // ties on the whole key: lowest positions
    if (lane == 0) sc->warp_eq[warp] = n_eq;
    group_sync<NT>();
    unsigned before = 0;
    for (int w = 0; w < warp; ++w) before += sc->warp_eq[w];
    for (int b = lo; b < lo + seg && before < (unsigned)need; b += 32) {
      const int j = b + lane;
      const bool e = j < hi && key_at(j) == prefix;
      const unsigned em = __ballot_sync(SELECT_FULL, e);
      const unsigned r = before + __popc(em & lt);
      if (e && r < (unsigned)need) surv[n_greater + r] = make_uint2(prefix, (unsigned)j);
      before += __popc(em);
    }
  }
  group_sync<NT>();

  rank_emit<NT>(surv, k, t, emit);
}
